// amecodec — native codec edge for ame_tpu_torch (a copy of ame_tpu's).
//
// Replaces the reference's ffmpeg-subprocess MP3 encode (libmp3lame via
// `ffmpeg -q:a 0`, audio_mastering_engine.py:147-148, N5) and MP3 decode
// (N1) with an in-process C++ shim. System libraries are resolved with
// dlopen at runtime (no -dev headers in the image); prototypes are declared
// locally against the stable public ABIs of LAME and mpg123.
//
// Exposed C ABI (consumed by ame_tpu_torch/io/codecs.py over ctypes):
//   int  ame_mp3_encode(path, interleaved_f32, n_frames, channels, rate, vbr_q)
//   int  ame_mp3_decode(path, &out_f32, &n_frames, &channels, &rate)
//   void ame_free(ptr)
//   int  ame_have_lame(); int ame_have_mpg123();
// Return codes: 0 ok, negative = error family.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <vector>
#include <dlfcn.h>

namespace {

// ---------------------------------------------------------------- LAME ----
struct LameApi {
  void* (*init)();
  int (*set_num_channels)(void*, int);
  int (*set_in_samplerate)(void*, int);
  int (*set_brate)(void*, int);
  int (*set_quality)(void*, int);
  int (*set_VBR)(void*, int);       // 4 = vbr_mtrh (a.k.a. vbr_default)
  int (*set_VBR_q)(void*, int);     // 0 = V0
  int (*init_params)(void*);
  int (*encode_buffer_interleaved)(void*, short*, int, unsigned char*, int);
  int (*encode_flush)(void*, unsigned char*, int);
  int (*close)(void*);
  bool ok = false;
};

LameApi& lame() {
  static LameApi api = [] {
    LameApi a{};
    void* h = dlopen("libmp3lame.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libmp3lame.so", RTLD_NOW | RTLD_GLOBAL);
    if (!h) return a;
    auto sym = [&](const char* n) { return dlsym(h, n); };
    a.init = (void* (*)())sym("lame_init");
    a.set_num_channels = (int (*)(void*, int))sym("lame_set_num_channels");
    a.set_in_samplerate = (int (*)(void*, int))sym("lame_set_in_samplerate");
    a.set_brate = (int (*)(void*, int))sym("lame_set_brate");
    a.set_quality = (int (*)(void*, int))sym("lame_set_quality");
    a.set_VBR = (int (*)(void*, int))sym("lame_set_VBR");
    a.set_VBR_q = (int (*)(void*, int))sym("lame_set_VBR_q");
    a.init_params = (int (*)(void*))sym("lame_init_params");
    a.encode_buffer_interleaved =
        (int (*)(void*, short*, int, unsigned char*, int))
            sym("lame_encode_buffer_interleaved");
    a.encode_flush = (int (*)(void*, unsigned char*, int))
        sym("lame_encode_flush");
    a.close = (int (*)(void*))sym("lame_close");
    a.ok = a.init && a.set_num_channels && a.set_in_samplerate && a.set_VBR &&
           a.set_VBR_q && a.init_params && a.encode_buffer_interleaved &&
           a.encode_flush && a.close;
    return a;
  }();
  return api;
}

// -------------------------------------------------------------- mpg123 ----
constexpr int kMpg123Ok = 0;
constexpr int kMpg123Done = -12;
constexpr int kEncSigned16 = 0xD0;  // MPG123_ENC_SIGNED_16 (always supported)

struct MpgApi {
  int (*init)();
  void* (*newh)(const char*, int*);
  int (*open)(void*, const char*);
  int (*getformat)(void*, long*, int*, int*);
  int (*format_none)(void*);
  int (*format)(void*, long, int, int);
  int (*read)(void*, unsigned char*, size_t, size_t*);
  int (*close)(void*);
  void (*del)(void*);
  bool ok = false;
};

MpgApi& mpg() {
  static MpgApi api = [] {
    MpgApi a{};
    void* h = dlopen("libmpg123.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libmpg123.so", RTLD_NOW | RTLD_GLOBAL);
    if (!h) return a;
    auto sym = [&](const char* n) { return dlsym(h, n); };
    a.init = (int (*)())sym("mpg123_init");
    a.newh = (void* (*)(const char*, int*))sym("mpg123_new");
    a.open = (int (*)(void*, const char*))sym("mpg123_open");
    a.getformat = (int (*)(void*, long*, int*, int*))sym("mpg123_getformat");
    a.format_none = (int (*)(void*))sym("mpg123_format_none");
    a.format = (int (*)(void*, long, int, int))sym("mpg123_format");
    a.read = (int (*)(void*, unsigned char*, size_t, size_t*))
        sym("mpg123_read");
    a.close = (int (*)(void*))sym("mpg123_close");
    a.del = (void (*)(void*))sym("mpg123_delete");
    a.ok = a.init && a.newh && a.open && a.getformat && a.format_none &&
           a.format && a.read && a.close && a.del;
    if (a.ok) a.init();
    return a;
  }();
  return api;
}

}  // namespace

extern "C" {

int ame_have_lame() { return lame().ok ? 1 : 0; }
int ame_have_mpg123() { return mpg().ok ? 1 : 0; }

void ame_free(void* p) { std::free(p); }

// interleaved: n_frames * channels float32 in [-1, 1]
int ame_mp3_encode(const char* path, const float* interleaved,
                   long n_frames, int channels, int rate, int vbr_q) {
  LameApi& L = lame();
  if (!L.ok) return -1;
  if (channels < 1 || channels > 2) return -2;
  void* gf = L.init();
  if (!gf) return -3;
  L.set_num_channels(gf, channels);
  L.set_in_samplerate(gf, rate);
  L.set_VBR(gf, 4);  // vbr_mtrh == vbr_default
  L.set_VBR_q(gf, vbr_q);
  if (L.set_quality) L.set_quality(gf, 2);
  if (L.init_params(gf) < 0) {
    L.close(gf);
    return -4;
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) {
    L.close(gf);
    return -5;
  }
  const long kChunk = 65536;
  std::vector<short> pcm(kChunk * 2);
  std::vector<unsigned char> out(static_cast<size_t>(1.25 * kChunk) + 7200);
  int rc = 0;
  for (long off = 0; off < n_frames; off += kChunk) {
    long n = n_frames - off < kChunk ? n_frames - off : kChunk;
    for (long i = 0; i < n; ++i) {
      for (int c = 0; c < 2; ++c) {
        float v = interleaved[(off + i) * channels + (c < channels ? c : 0)];
        v = v > 1.f ? 1.f : (v < -1.f ? -1.f : v);
        pcm[i * 2 + c] = static_cast<short>(v * 32767.f);
      }
    }
    // LAME's interleaved entry point expects stereo interleaved frames.
    int nb = L.encode_buffer_interleaved(gf, pcm.data(), static_cast<int>(n),
                                         out.data(),
                                         static_cast<int>(out.size()));
    if (nb < 0) {
      rc = -6;
      break;
    }
    if (nb > 0) std::fwrite(out.data(), 1, nb, f);
  }
  if (rc == 0) {
    int nb = L.encode_flush(gf, out.data(), static_cast<int>(out.size()));
    if (nb > 0) std::fwrite(out.data(), 1, nb, f);
  }
  std::fclose(f);
  L.close(gf);
  return rc;
}

int ame_mp3_decode(const char* path, float** out, long* n_frames,
                   int* channels, int* rate) {
  MpgApi& M = mpg();
  if (!M.ok) return -1;
  int err = 0;
  void* h = M.newh(nullptr, &err);
  if (!h) return -3;
  if (M.open(h, path) != kMpg123Ok) {
    M.del(h);
    return -5;
  }
  long r = 0;
  int ch = 0, enc = 0;
  if (M.getformat(h, &r, &ch, &enc) != kMpg123Ok) {
    M.close(h);
    M.del(h);
    return -6;
  }
  // Force signed-16 output (the one encoding every mpg123 build provides)
  // and widen to float here; requesting float output is not honored by all
  // builds once decoding has started.
  M.format_none(h);
  M.format(h, r, ch, kEncSigned16);
  std::vector<float> buf;
  std::vector<unsigned char> chunk(1 << 18);
  while (true) {
    size_t done = 0;
    int rc = M.read(h, chunk.data(), chunk.size(), &done);
    if (done > 0) {
      const int16_t* p = reinterpret_cast<const int16_t*>(chunk.data());
      size_t cnt = done / sizeof(int16_t);
      size_t base = buf.size();
      buf.resize(base + cnt);
      for (size_t i = 0; i < cnt; ++i)
        buf[base + i] = static_cast<float>(p[i]) * (1.0f / 32768.0f);
    }
    if (rc == kMpg123Done) break;
    if (rc != kMpg123Ok && rc != -11 /*NEW_FORMAT*/) {
      if (done == 0) break;
    }
  }
  M.close(h);
  M.del(h);
  if (buf.empty()) return -7;
  float* mem = static_cast<float*>(std::malloc(buf.size() * sizeof(float)));
  if (!mem) return -8;
  std::memcpy(mem, buf.data(), buf.size() * sizeof(float));
  *out = mem;
  *n_frames = static_cast<long>(buf.size() / ch);
  *channels = ch;
  *rate = static_cast<int>(r);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FLAC decoder (native, self-contained — no libFLAC in the image).
// Implements the FLAC bitstream per the public format spec: STREAMINFO,
// frame headers, constant/verbatim/fixed/LPC subframes, Rice-coded
// residuals, stereo decorrelation. Covers the reference's FLAC *input*
// capability (mastering_gui.py:170 file filter; decode reached ffmpeg, N1).
// ---------------------------------------------------------------------------

namespace flacdec {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  uint64_t cache = 0;
  int cache_bits = 0;
  bool error = false;

  explicit BitReader(const uint8_t* d, size_t s) : data(d), size(s) {}

  void fill() {
    while (cache_bits <= 56 && byte_pos < size) {
      cache = (cache << 8) | data[byte_pos++];
      cache_bits += 8;
    }
  }
  uint32_t bits(int n) {  // n <= 32
    if (n == 0) return 0;
    fill();
    if (cache_bits < n) {
      error = true;
      return 0;
    }
    uint32_t v = static_cast<uint32_t>(
        (cache >> (cache_bits - n)) & ((n == 64 ? ~0ULL : ((1ULL << n) - 1))));
    cache_bits -= n;
    return v;
  }
  int64_t sbits(int n) {  // sign-extended
    if (n == 0) return 0;
    uint64_t v;
    if (n <= 32) {
      v = bits(n);
    } else {
      uint64_t hi = bits(n - 32);
      uint64_t lo = bits(32);
      v = (hi << 32) | lo;
    }
    if (v & (1ULL << (n - 1))) return static_cast<int64_t>(v) - (1LL << n);
    return static_cast<int64_t>(v);
  }
  uint32_t unary() {
    uint32_t q = 0;
    while (!error) {
      fill();
      if (cache_bits == 0) {
        error = true;
        break;
      }
      // scan cached bits for the terminating 1
      while (cache_bits > 0) {
        uint64_t bit = (cache >> (cache_bits - 1)) & 1;
        cache_bits--;
        if (bit) return q;
        q++;
      }
    }
    return q;
  }
  void align() { cache_bits -= cache_bits % 8; }
  bool at_end() {
    fill();
    return cache_bits == 0 && byte_pos >= size;
  }
};

uint64_t read_utf8(BitReader& br) {
  uint32_t b0 = br.bits(8);
  if (!(b0 & 0x80)) return b0;
  int n = 0;
  for (uint32_t m = 0x40; b0 & m; m >>= 1) n++;
  uint64_t v = b0 & (0x3F >> n);
  for (int i = 0; i < n; ++i) v = (v << 6) | (br.bits(8) & 0x3F);
  return v;
}

const int kFixedCoefs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool decode_residual(BitReader& br, int blocksize, int order,
                     std::vector<int64_t>& res) {
  uint32_t method = br.bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t porder = br.bits(4);
  uint32_t nparts = 1u << porder;
  if (blocksize % nparts != 0) return false;
  res.resize(blocksize - order);
  size_t idx = 0;
  for (uint32_t p = 0; p < nparts; ++p) {
    int count = blocksize >> porder;
    if (p == 0) count -= order;
    if (count < 0) return false;
    uint32_t param = br.bits(plen);
    if (param == escape) {
      int raw = br.bits(5);
      for (int i = 0; i < count; ++i) res[idx++] = raw ? br.sbits(raw) : 0;
    } else {
      for (int i = 0; i < count; ++i) {
        uint64_t q = br.unary();
        uint64_t r = param ? br.bits(param) : 0;
        uint64_t u = (q << param) | r;
        res[idx++] = (u & 1) ? -static_cast<int64_t>(u >> 1) - 1
                             : static_cast<int64_t>(u >> 1);
      }
    }
    if (br.error) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& out) {
  if (br.bits(1) != 0) return false;  // padding bit
  uint32_t type = br.bits(6);
  int wasted = 0;
  if (br.bits(1)) {
    wasted = 1;
    while (br.bits(1) == 0 && !br.error) wasted++;
  }
  bps -= wasted;
  // A hostile wasted-bits run can exhaust (or exceed) the sample size;
  // bits()/sbits() with n <= 0 or n > 33 is undefined, so reject here.
  if (bps < 1 || bps > 33) return false;
  out.assign(blocksize, 0);
  if (type == 0) {  // CONSTANT
    int64_t v = br.sbits(bps);
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) out[i] = br.sbits(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED
    int order = type - 8;
    // The predictor order must leave room for at least one residual sample
    // (order >= blocksize would write warm-up past `out` and make
    // decode_residual size the residual vector with a negative count).
    if (order >= blocksize) return false;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    std::vector<int64_t> res;
    if (!decode_residual(br, blocksize, order, res)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j)
        pred += kFixedCoefs[order][j] * out[i - 1 - j];
      out[i] = res[i - order] + pred;
    }
  } else if (type >= 32) {  // LPC
    int order = (type & 31) + 1;
    if (order >= blocksize) return false;  // same bound as FIXED above
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    int prec = br.bits(4) + 1;
    if (prec == 16) return false;  // 1111 invalid
    int shift = static_cast<int>(br.sbits(5));
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.sbits(prec);
    std::vector<int64_t> res;
    if (!decode_residual(br, blocksize, order, res)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coef[j] * out[i - 1 - j];
      out[i] = res[i - order] + (pred >> shift);
    }
  } else {
    return false;  // reserved
  }
  if (wasted)
    for (auto& v : out) v <<= wasted;
  return !br.error;
}

}  // namespace flacdec

static int ame_flac_decode_impl(const char* path, float** out,
                                long* n_frames, int* channels, int* rate) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(fsize);
  if (std::fread(data.data(), 1, fsize, f) != static_cast<size_t>(fsize)) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  if (fsize < 8 || std::memcmp(data.data(), "fLaC", 4) != 0) return -3;

  using flacdec::BitReader;
  BitReader br(data.data() + 4, fsize - 4);
  // metadata blocks
  int si_rate = 0, si_channels = 0, si_bps = 0;
  uint64_t si_total = 0;
  bool have_si = false;
  while (!br.error) {
    uint32_t last = br.bits(1);
    uint32_t type = br.bits(7);
    uint32_t len = br.bits(24);
    if (type == 0) {  // STREAMINFO
      br.bits(16);  // min blocksize
      br.bits(16);  // max blocksize
      br.bits(24);  // min framesize
      br.bits(24);  // max framesize
      si_rate = br.bits(20);
      si_channels = br.bits(3) + 1;
      si_bps = br.bits(5) + 1;
      uint64_t hi = br.bits(4);
      uint64_t lo = br.bits(32);
      si_total = (hi << 32) | lo;
      for (int i = 0; i < 16; ++i) br.bits(8);  // md5
      have_si = true;
    } else {
      for (uint32_t i = 0; i < len; ++i) br.bits(8);
    }
    if (last) break;
  }
  if (!have_si || br.error || si_channels < 1 || si_channels > 8) return -4;

  std::vector<std::vector<float>> pcm(si_channels);
  // si_total is an untrusted 36-bit field: cap the reserve hint (a
  // corrupted value of ~2^36 raised std::bad_alloc and aborted the
  // process — found by tests/test_flac.py fuzzing). The vectors still
  // grow as needed if the hint undershoots.
  uint64_t reserve_cap =
      std::min<uint64_t>(si_total, static_cast<uint64_t>(fsize) * 8);
  if (reserve_cap)
    for (auto& v : pcm) v.reserve(reserve_cap);

  static const int kBlockSizes[16] = {0,   192, 576,  1152, 2304, 4608, -1,
                                      -2,  256, 512,  1024, 2048, 4096, 8192,
                                      16384, 32768};
  static const int kSampleSizes[8] = {0, 8, 12, 0, 16, 20, 24, 32};

  std::vector<std::vector<int64_t>> ch(si_channels);
  while (!br.error && !br.at_end()) {
    br.align();
    // resync: find frame sync word
    uint32_t sync = br.bits(14);
    if (br.error || br.at_end()) break;
    if (sync != 0x3FFE) continue;
    br.bits(1);                      // reserved
    br.bits(1);                      // blocking strategy
    uint32_t bs_code = br.bits(4);
    uint32_t sr_code = br.bits(4);
    uint32_t ch_asgn = br.bits(4);
    uint32_t ss_code = br.bits(3);
    br.bits(1);  // reserved
    flacdec::read_utf8(br);
    int blocksize = kBlockSizes[bs_code];
    if (blocksize == -1) blocksize = br.bits(8) + 1;
    else if (blocksize == -2) blocksize = br.bits(16) + 1;
    else if (blocksize == 0) continue;
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    int bps = ss_code < 8 ? kSampleSizes[ss_code] : 0;
    if (bps == 0) bps = si_bps;
    br.bits(8);  // header CRC-8

    int nch = si_channels;
    bool left_side = false, right_side = false, mid_side = false;
    if (ch_asgn <= 7) {
      nch = ch_asgn + 1;
      if (nch != si_channels) continue;  // corrupt header
    } else if (ch_asgn >= 8 && ch_asgn <= 10) {
      // Stereo decorrelation modes are only valid for 2-channel streams;
      // accepting them against a mono STREAMINFO would write through the
      // nonexistent ch[1]/pcm[1]. Treat as a corrupt header, like the
      // independent-channel mismatch above.
      if (si_channels != 2) continue;
      left_side = ch_asgn == 8;
      right_side = ch_asgn == 9;
      mid_side = ch_asgn == 10;
      nch = 2;
    } else {
      continue;
    }

    bool ok = true;
    for (int c = 0; c < nch; ++c) {
      int b = bps;
      if ((left_side && c == 1) || (right_side && c == 0) ||
          (mid_side && c == 1))
        b += 1;  // side channel carries one extra bit
      if (!flacdec::decode_subframe(br, blocksize, b, ch[c])) {
        ok = false;
        break;
      }
    }
    if (!ok || br.error) break;
    br.align();
    br.bits(16);  // frame CRC-16

    // undo stereo decorrelation
    if (left_side) {
      for (int i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (right_side) {
      for (int i = 0; i < blocksize; ++i) ch[0][i] = ch[0][i] + ch[1][i];
    } else if (mid_side) {
      for (int i = 0; i < blocksize; ++i) {
        int64_t mid = ch[0][i];
        int64_t side = ch[1][i];
        mid = (mid << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }
    float scale = 1.0f / static_cast<float>(1LL << (bps - 1));
    for (int c = 0; c < nch; ++c)
      for (int i = 0; i < blocksize; ++i)
        pcm[c].push_back(static_cast<float>(ch[c][i]) * scale);
    if (si_total && pcm[0].size() >= si_total) break;
  }

  size_t frames = pcm[0].size();
  if (si_total && frames > si_total) frames = si_total;
  if (frames == 0) return -5;
  float* mem = static_cast<float*>(
      std::malloc(frames * si_channels * sizeof(float)));
  if (!mem) return -6;
  for (size_t i = 0; i < frames; ++i)
    for (int c = 0; c < si_channels; ++c)
      mem[i * si_channels + c] = pcm[c][i];
  *out = mem;
  *n_frames = static_cast<long>(frames);
  *channels = si_channels;
  *rate = si_rate;
  return 0;
}

extern "C" int ame_flac_decode(const char* path, float** out, long* n_frames,
                               int* channels, int* rate) {
  // Exception barrier: this decoder runs in-process on untrusted uploads
  // (serve tier); a C++ exception escaping the C boundary would abort
  // the host. Allocation failures from corrupted size fields become a
  // clean error return instead.
  try {
    return ame_flac_decode_impl(path, out, n_frames, channels, rate);
  } catch (...) {
    return -7;
  }
}
