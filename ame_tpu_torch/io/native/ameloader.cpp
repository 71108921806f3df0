// ameloader — native async data loader for ame_tpu_torch fleet mastering
// (the port's own copy of ame_tpu's).
//
// The fleet runner's bottleneck is host IO/decode (parallel/fleet.py): the
// card's chain over a 3-minute track takes milliseconds while a WAV
// decode + conversion takes tens of ms on one core. This loader is the
// framework's native data-loader component: a C++ thread pool decodes
// upcoming tracks (WAV natively here, MP3/FLAC via the amecodec decoders in
// this same shared object) while the device masters the current one,
// exposing a blocking in-order handoff to Python over ctypes (which
// releases the GIL, so the workers genuinely overlap device work and
// Python).
//
// Exposed C ABI (consumed by ame_tpu_torch/io/loader.py):
//   void* ame_loader_open(const char** paths, int n, int workers)
//   int   ame_loader_next(void* h, int index, float** out, long* n_frames,
//                         int* channels, int* rate, char* err, int errlen)
//         -> 0 ok (caller frees *out with ame_free), <0 error for that
//            file (err holds a message; the Python side falls back to its
//            own decoders, e.g. for AIFF)
//   void  ame_loader_close(void* h)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" int ame_mp3_decode(const char* path, float** out, long* n_frames,
                              int* channels, int* rate);
extern "C" int ame_flac_decode(const char* path, float** out, long* n_frames,
                               int* channels, int* rate);
extern "C" int ame_have_mpg123();
extern "C" void ame_free(void* p);

namespace {

struct Item {
  float* data = nullptr;
  long n_frames = 0;
  int channels = 0;
  int rate = 0;
  int err = 0;
  char msg[200] = {0};
  bool ready = false;
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<Item> items;
  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<size_t> next_job{0};
};

// ------------------------------------------------------------------ WAV ----
// RIFF/WAVE parser matching ame_tpu_torch/io/wav.py semantics: PCM
// 8/16/24/32 and IEEE float32/64 (incl. WAVE_FORMAT_EXTENSIBLE), decode to
// interleaved float32 with the same scaling conventions (int / 2^(bits-1);
// 8-bit unsigned offset; 32-bit int via double for exactness).

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

int decode_wav(const char* path, Item& it) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    std::snprintf(it.msg, sizeof(it.msg), "cannot open file");
    return -1;
  }
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz < 12) {
    std::fclose(f);
    std::snprintf(it.msg, sizeof(it.msg), "file too short");
    return -1;
  }
  std::vector<uint8_t> buf((size_t)sz);
  if (std::fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz) {
    std::fclose(f);
    std::snprintf(it.msg, sizeof(it.msg), "short read");
    return -1;
  }
  std::fclose(f);
  if (std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0) {
    std::snprintf(it.msg, sizeof(it.msg), "not a RIFF/WAVE file");
    return -2;
  }
  size_t pos = 12;
  int tag = -1, channels = 0, rate = 0, bits = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
  while (pos + 8 <= buf.size()) {
    const uint8_t* cid = buf.data() + pos;
    uint32_t csz = rd_u32(buf.data() + pos + 4);
    size_t body = pos + 8;
    if (body + csz > buf.size()) csz = (uint32_t)(buf.size() - body);
    if (std::memcmp(cid, "fmt ", 4) == 0 && csz >= 16) {
      tag = rd_u16(buf.data() + body);
      channels = rd_u16(buf.data() + body + 2);
      rate = (int)rd_u32(buf.data() + body + 4);
      bits = rd_u16(buf.data() + body + 14);
      if (tag == 0xFFFE && csz >= 40) tag = rd_u16(buf.data() + body + 24);
    } else if (std::memcmp(cid, "data", 4) == 0) {
      data = buf.data() + body;
      data_len = csz;
    }
    pos = body + csz + (csz & 1);
  }
  if (tag < 0 || !data || channels <= 0 || rate <= 0) {
    std::snprintf(it.msg, sizeof(it.msg), "missing fmt/data chunk");
    return -2;
  }
  size_t nvals;
  if (tag == 3) {  // IEEE float
    if (bits != 32 && bits != 64) {
      std::snprintf(it.msg, sizeof(it.msg), "float%d unsupported", bits);
      return -2;
    }
    nvals = data_len / (bits / 8);
  } else if (tag == 1) {
    if (bits != 8 && bits != 16 && bits != 24 && bits != 32) {
      std::snprintf(it.msg, sizeof(it.msg), "pcm%d unsupported", bits);
      return -2;
    }
    nvals = data_len / (bits / 8);
  } else {
    std::snprintf(it.msg, sizeof(it.msg), "format tag %d unsupported", tag);
    return -2;
  }
  size_t frames = nvals / (size_t)channels;
  nvals = frames * (size_t)channels;
  float* out = (float*)std::malloc(nvals * sizeof(float));
  if (!out && nvals) {
    std::snprintf(it.msg, sizeof(it.msg), "alloc failed");
    return -6;
  }
  if (tag == 3 && bits == 32) {
    std::memcpy(out, data, nvals * sizeof(float));
  } else if (tag == 3) {  // float64
    for (size_t i = 0; i < nvals; ++i) {
      double d;
      std::memcpy(&d, data + i * 8, 8);
      out[i] = (float)d;
    }
  } else if (bits == 8) {  // unsigned
    for (size_t i = 0; i < nvals; ++i)
      out[i] = ((float)data[i] - 128.0f) / 128.0f;
  } else if (bits == 16) {
    for (size_t i = 0; i < nvals; ++i) {
      int16_t v = (int16_t)rd_u16(data + i * 2);
      out[i] = (float)v / 32768.0f;
    }
  } else if (bits == 24) {
    for (size_t i = 0; i < nvals; ++i) {
      const uint8_t* p = data + i * 3;
      int32_t v = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                            ((uint32_t)p[2] << 16));
      v = (v << 8) >> 8;  // sign-extend
      out[i] = (float)v / 8388608.0f;
    }
  } else {  // 32-bit int
    for (size_t i = 0; i < nvals; ++i) {
      int32_t v = (int32_t)rd_u32(data + i * 4);
      out[i] = (float)((double)v / 2147483648.0);
    }
  }
  it.data = out;
  it.n_frames = (long)frames;
  it.channels = channels;
  it.rate = rate;
  return 0;
}

bool ends_with(const std::string& s, const char* suf) {
  size_t n = std::strlen(suf);
  if (s.size() < n) return false;
  for (size_t i = 0; i < n; ++i) {
    char a = s[s.size() - n + i];
    if (a >= 'A' && a <= 'Z') a += 32;
    if (a != suf[i]) return false;
  }
  return true;
}

void decode_one(const std::string& path, Item& it) {
  try {
    if (ends_with(path, ".wav") || ends_with(path, ".wave")) {
      it.err = decode_wav(path.c_str(), it);
    } else if (ends_with(path, ".flac")) {
      it.err = ame_flac_decode(path.c_str(), &it.data, &it.n_frames,
                               &it.channels, &it.rate);
      if (it.err) std::snprintf(it.msg, sizeof(it.msg), "flac decode error");
    } else if (ends_with(path, ".mp3") && ame_have_mpg123()) {
      it.err = ame_mp3_decode(path.c_str(), &it.data, &it.n_frames,
                              &it.channels, &it.rate);
      if (it.err) std::snprintf(it.msg, sizeof(it.msg), "mp3 decode error");
    } else {
      it.err = -2;
      std::snprintf(it.msg, sizeof(it.msg), "format not native-decodable");
    }
  } catch (...) {
    it.err = -7;
    std::snprintf(it.msg, sizeof(it.msg), "decoder exception");
  }
}

void worker(Loader* L) {
  for (;;) {
    size_t i = L->next_job.fetch_add(1);
    if (i >= L->paths.size()) return;
    Item it;
    decode_one(L->paths[i], it);
    {
      std::lock_guard<std::mutex> lk(L->mu);
      it.ready = true;
      L->items[i] = it;
    }
    L->cv.notify_all();
  }
}

}  // namespace

extern "C" {

void* ame_loader_open(const char** paths, int n, int workers) {
  if (n <= 0) return nullptr;
  Loader* L = new Loader();
  L->paths.reserve((size_t)n);
  for (int i = 0; i < n; ++i) L->paths.emplace_back(paths[i]);
  L->items.resize((size_t)n);
  if (workers < 1) workers = 1;
  if (workers > n) workers = n;
  for (int w = 0; w < workers; ++w)
    L->threads.emplace_back(worker, L);
  return L;
}

int ame_loader_next(void* h, int index, float** out, long* n_frames,
                    int* channels, int* rate, char* err, int errlen) {
  Loader* L = (Loader*)h;
  if (!L || index < 0 || (size_t)index >= L->items.size()) return -100;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv.wait(lk, [&] { return L->items[(size_t)index].ready; });
  Item& it = L->items[(size_t)index];
  if (it.err) {
    if (err && errlen > 0) {
      std::snprintf(err, (size_t)errlen, "%s", it.msg);
    }
    return it.err;
  }
  *out = it.data;
  *n_frames = it.n_frames;
  *channels = it.channels;
  *rate = it.rate;
  it.data = nullptr;  // ownership to caller (ame_free)
  return 0;
}

void ame_loader_close(void* h) {
  Loader* L = (Loader*)h;
  if (!L) return;
  // drain the job counter so workers exit, then reap
  L->next_job.store(L->paths.size());
  for (auto& t : L->threads) t.join();
  for (auto& it : L->items)
    if (it.data) std::free(it.data);
  delete L;
}

}  // extern "C"
