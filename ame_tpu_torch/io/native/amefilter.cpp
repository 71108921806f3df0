// amefilter — drive REAL FFmpeg audio filters (loudnorm, alimiter,
// ebur128, ...) in-process, for golden-fixture validation of
// ame_tpu_torch's device-side transcriptions of them (the port's own copy
// of ame_tpu's shim).
//
// The reference's normalization/limit edge shells out to the ffmpeg CLI
// (audio_mastering_engine.py:223, 229-241). This environment has no ffmpeg
// binary and no libavfilter dev package, but a complete FFmpeg 8 stack
// (libavfilter 11 + matching avutil/avcodec/swresample) ships inside the
// opencv-python wheel. This shim dlopens that stack and exposes ONE call:
// "run this filter-graph description over these float32 samples and give
// me the output plus the filter log" — which is exactly what the parity
// tests need to diff the port's loudnorm/alimiter against the genuine
// article (the loudnorm JSON stats block arrives via the log callback,
// the same channel the reference scrapes from ffmpeg stderr).
//
// No FFmpeg headers exist for that stack here, so the needed prototypes
// and the two struct layouts we must touch (AVFrame, AVChannelLayout,
// AVFilterInOut — transcribed from the public FFmpeg 8 libavutil/frame.h,
// channel_layout.h, libavfilter/avfilter.h) are declared locally. The
// layout is VALIDATED at runtime before the shim reports available:
// ame_flt_selfcheck() pushes a pseudorandom ramp through "anull" (must
// round-trip bit-exactly, pinning data/extended_data/nb_samples/format/
// ch_layout offsets on both the write and read side) and through
// "aresample=48000" (must change the reported rate, pinning sample_rate).
// A wrong layout fails these checks (or av_buffersrc rejects the frame)
// and the Python wrapper degrades to "unavailable" — tests skip rather
// than trust garbage.
//
// Exposed C ABI (consumed by ame_tpu_torch/io/avfilter.py over ctypes):
//   int  ame_flt_init(const char* libavfilter_path);       // 0 = ok
//   int  ame_flt_selfcheck();                              // 1 = trusted
//   long long ame_flt_run(desc, in, n_frames, ch, rate,
//                         &out, &out_ch, &out_rate, &log); // >=0 = frames
//   void ame_flt_free(void* p);
//   const char* ame_flt_error();

#include <dlfcn.h>

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Transcribed public FFmpeg 8 ABI (libavutil 60 / libavfilter 11)
// ---------------------------------------------------------------------------

struct AVRational { int num, den; };

struct AVChannelLayout {        // libavutil/channel_layout.h (stable >= 57)
  int order;                    // enum AVChannelOrder
  int nb_channels;
  union { uint64_t mask; void* map; } u;
  void* opaque;
};

// libavutil/frame.h after the major-7 deprecation removals (key_frame,
// interlaced_frame, top_field_first, palette_has_changed, reordered_opaque,
// pkt_{pos,size}, channels, channel_layout all gone). Only the fields this
// shim reads/writes matter; the rest are offset padding.
struct AVFrame8 {
  uint8_t* data[8];
  int linesize[8];
  uint8_t** extended_data;
  int width, height;
  int nb_samples;
  int format;
  int pict_type;
  AVRational sample_aspect_ratio;
  int64_t pts;
  int64_t pkt_dts;
  AVRational time_base;
  int quality;
  void* opaque;
  int repeat_pict;
  int sample_rate;
  void* buf[8];
  void** extended_buf;
  int nb_extended_buf;
  void** side_data;
  int nb_side_data;
  int flags;
  int color_range, color_primaries, color_trc, colorspace, chroma_location;
  int64_t best_effort_timestamp;
  void* metadata;
  int decode_error_flags;
  void* hw_frames_ctx;
  void* opaque_ref;
  size_t crop_top, crop_bottom, crop_left, crop_right;
  void* private_ref;
  AVChannelLayout ch_layout;
  int64_t duration;
};

struct AVFilterInOut {          // libavfilter/avfilter.h (stable)
  char* name;
  void* filter_ctx;
  int pad_idx;
  AVFilterInOut* next;
};

// AVSampleFormat values (stable public enum)
enum { FMT_S16 = 1, FMT_S32 = 2, FMT_FLT = 3, FMT_DBL = 4,
       FMT_S16P = 6, FMT_S32P = 7, FMT_FLTP = 8, FMT_DBLP = 9 };

const int kAvErrEof = -(int)(('E') | ('O' << 8) | ('F' << 16) | (' ' << 24));
const int kAvErrEagain = -11;   // Linux

// ---------------------------------------------------------------------------
// dlsym table
// ---------------------------------------------------------------------------

struct Api {
  void* h = nullptr;
  unsigned (*avfilter_version)();
  void* (*avfilter_graph_alloc)();
  void (*avfilter_graph_free)(void**);
  const void* (*avfilter_get_by_name)(const char*);
  int (*avfilter_graph_create_filter)(void**, const void*, const char*,
                                      const char*, void*, void*);
  AVFilterInOut* (*avfilter_inout_alloc)();
  void (*avfilter_inout_free)(AVFilterInOut**);
  int (*avfilter_graph_parse_ptr)(void*, const char*, AVFilterInOut**,
                                  AVFilterInOut**, void*);
  int (*avfilter_graph_config)(void*, void*);
  int (*av_buffersrc_add_frame)(void*, AVFrame8*);
  int (*av_buffersink_get_frame)(void*, AVFrame8*);
  AVFrame8* (*av_frame_alloc)();
  void (*av_frame_free)(AVFrame8**);
  void (*av_frame_unref)(AVFrame8*);
  int (*av_frame_get_buffer)(AVFrame8*, int);
  void (*av_channel_layout_default)(AVChannelLayout*, int);
  int (*av_strerror)(int, char*, size_t);
  char* (*av_strdup)(const char*);
  void (*av_log_set_callback)(void (*)(void*, int, const char*, va_list));
  void (*av_log_default_callback)(void*, int, const char*, va_list);
  void (*av_log_set_level)(int);
};

Api A;
bool g_inited = false;
bool g_checked = false;
char g_err[768] = "";

void set_err(const char* where, int averr) {
  char buf[256] = "";
  if (averr < 0 && A.av_strerror) A.av_strerror(averr, buf, sizeof(buf));
  snprintf(g_err, sizeof(g_err), "%s%s%s (%d)", where,
           buf[0] ? ": " : "", buf, averr);
}

// Captured filter log (loudnorm prints its stats JSON here at graph free).
std::string g_log;

void log_cb(void* avcl, int level, const char* fmt, va_list vl) {
  (void)avcl;
  if (level > 32) return;  // AV_LOG_INFO
  char buf[2048];
  vsnprintf(buf, sizeof(buf), fmt, vl);
  if (g_log.size() < (1u << 20)) g_log += buf;
}

template <typename T>
bool sym(T& fn, const char* name) {
  fn = (T)dlsym(A.h, name);
  if (!fn) snprintf(g_err, sizeof(g_err), "dlsym %s failed", name);
  return fn != nullptr;
}

// ---------------------------------------------------------------------------
// Graph runner
// ---------------------------------------------------------------------------

struct Graph {
  void* g = nullptr;
  void* src = nullptr;
  void* sink = nullptr;
  ~Graph() { if (g) A.avfilter_graph_free(&g); }
};

int build_graph(Graph& gr, const char* desc, int ch, int rate) {
  gr.g = A.avfilter_graph_alloc();
  if (!gr.g) { set_err("graph_alloc", 0); return -1; }
  char args[256];
  snprintf(args, sizeof(args),
           "sample_rate=%d:sample_fmt=flt:channel_layout=%s:time_base=1/%d",
           rate, ch == 1 ? "mono" : "stereo", rate);
  int rc = A.avfilter_graph_create_filter(
      &gr.src, A.avfilter_get_by_name("abuffer"), "in", args, nullptr, gr.g);
  if (rc < 0) { set_err("create abuffer", rc); return -1; }
  rc = A.avfilter_graph_create_filter(
      &gr.sink, A.avfilter_get_by_name("abuffersink"), "out", nullptr,
      nullptr, gr.g);
  if (rc < 0) { set_err("create abuffersink", rc); return -1; }

  AVFilterInOut* outputs = A.avfilter_inout_alloc();
  AVFilterInOut* inputs = A.avfilter_inout_alloc();
  if (!outputs || !inputs) { set_err("inout_alloc", 0); return -1; }
  outputs->name = A.av_strdup("in");
  outputs->filter_ctx = gr.src;
  outputs->pad_idx = 0;
  outputs->next = nullptr;
  inputs->name = A.av_strdup("out");
  inputs->filter_ctx = gr.sink;
  inputs->pad_idx = 0;
  inputs->next = nullptr;
  rc = A.avfilter_graph_parse_ptr(gr.g, desc, &inputs, &outputs, nullptr);
  A.avfilter_inout_free(&inputs);
  A.avfilter_inout_free(&outputs);
  if (rc < 0) { set_err("graph_parse", rc); return -1; }
  rc = A.avfilter_graph_config(gr.g, nullptr);
  if (rc < 0) { set_err("graph_config", rc); return -1; }
  return 0;
}

// Append one sink frame (any common sample format) interleaved into out.
int append_frame(AVFrame8* f, std::vector<float>& out, int* out_ch,
                 int* out_rate) {
  int ch = f->ch_layout.nb_channels;
  int n = f->nb_samples;
  if (ch < 1 || ch > 8 || n < 0 || n > (1 << 26)) {
    set_err("implausible sink frame (ABI layout mismatch?)", 0);
    return -1;
  }
  if (*out_ch == 0) { *out_ch = ch; *out_rate = f->sample_rate; }
  if (ch != *out_ch) { set_err("channel count changed mid-stream", 0);
                       return -1; }
  size_t base = out.size();
  out.resize(base + (size_t)n * ch);
  float* dst = out.data() + base;
  uint8_t** planes = f->extended_data ? f->extended_data : f->data;
  switch (f->format) {
    case FMT_FLT: {
      memcpy(dst, planes[0], (size_t)n * ch * sizeof(float));
      break;
    }
    case FMT_FLTP: {
      for (int c = 0; c < ch; ++c) {
        const float* p = (const float*)planes[c];
        for (int i = 0; i < n; ++i) dst[(size_t)i * ch + c] = p[i];
      }
      break;
    }
    case FMT_DBL: {
      const double* p = (const double*)planes[0];
      for (size_t i = 0; i < (size_t)n * ch; ++i) dst[i] = (float)p[i];
      break;
    }
    case FMT_DBLP: {
      for (int c = 0; c < ch; ++c) {
        const double* p = (const double*)planes[c];
        for (int i = 0; i < n; ++i) dst[(size_t)i * ch + c] = (float)p[i];
      }
      break;
    }
    case FMT_S16: {
      const int16_t* p = (const int16_t*)planes[0];
      for (size_t i = 0; i < (size_t)n * ch; ++i)
        dst[i] = p[i] / 32768.0f;
      break;
    }
    case FMT_S32: {
      const int32_t* p = (const int32_t*)planes[0];
      for (size_t i = 0; i < (size_t)n * ch; ++i)
        dst[i] = (float)(p[i] / 2147483648.0);
      break;
    }
    default:
      set_err("unsupported sink sample format", f->format);
      return -1;
  }
  return 0;
}

int drain(Graph& gr, AVFrame8* of, std::vector<float>& out, int* out_ch,
          int* out_rate) {
  for (;;) {
    int rc = A.av_buffersink_get_frame(gr.sink, of);
    if (rc == kAvErrEagain || rc == kAvErrEof) return 0;
    if (rc < 0) { set_err("buffersink_get_frame", rc); return -1; }
    rc = append_frame(of, out, out_ch, out_rate);
    A.av_frame_unref(of);
    if (rc < 0) return -1;
  }
}

}  // namespace

extern "C" {

const char* ame_flt_error() { return g_err; }

void ame_flt_free(void* p) { free(p); }

int ame_flt_init(const char* libavfilter_path) {
  if (g_inited) return 0;
  g_err[0] = 0;
  A.h = dlopen(libavfilter_path, RTLD_NOW | RTLD_LOCAL);
  if (!A.h) {
    snprintf(g_err, sizeof(g_err), "dlopen: %s", dlerror());
    return -1;
  }
  // dlsym on the avfilter handle resolves through its dependency chain
  // (the wheel's own avutil/swresample, via their $ORIGIN rpath).
  bool ok = sym(A.avfilter_version, "avfilter_version") &&
            sym(A.avfilter_graph_alloc, "avfilter_graph_alloc") &&
            sym(A.avfilter_graph_free, "avfilter_graph_free") &&
            sym(A.avfilter_get_by_name, "avfilter_get_by_name") &&
            sym(A.avfilter_graph_create_filter,
                "avfilter_graph_create_filter") &&
            sym(A.avfilter_inout_alloc, "avfilter_inout_alloc") &&
            sym(A.avfilter_inout_free, "avfilter_inout_free") &&
            sym(A.avfilter_graph_parse_ptr, "avfilter_graph_parse_ptr") &&
            sym(A.avfilter_graph_config, "avfilter_graph_config") &&
            sym(A.av_buffersrc_add_frame, "av_buffersrc_add_frame") &&
            sym(A.av_buffersink_get_frame, "av_buffersink_get_frame") &&
            sym(A.av_frame_alloc, "av_frame_alloc") &&
            sym(A.av_frame_free, "av_frame_free") &&
            sym(A.av_frame_unref, "av_frame_unref") &&
            sym(A.av_frame_get_buffer, "av_frame_get_buffer") &&
            sym(A.av_channel_layout_default, "av_channel_layout_default") &&
            sym(A.av_strerror, "av_strerror") &&
            sym(A.av_strdup, "av_strdup") &&
            sym(A.av_log_set_callback, "av_log_set_callback") &&
            sym(A.av_log_default_callback, "av_log_default_callback") &&
            sym(A.av_log_set_level, "av_log_set_level");
  if (!ok) return -2;
  // The struct transcription targets libavfilter major >= 8 era (v10/11);
  // refuse anything older where the removed AVFrame fields still exist.
  if ((A.avfilter_version() >> 16) < 10) {
    snprintf(g_err, sizeof(g_err), "libavfilter too old: %u",
             A.avfilter_version() >> 16);
    return -3;
  }
  g_inited = true;
  return 0;
}

long long ame_flt_run(const char* desc, const float* in, long long n_frames,
                      int ch, int rate, float** out_data, int* out_ch,
                      int* out_rate, char** log_out) {
  g_err[0] = 0;
  if (!g_inited) { set_err("not initialized", 0); return -1; }
  if (ch < 1 || ch > 2 || n_frames <= 0 || rate < 1000) {
    set_err("bad args", 0);
    return -1;
  }
  g_log.clear();
  A.av_log_set_callback(log_cb);
  long long result = -1;
  {
    Graph gr;
    std::vector<float> out;
    out.reserve((size_t)n_frames * ch);
    *out_ch = 0;
    *out_rate = 0;
    if (build_graph(gr, desc, ch, rate) < 0) goto done;
    {
      AVFrame8* of = A.av_frame_alloc();
      const long long kChunk = 4096;
      int rc = 0;
      for (long long pos = 0; pos < n_frames && rc == 0; pos += kChunk) {
        int n = (int)((n_frames - pos) < kChunk ? (n_frames - pos) : kChunk);
        AVFrame8* f = A.av_frame_alloc();
        f->nb_samples = n;
        f->format = FMT_FLT;
        f->sample_rate = rate;
        f->pts = pos;
        A.av_channel_layout_default(&f->ch_layout, ch);
        rc = A.av_frame_get_buffer(f, 0);
        if (rc < 0) {
          set_err("frame_get_buffer (ABI layout mismatch?)", rc);
        } else {
          memcpy(f->data[0], in + (size_t)pos * ch,
                 (size_t)n * ch * sizeof(float));
          rc = A.av_buffersrc_add_frame(gr.src, f);
          if (rc < 0) set_err("buffersrc_add_frame", rc);
        }
        A.av_frame_free(&f);
        if (rc == 0) rc = drain(gr, of, out, out_ch, out_rate);
      }
      if (rc == 0) {
        rc = A.av_buffersrc_add_frame(gr.src, nullptr);  // EOF
        if (rc < 0) set_err("buffersrc EOF", rc);
      }
      if (rc == 0) rc = drain(gr, of, out, out_ch, out_rate);
      A.av_frame_free(&of);
      if (rc == 0) {
        // Free the graph NOW: filters print their summaries (loudnorm's
        // JSON stats) from uninit, and the caller wants them in the log.
        A.avfilter_graph_free(&gr.g);
        size_t bytes = out.size() * sizeof(float);
        float* buf = (float*)malloc(bytes ? bytes : 4);
        if (buf) {
          memcpy(buf, out.data(), bytes);
          *out_data = buf;
          result = *out_ch ? (long long)(out.size() / *out_ch) : 0;
        } else {
          set_err("oom", 0);
        }
      }
    }
  }
done:
  A.av_log_set_callback(A.av_log_default_callback);
  if (log_out) {
    *log_out = (char*)malloc(g_log.size() + 1);
    if (*log_out) memcpy(*log_out, g_log.c_str(), g_log.size() + 1);
  }
  return result;
}

// Validate the transcribed ABI before anyone trusts filter output: an
// "anull" round-trip must be bit-exact (pins the frame write/read paths)
// and "aresample=48000" must report a changed rate and a ~48/44.1-scaled
// sample count (pins the sample_rate field offset).
int ame_flt_selfcheck() {
  if (g_checked) return 1;
  if (!g_inited) return 0;
  const int n = 9973, ch = 2, sr = 44100;
  std::vector<float> x((size_t)n * ch);
  uint32_t s = 0x12345678u;
  for (auto& v : x) {
    s = s * 1664525u + 1013904223u;
    v = (float)((int32_t)s) / 2147483648.0f;
  }
  float* out = nullptr;
  char* log = nullptr;
  int och = 0, osr = 0;
  long long got = ame_flt_run("anull", x.data(), n, ch, sr, &out, &och,
                              &osr, &log);
  free(log);
  bool ok = got == n && och == ch && osr == sr && out &&
            memcmp(out, x.data(), x.size() * sizeof(float)) == 0;
  free(out);
  if (!ok) {
    if (!g_err[0]) set_err("anull roundtrip mismatch", 0);
    return 0;
  }
  out = nullptr;
  got = ame_flt_run("aresample=48000", x.data(), n, ch, sr, &out, &och,
                    &osr, &log);
  free(log);
  long long want = (long long)((double)n * 48000 / 44100);
  ok = got > want - 200 && got < want + 200 && och == ch && osr == 48000;
  free(out);
  if (!ok) {
    if (!g_err[0]) set_err("aresample selfcheck mismatch", 0);
    return 0;
  }
  g_checked = true;
  return 1;
}

}  // extern "C"
