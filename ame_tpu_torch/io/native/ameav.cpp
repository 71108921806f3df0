// ameav — universal-format codec edge via the system FFmpeg libraries.
//
// The reference shells out to ffmpeg/pydub for "any input format" decode
// (audio_mastering_engine.py:190, N1 in SURVEY §2.3) and for its export
// formats. The first-class formats (WAV/AIFF/FLAC/MP3) are decoded by
// self-contained in-repo code (io/wav.py, io/flac.py, amecodec.cpp); this
// shim extends coverage to every remaining container/codec the system
// libavformat/libavcodec build supports (ogg/vorbis, opus, m4a/aac, alac,
// wma, wavpack, ...) — in-process, no subprocesses, no temp pipes.
//
// Exposed C ABI (consumed by ame_tpu_torch/io/av.py over ctypes):
//   int  ame_av_decode(path, &out_f32, &n_frames, &channels, &rate)
//   int  ame_av_encode(path, interleaved_f32, n_frames, channels, rate,
//                      codec_hint_or_null, bitrate_bps_or_0)
//   void ame_av_free(ptr)
//   int  ame_av_have();
//   const char* ame_av_error();   // last failure detail (static buffer)
//
// Return codes: 0 ok; negative = error (see ame_av_error for detail).
// Decode output is interleaved float32 at the stream's native sample rate;
// >2-channel sources are downmixed to stereo by swresample's default
// matrix (the reference's set_channels(2) edge then applies downstream).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/avutil.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libavutil/samplefmt.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

char g_err[512] = "";

void set_err(const char* where, int averr) {
  char buf[256] = "";
  if (averr < 0) av_strerror(averr, buf, sizeof(buf));
  snprintf(g_err, sizeof(g_err), "%s%s%s", where, averr < 0 ? ": " : "",
           buf);
}

struct DecodeCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  ~DecodeCtx() {
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
  }
};

// Append one decoded frame, converted to interleaved f32, to `out`.
int push_frame(DecodeCtx& c, AVFrame* f, int out_ch, int rate,
               std::vector<float>& out) {
  if (!c.swr) {
    AVChannelLayout out_layout;
    av_channel_layout_default(&out_layout, out_ch);
    int rc = swr_alloc_set_opts2(&c.swr, &out_layout, AV_SAMPLE_FMT_FLT,
                                 rate, &f->ch_layout,
                                 (AVSampleFormat)f->format, f->sample_rate,
                                 0, nullptr);
    av_channel_layout_uninit(&out_layout);
    if (rc < 0 || !c.swr || (rc = swr_init(c.swr)) < 0) {
      set_err("swr_init", rc);
      return -3;
    }
  }
  int max_out = f->nb_samples + 64;
  size_t base = out.size();
  out.resize(base + (size_t)max_out * out_ch);
  uint8_t* dst = (uint8_t*)(out.data() + base);
  int got = swr_convert(c.swr, &dst, max_out,
                        (const uint8_t**)f->extended_data, f->nb_samples);
  if (got < 0) {
    set_err("swr_convert", got);
    return -3;
  }
  out.resize(base + (size_t)got * out_ch);
  return 0;
}

int flush_swr(DecodeCtx& c, int out_ch, std::vector<float>& out) {
  if (!c.swr) return 0;
  for (;;) {
    int max_out = 4096;
    size_t base = out.size();
    out.resize(base + (size_t)max_out * out_ch);
    uint8_t* dst = (uint8_t*)(out.data() + base);
    int got = swr_convert(c.swr, &dst, max_out, nullptr, 0);
    if (got < 0) {
      set_err("swr_convert(flush)", got);
      return -3;
    }
    out.resize(base + (size_t)got * out_ch);
    if (got == 0) break;
  }
  return 0;
}

}  // namespace

extern "C" {

int ame_av_have() { return 1; }

const char* ame_av_error() { return g_err; }

void ame_av_free(float* p) { free(p); }

int ame_av_decode(const char* path, float** out_data, long long* n_frames,
                  int* channels, int* rate) {
  g_err[0] = 0;
  DecodeCtx c;
  int rc = avformat_open_input(&c.fmt, path, nullptr, nullptr);
  if (rc < 0) {
    set_err("open_input", rc);
    return -1;
  }
  rc = avformat_find_stream_info(c.fmt, nullptr);
  if (rc < 0) {
    set_err("find_stream_info", rc);
    return -1;
  }
  const AVCodec* codec = nullptr;
  int stream = av_find_best_stream(c.fmt, AVMEDIA_TYPE_AUDIO, -1, -1,
                                   &codec, 0);
  if (stream < 0 || !codec) {
    set_err("no audio stream", stream);
    return -2;
  }
  AVStream* st = c.fmt->streams[stream];
  c.dec = avcodec_alloc_context3(codec);
  if (!c.dec) return -2;
  rc = avcodec_parameters_to_context(c.dec, st->codecpar);
  if (rc < 0 || (rc = avcodec_open2(c.dec, codec, nullptr)) < 0) {
    set_err("decoder open", rc);
    return -2;
  }

  int out_rate = c.dec->sample_rate;
  int in_ch = c.dec->ch_layout.nb_channels;
  int out_ch = in_ch > 2 ? 2 : (in_ch < 1 ? 1 : in_ch);

  c.pkt = av_packet_alloc();
  c.frame = av_frame_alloc();
  std::vector<float> samples;
  if (st->duration > 0) {
    double secs = st->duration * av_q2d(st->time_base);
    if (secs > 0 && secs < 4 * 3600.0)
      samples.reserve((size_t)(secs * out_rate) * out_ch + 4096);
  }

  bool eof = false;
  while (!eof) {
    rc = av_read_frame(c.fmt, c.pkt);
    if (rc == AVERROR_EOF) {
      eof = true;
    } else if (rc < 0) {
      set_err("read_frame", rc);
      return -3;
    } else if (c.pkt->stream_index != stream) {
      av_packet_unref(c.pkt);
      continue;
    }
    rc = avcodec_send_packet(c.dec, eof ? nullptr : c.pkt);
    av_packet_unref(c.pkt);
    if (rc < 0 && rc != AVERROR(EAGAIN) && rc != AVERROR_EOF) {
      set_err("send_packet", rc);
      return -3;
    }
    for (;;) {
      rc = avcodec_receive_frame(c.dec, c.frame);
      if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) break;
      if (rc < 0) {
        set_err("receive_frame", rc);
        return -3;
      }
      // Output stays at the first frame's rate; swr was initialised from
      // it, and a mid-stream rate change is treated as a decode error.
      if ((rc = push_frame(c, c.frame, out_ch, out_rate, samples)) < 0)
        return rc;
      av_frame_unref(c.frame);
    }
  }
  if ((rc = flush_swr(c, out_ch, samples)) < 0) return rc;

  if (samples.empty()) {
    set_err("decoded zero samples", 0);
    return -4;
  }
  size_t bytes = samples.size() * sizeof(float);
  float* buf = (float*)malloc(bytes);
  if (!buf) return -5;
  memcpy(buf, samples.data(), bytes);
  *out_data = buf;
  *n_frames = (long long)(samples.size() / out_ch);
  *channels = out_ch;
  *rate = out_rate;
  return 0;
}

// ---------------------------------------------------------------------------

namespace {

struct EncodeCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* enc = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  uint8_t** planes = nullptr;
  bool header_written = false;
  ~EncodeCtx() {
    if (planes) {
      av_freep(&planes[0]);
      av_freep(&planes);
    }
    if (swr) swr_free(&swr);
    if (enc) avcodec_free_context(&enc);
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
    if (fmt) {
      if (fmt->pb && !(fmt->oformat->flags & AVFMT_NOFILE))
        avio_closep(&fmt->pb);
      avformat_free_context(fmt);
    }
  }
};

// Pick an encoder for the output path. The system build's libvorbis /
// libopus wrappers beat the native experimental encoders, so prefer them.
const AVCodec* pick_encoder(const char* path, const char* hint,
                            bool* experimental) {
  *experimental = false;
  auto by = [&](const char* n) { return avcodec_find_encoder_by_name(n); };
  if (hint && hint[0]) {
    const AVCodec* c = by(hint);
    if (c) return c;
  }
  const char* dot = strrchr(path, '.');
  std::string ext = dot ? dot + 1 : "";
  for (auto& ch : ext) ch = (char)tolower(ch);
  if (ext == "flac") return by("flac");
  if (ext == "ogg" || ext == "oga") {
    if (const AVCodec* c = by("libvorbis")) return c;
    *experimental = true;
    return by("vorbis");
  }
  if (ext == "opus") {
    if (const AVCodec* c = by("libopus")) return c;
    *experimental = true;
    return by("opus");
  }
  if (ext == "m4a" || ext == "mp4" || ext == "aac") return by("aac");
  if (ext == "mp3") return by("libmp3lame");
  if (ext == "wav") return by("pcm_s16le");
  return nullptr;
}

AVSampleFormat pick_sample_fmt(const AVCodec* codec) {
  if (!codec->sample_fmts) return AV_SAMPLE_FMT_FLTP;
  // Prefer float formats (our input is f32), then highest-fidelity int.
  for (const AVSampleFormat* f = codec->sample_fmts;
       *f != AV_SAMPLE_FMT_NONE; ++f)
    if (*f == AV_SAMPLE_FMT_FLTP || *f == AV_SAMPLE_FMT_FLT) return *f;
  for (const AVSampleFormat* f = codec->sample_fmts;
       *f != AV_SAMPLE_FMT_NONE; ++f)
    if (*f == AV_SAMPLE_FMT_S32P || *f == AV_SAMPLE_FMT_S32) return *f;
  return codec->sample_fmts[0];
}

int pick_rate(const AVCodec* codec, int want) {
  if (!codec->supported_samplerates) return want;
  int best = 0;
  for (const int* r = codec->supported_samplerates; *r; ++r) {
    if (*r == want) return want;
    // closest from above, else overall max
    if (*r > want && (best <= want || *r < best)) best = *r;
    if (best == 0 || (best < want && *r > best)) best = *r;
  }
  return best ? best : want;
}

int drain_encoder(EncodeCtx& c, bool flush) {
  int rc = avcodec_send_frame(c.enc, flush ? nullptr : c.frame);
  if (rc < 0 && rc != AVERROR(EAGAIN) && rc != AVERROR_EOF) {
    set_err("send_frame", rc);
    return -3;
  }
  for (;;) {
    rc = avcodec_receive_packet(c.enc, c.pkt);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) {
      set_err("receive_packet", rc);
      return -3;
    }
    av_packet_rescale_ts(c.pkt, c.enc->time_base,
                         c.fmt->streams[0]->time_base);
    c.pkt->stream_index = 0;
    rc = av_interleaved_write_frame(c.fmt, c.pkt);
    if (rc < 0) {
      set_err("write_frame", rc);
      return -3;
    }
  }
}

}  // namespace

int ame_av_encode(const char* path, const float* data, long long n_frames,
                  int channels, int rate, const char* codec_hint,
                  int bitrate) {
  g_err[0] = 0;
  if (channels < 1 || channels > 8 || n_frames <= 0) {
    set_err("bad encode args", 0);
    return -1;
  }
  EncodeCtx c;
  int rc = avformat_alloc_output_context2(&c.fmt, nullptr, nullptr, path);
  if (rc < 0 || !c.fmt) {
    set_err("alloc_output (unknown extension?)", rc);
    return -1;
  }
  bool experimental = false;
  const AVCodec* codec = pick_encoder(path, codec_hint, &experimental);
  if (!codec) {
    set_err("no encoder for extension", 0);
    return -2;
  }
  c.enc = avcodec_alloc_context3(codec);
  if (!c.enc) return -2;
  c.enc->sample_fmt = pick_sample_fmt(codec);
  c.enc->sample_rate = pick_rate(codec, rate);
  av_channel_layout_default(&c.enc->ch_layout, channels);
  c.enc->time_base = AVRational{1, c.enc->sample_rate};
  if (bitrate > 0) {
    c.enc->bit_rate = bitrate;
  } else if (codec->id == AV_CODEC_ID_VORBIS || codec->id == AV_CODEC_ID_AAC ||
             codec->id == AV_CODEC_ID_OPUS) {
    c.enc->bit_rate = 192000;  // transparent-class default for lossy export
  }
  if (experimental)
    c.enc->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;
  if (c.fmt->oformat->flags & AVFMT_GLOBALHEADER)
    c.enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  rc = avcodec_open2(c.enc, codec, nullptr);
  if (rc < 0) {
    set_err("encoder open", rc);
    return -2;
  }

  AVStream* st = avformat_new_stream(c.fmt, nullptr);
  if (!st) return -2;
  st->time_base = c.enc->time_base;
  rc = avcodec_parameters_from_context(st->codecpar, c.enc);
  if (rc < 0) {
    set_err("parameters_from_context", rc);
    return -2;
  }
  if (!(c.fmt->oformat->flags & AVFMT_NOFILE)) {
    rc = avio_open(&c.fmt->pb, path, AVIO_FLAG_WRITE);
    if (rc < 0) {
      set_err("avio_open", rc);
      return -1;
    }
  }
  rc = avformat_write_header(c.fmt, nullptr);
  if (rc < 0) {
    set_err("write_header", rc);
    return -3;
  }
  c.header_written = true;

  // Convert the full input once (fmt + rate) into planar scratch, then
  // slice encoder-sized frames out of it.
  AVChannelLayout in_layout;
  av_channel_layout_default(&in_layout, channels);
  rc = swr_alloc_set_opts2(&c.swr, &c.enc->ch_layout, c.enc->sample_fmt,
                           c.enc->sample_rate, &in_layout,
                           AV_SAMPLE_FMT_FLT, rate, 0, nullptr);
  av_channel_layout_uninit(&in_layout);
  if (rc < 0 || !c.swr || (rc = swr_init(c.swr)) < 0) {
    set_err("swr_init(encode)", rc);
    return -3;
  }
  int64_t max_out = av_rescale_rnd(n_frames + 8192, c.enc->sample_rate,
                                   rate, AV_ROUND_UP);
  int linesize = 0;
  rc = av_samples_alloc_array_and_samples(&c.planes, &linesize, channels,
                                          (int)max_out, c.enc->sample_fmt,
                                          0);
  if (rc < 0) {
    set_err("samples_alloc", rc);
    return -5;
  }
  const uint8_t* in_planes[1] = {(const uint8_t*)data};
  int got = swr_convert(c.swr, c.planes, (int)max_out, in_planes,
                        (int)n_frames);
  if (got >= 0 && got < max_out) {
    // flush the resampler tail (matters when resampling, e.g. opus 48k)
    uint8_t* tail[AV_NUM_DATA_POINTERS] = {nullptr};
    int nb_planes =
        av_sample_fmt_is_planar(c.enc->sample_fmt) ? channels : 1;
    int bps = av_get_bytes_per_sample(c.enc->sample_fmt);
    int step = av_sample_fmt_is_planar(c.enc->sample_fmt) ? bps
                                                          : bps * channels;
    for (int p = 0; p < nb_planes; ++p)
      tail[p] = c.planes[p] + (size_t)got * step;
    int extra = swr_convert(c.swr, tail, (int)(max_out - got), nullptr, 0);
    if (extra > 0) got += extra;
  }
  if (got < 0) {
    set_err("swr_convert(encode)", got);
    return -3;
  }

  c.pkt = av_packet_alloc();
  c.frame = av_frame_alloc();
  int frame_size = c.enc->frame_size > 0 ? c.enc->frame_size : 4096;
  int64_t pts = 0;
  for (int64_t off = 0; off < got; off += frame_size) {
    int n = (int)((got - off) < frame_size ? (got - off) : frame_size);
    c.frame->format = c.enc->sample_fmt;
    c.frame->sample_rate = c.enc->sample_rate;
    rc = av_channel_layout_copy(&c.frame->ch_layout, &c.enc->ch_layout);
    c.frame->nb_samples = n;
    if (rc < 0 || (rc = av_frame_get_buffer(c.frame, 0)) < 0) {
      set_err("frame_get_buffer", rc);
      return -5;
    }
    av_samples_copy(c.frame->extended_data, c.planes, 0, (int)off, n,
                    channels, c.enc->sample_fmt);
    c.frame->pts = pts;
    pts += n;
    if ((rc = drain_encoder(c, false)) < 0) return rc;
    av_frame_unref(c.frame);
  }
  if ((rc = drain_encoder(c, true)) < 0) return rc;
  rc = av_write_trailer(c.fmt);
  if (rc < 0) {
    set_err("write_trailer", rc);
    return -3;
  }
  return 0;
}

}  // extern "C"
