// Native media decoder of wise_tpu_torch (copy of wise_tpu/native/decoder.cpp).
//
// TPU-native replacement for the reference's torchaudio.io.StreamReader
// usage (ox-vgg/WISE/src/dataloader/streamreader.py:187-233): demux +
// decode via FFmpeg's libav*, producing
//   - video: RGB24 frames sampled on a fixed fps grid (fps-filter semantics:
//     output tick k at t=k/fps emits the last decoded frame with pts <= t;
//     the first frame covers early ticks when the stream starts late; output
//     ends when t passes the final frame's pts), and
//   - audio: mono float32 resampled to a target rate.
//
// Exposed as a plain C API consumed from Python via ctypes (no pybind11 in
// this environment). Built at first use by io/native_decoder.py into
// build/native/.

extern "C" {
#include <libavformat/avformat.h>
#include <libavcodec/avcodec.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <vector>

extern "C" void wise_decoder_close(void* h);

namespace {

constexpr double EPS = 1e-9;

struct MediaInfo {
  double duration = 0.0;
  int width = 0;
  int height = 0;
  double fps = 0.0;
  int64_t num_frames = 0;
  int has_video = 0;
  int has_audio = 0;
  int sample_rate = 0;
  int channels = 0;
};

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  int stream_index = -1;
  int mode = 0;  // 0 = video, 1 = audio, 2 = probe
  double target_fps = 0.0;
  int target_rate = 0;
  MediaInfo info;
  bool eof = true;

  // video fps-grid state: `prev` = last frame with pts <= current tick,
  // `ahead` = first decoded frame beyond it. Held as refcounted AVFrame
  // clones; RGB conversion happens only on emit (at 2 fps from a 30 fps
  // source that is 15x less sws_scale work than converting every frame).
  int64_t next_tick = 0;
  AVFrame* prev_frame = nullptr;
  AVFrame* ahead_frame = nullptr;
  double prev_pts = -1.0, ahead_pts = -1.0;

  // audio buffered output
  std::deque<float> audio_buf;
  double audio_pts0 = 0.0;
  int64_t audio_consumed = 0;
  bool audio_pts0_set = false;
};

void probe_streams(Decoder* d) {
  for (unsigned i = 0; i < d->fmt->nb_streams; i++) {
    AVStream* st = d->fmt->streams[i];
    if (st->codecpar->codec_type == AVMEDIA_TYPE_VIDEO) {
      if (st->disposition & AV_DISPOSITION_ATTACHED_PIC) continue;
      d->info.has_video = 1;
      d->info.width = st->codecpar->width;
      d->info.height = st->codecpar->height;
      AVRational r = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
      if (r.den > 0) d->info.fps = av_q2d(r);
      if (st->nb_frames > 0) d->info.num_frames = st->nb_frames;
      if (st->duration > 0) {
        double dur = st->duration * av_q2d(st->time_base);
        if (dur > d->info.duration) d->info.duration = dur;
      }
    } else if (st->codecpar->codec_type == AVMEDIA_TYPE_AUDIO) {
      d->info.has_audio = 1;
      d->info.sample_rate = st->codecpar->sample_rate;
      d->info.channels = st->codecpar->ch_layout.nb_channels;
      if (st->duration > 0) {
        double dur = st->duration * av_q2d(st->time_base);
        if (dur > d->info.duration) d->info.duration = dur;
      }
    }
  }
  if (d->fmt->duration > 0) {
    double dur = (double)d->fmt->duration / AV_TIME_BASE;
    if (dur > d->info.duration) d->info.duration = dur;
  }
  if (d->info.num_frames == 0 && d->info.fps > 0 && d->info.duration > 0) {
    d->info.num_frames = (int64_t)(d->info.duration * d->info.fps + 0.5);
  }
}

int open_codec(Decoder* d, enum AVMediaType type) {
  const AVCodec* dec = nullptr;
  int idx = av_find_best_stream(d->fmt, type, -1, -1, &dec, 0);
  if (idx < 0 || !dec) return -1;
  d->stream_index = idx;
  d->codec = avcodec_alloc_context3(dec);
  if (!d->codec) return -1;
  if (avcodec_parameters_to_context(d->codec, d->fmt->streams[idx]->codecpar) < 0)
    return -1;
  d->codec->thread_count = 0;  // auto
  if (avcodec_open2(d->codec, dec, nullptr) < 0) return -1;
  return 0;
}

double frame_pts_seconds(Decoder* d, AVFrame* f) {
  int64_t pts = f->best_effort_timestamp;
  if (pts == AV_NOPTS_VALUE) pts = f->pts;
  if (pts == AV_NOPTS_VALUE) return -1.0;
  return pts * av_q2d(d->fmt->streams[d->stream_index]->time_base);
}

// Decode the next frame from the selected stream into d->frame.
// Returns 1 on frame, 0 on EOF, <0 on error.
int next_frame(Decoder* d) {
  while (true) {
    int ret = avcodec_receive_frame(d->codec, d->frame);
    if (ret == 0) return 1;
    if (ret == AVERROR_EOF) return 0;
    if (ret != AVERROR(EAGAIN)) return ret;
    while (true) {
      ret = av_read_frame(d->fmt, d->pkt);
      if (ret == AVERROR_EOF) {
        avcodec_send_packet(d->codec, nullptr);  // enter drain mode
        break;
      }
      if (ret < 0) return ret;
      if (d->pkt->stream_index != d->stream_index) {
        av_packet_unref(d->pkt);
        continue;
      }
      ret = avcodec_send_packet(d->codec, d->pkt);
      av_packet_unref(d->pkt);
      if (ret < 0 && ret != AVERROR(EAGAIN)) return ret;
      break;
    }
  }
}

void frame_to_rgb(Decoder* d, AVFrame* f, uint8_t* dst) {
  d->sws = sws_getCachedContext(d->sws, f->width, f->height,
                                (AVPixelFormat)f->format, f->width, f->height,
                                AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                                nullptr, nullptr);
  uint8_t* dst_data[4] = {dst, nullptr, nullptr, nullptr};
  int dst_linesize[4] = {3 * f->width, 0, 0, 0};
  sws_scale(d->sws, f->data, f->linesize, 0, f->height, dst_data, dst_linesize);
}

// Decode one frame into `ahead` (refcounted clone; no pixel conversion).
// Returns 1 ok, 0 eof, <0 error.
int advance_ahead(Decoder* d) {
  int r = next_frame(d);
  if (r <= 0) {
    if (r == 0) d->eof = true;
    return r;
  }
  if (d->ahead_frame) av_frame_free(&d->ahead_frame);
  d->ahead_frame = av_frame_clone(d->frame);
  double fpts = frame_pts_seconds(d, d->frame);
  d->ahead_pts = fpts >= 0 ? fpts : (d->ahead_frame ? d->ahead_pts : 0.0);
  av_frame_unref(d->frame);
  return d->ahead_frame ? 1 : -1;
}

void promote_ahead(Decoder* d) {
  if (d->prev_frame) av_frame_free(&d->prev_frame);
  d->prev_frame = d->ahead_frame;
  d->ahead_frame = nullptr;
  d->prev_pts = d->ahead_pts;
}

}  // namespace

extern "C" {

// mode: 0 = video decode, 1 = audio decode, 2 = probe only
void* wise_decoder_open(const char* path, int mode, double fps, int sample_rate) {
  Decoder* d = new Decoder();
  d->mode = mode;
  d->target_fps = fps;
  d->target_rate = sample_rate;
  if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) {
    delete d;
    return nullptr;
  }
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  probe_streams(d);
  if (mode == 2) return d;

  enum AVMediaType type = mode == 0 ? AVMEDIA_TYPE_VIDEO : AVMEDIA_TYPE_AUDIO;
  if (open_codec(d, type) < 0) {
    wise_decoder_close(d);
    return nullptr;
  }
  d->pkt = av_packet_alloc();
  d->frame = av_frame_alloc();
  d->eof = false;

  if (mode == 1) {
    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    int rate = sample_rate > 0 ? sample_rate : d->codec->sample_rate;
    if (swr_alloc_set_opts2(&d->swr, &mono, AV_SAMPLE_FMT_FLT, rate,
                            &d->codec->ch_layout, d->codec->sample_fmt,
                            d->codec->sample_rate, 0, nullptr) < 0 ||
        swr_init(d->swr) < 0) {
      wise_decoder_close(d);
      return nullptr;
    }
  }
  return d;
}

void wise_decoder_close(void* h) {
  Decoder* d = (Decoder*)h;
  if (!d) return;
  if (d->prev_frame) av_frame_free(&d->prev_frame);
  if (d->ahead_frame) av_frame_free(&d->ahead_frame);
  if (d->sws) sws_freeContext(d->sws);
  if (d->swr) swr_free(&d->swr);
  if (d->frame) av_frame_free(&d->frame);
  if (d->pkt) av_packet_free(&d->pkt);
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

int wise_decoder_info(void* h, double* duration, int* width, int* height,
                      double* fps, long long* num_frames, int* has_video,
                      int* has_audio, int* sample_rate, int* channels) {
  Decoder* d = (Decoder*)h;
  if (!d) return -1;
  *duration = d->info.duration;
  *width = d->info.width;
  *height = d->info.height;
  *fps = d->info.fps;
  *num_frames = d->info.num_frames;
  *has_video = d->info.has_video;
  *has_audio = d->info.has_audio;
  *sample_rate = d->info.sample_rate;
  *channels = d->info.channels;
  return 0;
}

// Read up to max_frames RGB24 frames sampled on the fps grid (or every frame
// when fps <= 0). buf must hold max_frames*H*W*3 bytes; pts gets one
// timestamp per frame. Returns frames written (0 = EOF), <0 on error.
int wise_decoder_read_video(void* h, uint8_t* buf, double* pts, int max_frames) {
  Decoder* d = (Decoder*)h;
  if (!d || d->mode != 0) return -1;
  const size_t frame_bytes = (size_t)d->codec->width * d->codec->height * 3;
  int produced = 0;

  if (d->target_fps <= 0) {  // native-rate passthrough
    while (produced < max_frames) {
      int r = next_frame(d);
      if (r < 0) return r;
      if (r == 0) break;
      frame_to_rgb(d, d->frame, buf + produced * frame_bytes);
      pts[produced] = frame_pts_seconds(d, d->frame);
      av_frame_unref(d->frame);
      produced++;
    }
    return produced;
  }

  const double step = 1.0 / d->target_fps;
  while (produced < max_frames) {
    const double target = d->next_tick * step;
    // invariant sought: prev = last frame with pts <= target,
    //                   ahead = first frame with pts > target (or eof)
    while (!d->eof && (!d->ahead_frame || d->ahead_pts <= target + EPS)) {
      if (d->ahead_frame) promote_ahead(d);
      int r = advance_ahead(d);
      if (r < 0) return r;
      if (r == 0) break;
    }
    if (d->eof && d->ahead_frame && d->ahead_pts <= target + EPS) {
      promote_ahead(d);
    }
    AVFrame* src = nullptr;
    if (d->prev_frame) {
      if (d->eof && !d->ahead_frame && target > d->prev_pts + EPS) break;
      src = d->prev_frame;
    } else if (d->ahead_frame) {
      src = d->ahead_frame;  // stream starts late: first frame covers
    } else {
      break;  // no frames at all
    }
    frame_to_rgb(d, src, buf + produced * frame_bytes);
    pts[produced] = target;
    produced++;
    d->next_tick++;
  }
  return produced;
}

// Read up to max_samples mono float32 samples at the target rate.
// pts_start receives the timestamp of the first returned sample.
// Returns samples written (0 = EOF), <0 on error.
int wise_decoder_read_audio(void* h, float* out, double* pts_start,
                            int max_samples) {
  Decoder* d = (Decoder*)h;
  if (!d || d->mode != 1) return -1;
  const int rate = d->target_rate > 0 ? d->target_rate : d->codec->sample_rate;

  std::vector<float> tmp;
  while ((int)d->audio_buf.size() < max_samples && !d->eof) {
    int r = next_frame(d);
    if (r < 0) return r;
    if (r == 0) {
      d->eof = true;
      int cap = swr_get_out_samples(d->swr, 0) + 256;
      tmp.resize(cap);
      uint8_t* outp[1] = {(uint8_t*)tmp.data()};
      int got = swr_convert(d->swr, outp, cap, nullptr, 0);
      for (int i = 0; i < got; i++) d->audio_buf.push_back(tmp[i]);
      break;
    }
    if (!d->audio_pts0_set) {
      double fpts = frame_pts_seconds(d, d->frame);
      if (fpts >= 0) d->audio_pts0 = fpts;
      d->audio_pts0_set = true;
    }
    int cap = swr_get_out_samples(d->swr, d->frame->nb_samples) + 256;
    tmp.resize(cap);
    uint8_t* outp[1] = {(uint8_t*)tmp.data()};
    int got = swr_convert(d->swr, outp, cap,
                          (const uint8_t**)d->frame->extended_data,
                          d->frame->nb_samples);
    av_frame_unref(d->frame);
    if (got < 0) return got;
    for (int i = 0; i < got; i++) d->audio_buf.push_back(tmp[i]);
  }

  int n = (int)d->audio_buf.size() < max_samples ? (int)d->audio_buf.size()
                                                 : max_samples;
  *pts_start = d->audio_pts0 + (double)d->audio_consumed / rate;
  for (int i = 0; i < n; i++) {
    out[i] = d->audio_buf.front();
    d->audio_buf.pop_front();
  }
  d->audio_consumed += n;
  return n;
}

const char* wise_decoder_version() {
  static char buf[128];
  snprintf(buf, sizeof(buf), "wise-decoder-1.0 lavf%d.%d lavc%d.%d",
           LIBAVFORMAT_VERSION_MAJOR, LIBAVFORMAT_VERSION_MINOR,
           LIBAVCODEC_VERSION_MAJOR, LIBAVCODEC_VERSION_MINOR);
  return buf;
}

}  // extern "C"
