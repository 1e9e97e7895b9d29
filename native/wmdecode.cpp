// In-process libav video decode + encode (libwmdecode.so, ctypes ABI).
//
// Counterpart of the reference's in-process decoder
// (/root/reference/Watermark_GPU/main.cpp:422-437: avformat open, best
// video stream, multithreaded decoder with FF_THREAD_FRAME preferred over
// FF_THREAD_SLICE) and its de-padding copy out of the frame linesize
// (main.cpp:348-353). Differences by design:
//
//  * frames are emitted as packed yuv420p (luma plane then quarter-res
//    U, V — the raw layout the whole video pipeline streams, rawyuv.py);
//  * non-4:2:0 inputs are converted with swscale instead of aborting
//    (the reference whitelists YUV420P/YUVJ420P, main.cpp:458-459;
//    `strict` restores that abort contract);
//  * an in-process ENCODER is provided too: the reference pipes raw
//    frames to an ffmpeg CLI subprocess (main.cpp:284-294), which this
//    image does not have — wme_* writes real encoded files through
//    libavformat/libavcodec directly (codec by name + k=v options).
//
// Plain C ABI throughout; Python binds with ctypes (video/libav.py).

#include <cmath>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

namespace {

void set_err(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

std::string av_err_str(int code) {
  char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
  av_strerror(code, buf, sizeof(buf));
  return std::string(buf);
}

}  // namespace

// ---------------------------------------------------------------- decoder

struct WmDecoder {
  AVFormatContext *fmt = nullptr;
  AVCodecContext *ctx = nullptr;
  SwsContext *sws = nullptr;
  AVPacket *pkt = nullptr;
  AVFrame *frame = nullptr;
  int stream_index = -1;
  int width = 0, height = 0;
  double fps = 0.0;
  bool draining = false;
  std::string pix_fmt_name;
  std::string last_error;
};

extern "C" void *wmd_open(const char *path, int strict, char *err,
                          int errlen) {
  auto *d = new WmDecoder();
  int rc = avformat_open_input(&d->fmt, path, nullptr, nullptr);
  if (rc < 0) {
    set_err(err, errlen, "Could not open video: " + av_err_str(rc));
    delete d;
    return nullptr;
  }
  rc = avformat_find_stream_info(d->fmt, nullptr);
  if (rc < 0) {
    set_err(err, errlen, "No stream info: " + av_err_str(rc));
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  const AVCodec *codec = nullptr;
  rc = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
  if (rc < 0 || !codec) {
    set_err(err, errlen, "No video stream found");
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  d->stream_index = rc;
  AVStream *stream = d->fmt->streams[d->stream_index];
  d->ctx = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(d->ctx, stream->codecpar);
  // decoder threading exactly as the reference picks it (main.cpp:427-434)
  d->ctx->thread_count = 0;  // all cores
  if (codec->capabilities & AV_CODEC_CAP_FRAME_THREADS) {
    d->ctx->thread_type = FF_THREAD_FRAME;
  } else if (codec->capabilities & AV_CODEC_CAP_SLICE_THREADS) {
    d->ctx->thread_type = FF_THREAD_SLICE;
  } else {
    d->ctx->thread_count = 1;
  }
  rc = avcodec_open2(d->ctx, codec, nullptr);
  if (rc < 0) {
    set_err(err, errlen, "Could not open decoder: " + av_err_str(rc));
    avcodec_free_context(&d->ctx);
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  d->width = d->ctx->width;
  d->height = d->ctx->height;
  AVRational rate = av_guess_frame_rate(d->fmt, stream, nullptr);
  d->fps = rate.den ? av_q2d(rate) : 30.0;
  const char *name = av_get_pix_fmt_name(d->ctx->pix_fmt);
  d->pix_fmt_name = name ? name : "";
  bool is420 = d->ctx->pix_fmt == AV_PIX_FMT_YUV420P ||
               d->ctx->pix_fmt == AV_PIX_FMT_YUVJ420P;
  if (strict && !is420) {
    // reference contract: abort on anything but 4:2:0 (main.cpp:458-459)
    set_err(err, errlen,
            "Unsupported pixel format " + d->pix_fmt_name +
                " (strict mode accepts yuv420p/yuvj420p only)");
    avcodec_free_context(&d->ctx);
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  if (d->width % 2 || d->height % 2) {
    set_err(err, errlen, "yuv420p requires even frame dimensions");
    avcodec_free_context(&d->ctx);
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  d->pkt = av_packet_alloc();
  d->frame = av_frame_alloc();
  return d;
}

extern "C" int wmd_width(void *h) { return static_cast<WmDecoder *>(h)->width; }
extern "C" int wmd_height(void *h) {
  return static_cast<WmDecoder *>(h)->height;
}
extern "C" double wmd_fps(void *h) { return static_cast<WmDecoder *>(h)->fps; }
extern "C" const char *wmd_pix_fmt_name(void *h) {
  return static_cast<WmDecoder *>(h)->pix_fmt_name.c_str();
}
extern "C" const char *wmd_error(void *h) {
  return static_cast<WmDecoder *>(h)->last_error.c_str();
}

namespace {

// de-pad (or convert) one decoded frame into packed yuv420p `dst`
int emit_frame(WmDecoder *d, unsigned char *dst) {
  const int w = d->width, h = d->height;
  unsigned char *dst_planes[4] = {dst, dst + w * h,
                                  dst + w * h + (w / 2) * (h / 2), nullptr};
  int dst_lines[4] = {w, w / 2, w / 2, 0};
  auto fmt = static_cast<AVPixelFormat>(d->frame->format);
  if (fmt == AV_PIX_FMT_YUV420P || fmt == AV_PIX_FMT_YUVJ420P) {
    // straight de-padding copy, the reference's linesize branch
    // (main.cpp:348-353), for all three planes
    av_image_copy(dst_planes, dst_lines,
                  const_cast<const uint8_t **>(d->frame->data),
                  d->frame->linesize, AV_PIX_FMT_YUV420P, w, h);
    return 1;
  }
  d->sws = sws_getCachedContext(d->sws, w, h, fmt, w, h, AV_PIX_FMT_YUV420P,
                                SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!d->sws) {
    d->last_error = "could not create swscale converter";
    return -1;
  }
  sws_scale(d->sws, d->frame->data, d->frame->linesize, 0, h, dst_planes,
            dst_lines);
  return 1;
}

}  // namespace

// 1 = frame written to dst (w*h*3/2 bytes), 0 = EOF, -1 = error
extern "C" int wmd_read(void *handle, unsigned char *dst) {
  auto *d = static_cast<WmDecoder *>(handle);
  for (;;) {
    int rc = avcodec_receive_frame(d->ctx, d->frame);
    if (rc == 0) {
      int emitted = emit_frame(d, dst);
      av_frame_unref(d->frame);
      return emitted;
    }
    if (rc == AVERROR_EOF) return 0;
    if (rc != AVERROR(EAGAIN)) {
      d->last_error = "decode failed: " + av_err_str(rc);
      return -1;
    }
    // feed more packets; at container EOF, flush once (NULL packet — the
    // reference's drain pass, main.cpp:333-338)
    for (;;) {
      rc = av_read_frame(d->fmt, d->pkt);
      if (rc == AVERROR_EOF) {
        if (!d->draining) {
          d->draining = true;
          avcodec_send_packet(d->ctx, nullptr);
        } else {
          return 0;  // decoder signalled EAGAIN after drain: nothing left
        }
        break;
      }
      if (rc < 0) {
        d->last_error = "read failed: " + av_err_str(rc);
        return -1;
      }
      bool ours = d->pkt->stream_index == d->stream_index;
      if (ours) {
        rc = avcodec_send_packet(d->ctx, d->pkt);
        av_packet_unref(d->pkt);
        if (rc < 0) {
          // includes EAGAIN: we always drain receive_frame first, so a
          // full decoder here is an anomaly — failing is honest, silently
          // unref'ing would DROP the packet (ffmpeg contract: EAGAIN
          // means not consumed)
          d->last_error = "send failed: " + av_err_str(rc);
          return -1;
        }
        break;
      }
      av_packet_unref(d->pkt);
    }
  }
}

extern "C" void wmd_close(void *handle) {
  auto *d = static_cast<WmDecoder *>(handle);
  if (!d) return;
  if (d->sws) sws_freeContext(d->sws);
  av_frame_free(&d->frame);
  av_packet_free(&d->pkt);
  avcodec_free_context(&d->ctx);
  avformat_close_input(&d->fmt);
  delete d;
}

// ---------------------------------------------------------------- encoder

struct WmEncoder {
  AVFormatContext *fmt = nullptr;
  AVCodecContext *ctx = nullptr;
  AVStream *stream = nullptr;
  AVPacket *pkt = nullptr;
  AVFrame *frame = nullptr;
  int width = 0, height = 0;
  int64_t next_pts = 0;
  bool header_written = false;
  std::string last_error;
  // audio/subtitle stream-copy passthrough (the reference maps them to its
  // ffmpeg child with `-c:s copy -c:a copy -map`, main.cpp:287-289; the
  // in-process encoder remuxes them from `copy_from` via libavformat)
  AVFormatContext *src = nullptr;
  std::vector<int> copy_map;        // src stream index -> out index (-1 drop)
  std::vector<int64_t> copy_shift;  // per-stream start shift, src time_base
  AVPacket *cpkt = nullptr;
  bool cpkt_pending = false;        // cpkt read but not yet due for muxing
  bool src_eof = false;
  std::string notes;                // NOTE lines for dropped/skipped tracks
};

namespace {

int drain_packets(WmEncoder *e) {
  for (;;) {
    int rc = avcodec_receive_packet(e->ctx, e->pkt);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) {
      e->last_error = "encode failed: " + av_err_str(rc);
      return -1;
    }
    av_packet_rescale_ts(e->pkt, e->ctx->time_base, e->stream->time_base);
    e->pkt->stream_index = e->stream->index;
    rc = av_interleaved_write_frame(e->fmt, e->pkt);
    if (rc < 0) {
      e->last_error = "mux failed: " + av_err_str(rc);
      return -1;
    }
  }
}

void free_encoder(WmEncoder *e) {
  av_frame_free(&e->frame);
  av_packet_free(&e->pkt);
  av_packet_free(&e->cpkt);
  avcodec_free_context(&e->ctx);
  if (e->src) avformat_close_input(&e->src);
  if (e->fmt) {
    if (e->fmt->pb) avio_closep(&e->fmt->pb);
    avformat_free_context(e->fmt);
  }
  delete e;
}

// interleave mapped copy-source packets (audio/subtitles) due at or before
// `video_time_sec`; pass INFINITY to drain to EOF (wme_close). Pacing the
// copies against the video clock keeps av_interleaved_write_frame's buffer
// small and the output properly interleaved, like the ffmpeg child's muxer.
int copy_until(WmEncoder *e, double video_time_sec) {
  if (!e->src) return 0;
  for (;;) {
    if (!e->cpkt_pending) {
      if (e->src_eof) return 0;
      int rc = av_read_frame(e->src, e->cpkt);
      if (rc == AVERROR_EOF) {
        e->src_eof = true;
        return 0;
      }
      if (rc < 0) {
        e->last_error = "stream-copy read failed: " + av_err_str(rc);
        return -1;
      }
      unsigned idx = static_cast<unsigned>(e->cpkt->stream_index);
      if (idx >= e->copy_map.size() || e->copy_map[idx] < 0) {
        av_packet_unref(e->cpkt);
        continue;
      }
      e->cpkt_pending = true;
    }
    unsigned idx = static_cast<unsigned>(e->cpkt->stream_index);
    AVStream *in = e->src->streams[idx];
    AVStream *out = e->fmt->streams[e->copy_map[idx]];
    int64_t t = e->cpkt->dts != AV_NOPTS_VALUE ? e->cpkt->dts : e->cpkt->pts;
    double sec = (t == AV_NOPTS_VALUE)
                     ? 0.0
                     : (t - e->copy_shift[idx]) * av_q2d(in->time_base);
    if (sec > video_time_sec) return 0;  // not due yet; keep pending
    if (e->cpkt->pts != AV_NOPTS_VALUE) e->cpkt->pts -= e->copy_shift[idx];
    if (e->cpkt->dts != AV_NOPTS_VALUE) e->cpkt->dts -= e->copy_shift[idx];
    av_packet_rescale_ts(e->cpkt, in->time_base, out->time_base);
    e->cpkt->stream_index = out->index;
    e->cpkt->pos = -1;
    int rc = av_interleaved_write_frame(e->fmt, e->cpkt);
    e->cpkt_pending = false;
    if (rc < 0) {
      av_packet_unref(e->cpkt);  // consumed only on success
      e->last_error = "stream-copy mux failed: " + av_err_str(rc);
      return -1;
    }
  }
}

// map the copy source's audio/subtitle streams onto output streams; MUST
// run before avformat_write_header (streams are fixed by the header)
void map_copy_streams(WmEncoder *e, const char *copy_from) {
  if (!copy_from || !copy_from[0]) return;
  int rc = avformat_open_input(&e->src, copy_from, nullptr, nullptr);
  if (rc < 0) {
    e->notes += "NOTE: stream-copy source unreadable, writing video only (" +
                av_err_str(rc) + ")\n";
    e->src = nullptr;
    return;
  }
  if (avformat_find_stream_info(e->src, nullptr) < 0) {
    e->notes += "NOTE: stream-copy source has no stream info, writing "
                "video only\n";
    avformat_close_input(&e->src);
    return;
  }
  e->copy_map.assign(e->src->nb_streams, -1);
  e->copy_shift.assign(e->src->nb_streams, 0);
  int mapped = 0;
  for (unsigned i = 0; i < e->src->nb_streams; ++i) {
    AVStream *in = e->src->streams[i];
    auto type = in->codecpar->codec_type;
    if (type != AVMEDIA_TYPE_AUDIO && type != AVMEDIA_TYPE_SUBTITLE) continue;
    const char *tname = av_get_media_type_string(type);
    if (avformat_query_codec(e->fmt->oformat, in->codecpar->codec_id,
                             FF_COMPLIANCE_NORMAL) != 1) {
      e->notes += std::string("NOTE: dropping ") + (tname ? tname : "?") +
                  " stream " + std::to_string(i) +
                  " (codec not supported by the output container)\n";
      continue;
    }
    AVStream *out = avformat_new_stream(e->fmt, nullptr);
    if (!out) continue;
    avcodec_parameters_copy(out->codecpar, in->codecpar);
    out->codecpar->codec_tag = 0;  // let the muxer pick its own tag
    out->time_base = in->time_base;
    e->copy_map[i] = out->index;
    e->copy_shift[i] =
        in->start_time != AV_NOPTS_VALUE ? in->start_time : 0;
    ++mapped;
  }
  if (!mapped) {
    avformat_close_input(&e->src);
  }
}

}  // namespace

// options: "key=value,key=value" codec private/generic AVOptions.
// copy_from (may be NULL): container whose audio/subtitle streams are
// remuxed into the output via stream copy — the in-process equivalent of
// the reference's `-c:s copy -c:a copy -map` ffmpeg child flags
// (main.cpp:287-289). Unmappable/unreadable tracks are dropped with a
// NOTE line retrievable via wme_notes().
extern "C" void *wme_open(const char *path, int width, int height,
                          double fps, const char *codec_name,
                          const char *options, const char *copy_from,
                          char *err, int errlen) {
  auto *e = new WmEncoder();
  e->width = width;
  e->height = height;
  int rc = avformat_alloc_output_context2(&e->fmt, nullptr, nullptr, path);
  if (rc < 0 || !e->fmt) {
    set_err(err, errlen,
            "No muxer for output path (try .mkv/.avi/.mp4): " +
                av_err_str(rc));
    delete e;
    return nullptr;
  }
  const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
  if (!codec) {
    set_err(err, errlen,
            std::string("Encoder '") + codec_name + "' not available");
    avformat_free_context(e->fmt);
    e->fmt = nullptr;
    delete e;
    return nullptr;
  }
  e->ctx = avcodec_alloc_context3(codec);
  e->ctx->width = width;
  e->ctx->height = height;
  e->ctx->pix_fmt = AV_PIX_FMT_YUV420P;
  AVRational rate = av_d2q(fps > 0 ? fps : 30.0, 1 << 16);
  e->ctx->time_base = av_inv_q(rate);
  e->ctx->framerate = rate;
  e->ctx->gop_size = 12;
  if (e->fmt->oformat->flags & AVFMT_GLOBALHEADER) {
    e->ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  }
  AVDictionary *opts = nullptr;
  if (options && options[0]) {
    av_dict_parse_string(&opts, options, "=", ",", 0);
  }
  rc = avcodec_open2(e->ctx, codec, &opts);
  av_dict_free(&opts);
  if (rc < 0) {
    set_err(err, errlen, "Could not open encoder: " + av_err_str(rc));
    free_encoder(e);
    return nullptr;
  }
  e->stream = avformat_new_stream(e->fmt, nullptr);
  if (!e->stream) {
    set_err(err, errlen, "Could not allocate output stream");
    free_encoder(e);
    return nullptr;
  }
  avcodec_parameters_from_context(e->stream->codecpar, e->ctx);
  e->stream->time_base = e->ctx->time_base;
  map_copy_streams(e, copy_from);  // before the header fixes the streams
  rc = avio_open(&e->fmt->pb, path, AVIO_FLAG_WRITE);
  if (rc < 0) {
    set_err(err, errlen, "Could not open output file: " + av_err_str(rc));
    free_encoder(e);
    return nullptr;
  }
  rc = avformat_write_header(e->fmt, nullptr);
  if (rc < 0) {
    set_err(err, errlen, "Could not write header: " + av_err_str(rc));
    free_encoder(e);
    return nullptr;
  }
  e->header_written = true;
  e->pkt = av_packet_alloc();
  e->cpkt = av_packet_alloc();
  e->frame = av_frame_alloc();
  e->frame->format = AV_PIX_FMT_YUV420P;
  e->frame->width = width;
  e->frame->height = height;
  av_frame_get_buffer(e->frame, 0);
  return e;
}

extern "C" const char *wme_error(void *h) {
  return static_cast<WmEncoder *>(h)->last_error.c_str();
}

// src: packed yuv420p (w*h luma + 2 quarter chroma). 0 ok, -1 error.
extern "C" int wme_write(void *handle, const unsigned char *src) {
  auto *e = static_cast<WmEncoder *>(handle);
  int rc = av_frame_make_writable(e->frame);
  if (rc < 0) {
    e->last_error = "frame not writable: " + av_err_str(rc);
    return -1;
  }
  const int w = e->width, h = e->height;
  const uint8_t *src_planes[4] = {src, src + w * h,
                                  src + w * h + (w / 2) * (h / 2), nullptr};
  int src_lines[4] = {w, w / 2, w / 2, 0};
  av_image_copy(e->frame->data, e->frame->linesize, src_planes, src_lines,
                AV_PIX_FMT_YUV420P, w, h);
  e->frame->pts = e->next_pts++;
  rc = avcodec_send_frame(e->ctx, e->frame);
  if (rc < 0) {
    e->last_error = "send frame failed: " + av_err_str(rc);
    return -1;
  }
  if (drain_packets(e) < 0) return -1;
  // keep copied audio/subtitle packets flowing alongside the video clock
  return copy_until(e, e->next_pts * av_q2d(e->ctx->time_base));
}

extern "C" int wme_close(void *handle) {
  auto *e = static_cast<WmEncoder *>(handle);
  if (!e) return 0;
  int result = 0;
  if (e->ctx && e->header_written) {
    avcodec_send_frame(e->ctx, nullptr);  // flush
    result = drain_packets(e);
    // drain the remaining copied streams fully (audio commonly outlasts
    // the last video frame; the ffmpeg child copies it all too)
    if (copy_until(e, HUGE_VAL) < 0 && result == 0) result = -1;
    int rc = av_write_trailer(e->fmt);
    if (rc < 0 && result == 0) result = -1;
  }
  free_encoder(e);
  return result;
}

// NOTE lines for tracks the stream-copy passthrough dropped ("" if none)
extern "C" const char *wme_notes(void *h) {
  return static_cast<WmEncoder *>(h)->notes.c_str();
}

// encoder availability probe (Python picks ffv1 -> mpeg4 fallbacks)
extern "C" int wme_codec_available(const char *name) {
  return avcodec_find_encoder_by_name(name) != nullptr;
}

// test/tooling probe: number of streams of `media_type` (AVMediaType:
// 0 video, 1 audio, 3 subtitle) in a container; -1 if unreadable
extern "C" int wmt_stream_count(const char *path, int media_type) {
  AVFormatContext *f = nullptr;
  if (avformat_open_input(&f, path, nullptr, nullptr) < 0) return -1;
  avformat_find_stream_info(f, nullptr);
  int n = 0;
  for (unsigned i = 0; i < f->nb_streams; ++i) {
    if (f->streams[i]->codecpar->codec_type == media_type) ++n;
  }
  avformat_close_input(&f);
  return n;
}
