// Native HEVC video codec bridge for tpu_vpcc_torch.
//
// Decodes Annex-B HEVC (H.265) bytestreams from memory via libavcodec —
// no tempfile detour (the reference tmc2-rs writes the bytestream to a
// NamedTempFile before handing it to ffmpeg, src/decoder.rs:1098-1104;
// here packets are parsed and fed straight from the caller's buffer).
// Also exposes an encoder (libx265 via libavcodec) used to author test
// fixtures and as an encode-side capability.
//
// Plain C ABI for ctypes binding; no pybind11 dependency.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
}

namespace {

struct Plane {
  std::vector<uint8_t> data;  // tightly packed, no stride padding
  int width = 0;
  int height = 0;
  int bytes_per_sample = 1;
};

struct Frame {
  Plane planes[3];
  int width = 0;
  int height = 0;
  int bit_depth = 8;
  int chroma_w_shift = 1;  // 4:2:0
  int chroma_h_shift = 1;
  int is_rgb = 0;  // GBR-family pixel format (AV_PIX_FMT_FLAG_RGB)
};

struct DecoderCtx {
  const AVCodec* codec = nullptr;
  AVCodecContext* ctx = nullptr;
  AVCodecParserContext* parser = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  std::vector<Frame> frames;
  std::string error;
  // frees partially-constructed contexts too (open-failure paths)
  ~DecoderCtx() {
    if (parser) av_parser_close(parser);
    if (ctx) avcodec_free_context(&ctx);
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
  }
};

void copy_frame(DecoderCtx* d, const AVFrame* src) {
  Frame out;
  out.width = src->width;
  out.height = src->height;
  const AVPixFmtDescriptor* desc =
      av_pix_fmt_desc_get(static_cast<AVPixelFormat>(src->format));
  out.bit_depth = desc->comp[0].depth;
  out.chroma_w_shift = desc->log2_chroma_w;
  out.chroma_h_shift = desc->log2_chroma_h;
  out.is_rgb = (desc->flags & AV_PIX_FMT_FLAG_RGB) ? 1 : 0;
  int bps = out.bit_depth > 8 ? 2 : 1;
  for (int p = 0; p < 3; ++p) {
    int w = p == 0 ? src->width : (src->width >> out.chroma_w_shift);
    int h = p == 0 ? src->height : (src->height >> out.chroma_h_shift);
    Plane& plane = out.planes[p];
    plane.width = w;
    plane.height = h;
    plane.bytes_per_sample = bps;
    plane.data.resize(static_cast<size_t>(w) * h * bps);
    if (!src->data[p]) {
      // monochrome (4:0:0) output has no chroma planes; emit zeros so
      // the Python side always sees three planes
      std::fill(plane.data.begin(), plane.data.end(), 0);
      continue;
    }
    for (int y = 0; y < h; ++y) {
      std::memcpy(plane.data.data() + static_cast<size_t>(y) * w * bps,
                  src->data[p] + static_cast<size_t>(y) * src->linesize[p],
                  static_cast<size_t>(w) * bps);
    }
  }
  d->frames.push_back(std::move(out));
}

int drain_frames(DecoderCtx* d) {
  while (true) {
    int ret = avcodec_receive_frame(d->ctx, d->frame);
    if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
    if (ret < 0) {
      d->error = "avcodec_receive_frame failed";
      return ret;
    }
    copy_frame(d, d->frame);
  }
}

}  // namespace

extern "C" {

// codec_id: 0 = H264, 1 = H265/HEVC (the only id emitted by rec0 streams,
// reference src/decoder.rs:899-910), 2 = H266/VVC (not present in ffmpeg5).
// thread_count: 0 = auto (one thread per core); explicit counts let tests
// assert the frame-threading request on single-core hosts too.
void* vdec_open_threads(int codec_id, int thread_count) {
  auto* d = new DecoderCtx();
  AVCodecID av_id = codec_id == 0 ? AV_CODEC_ID_H264 : AV_CODEC_ID_HEVC;
  d->codec = avcodec_find_decoder(av_id);
  if (!d->codec) {
    delete d;
    return nullptr;
  }
  d->ctx = avcodec_alloc_context3(d->codec);
  d->parser = av_parser_init(av_id);
  d->pkt = av_packet_alloc();
  d->frame = av_frame_alloc();
  if (!d->ctx || !d->parser || !d->pkt || !d->frame) {
    delete d;
    return nullptr;
  }
  // Frame+slice threading must be configured BEFORE avcodec_open2.
  d->ctx->thread_count = thread_count;
  d->ctx->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
  if (avcodec_open2(d->ctx, d->codec, nullptr) < 0) {
    delete d;
    return nullptr;
  }
  return d;
}

void* vdec_open(int codec_id) { return vdec_open_threads(codec_id, 0); }

// Post-open threading configuration actually in effect:
// info[0] = resolved thread_count, info[1] = active_thread_type bits
// (1 = frame threading, 2 = slice threading).
int vdec_thread_info(void* handle, int* info) {
  auto* d = static_cast<DecoderCtx*>(handle);
  if (!d->ctx) return -1;
  info[0] = d->ctx->thread_count;
  info[1] = d->ctx->active_thread_type;
  return 0;
}

// Feed a whole Annex-B bytestream; parses NALUs into packets and decodes.
// Returns 0 on success.
int vdec_decode(void* handle, const uint8_t* data, int64_t size) {
  auto* d = static_cast<DecoderCtx*>(handle);
  const uint8_t* cur = data;
  int64_t remaining = size;
  while (remaining > 0) {
    uint8_t* out_data = nullptr;
    int out_size = 0;
    // feed bounded chunks: av_parser_parse2 takes an int size, so a
    // > 2 GiB stream must not be passed in one call
    int chunk = static_cast<int>(
        remaining < (int64_t{1} << 20) ? remaining : (int64_t{1} << 20));
    int used = av_parser_parse2(d->parser, d->ctx, &out_data, &out_size, cur,
                                chunk, AV_NOPTS_VALUE,
                                AV_NOPTS_VALUE, 0);
    if (used < 0) {
      d->error = "av_parser_parse2 failed";
      return -1;
    }
    cur += used;
    remaining -= used;
    if (out_size > 0) {
      d->pkt->data = out_data;
      d->pkt->size = out_size;
      if (avcodec_send_packet(d->ctx, d->pkt) < 0) {
        d->error = "avcodec_send_packet failed";
        return -2;
      }
      int ret = drain_frames(d);
      if (ret < 0) return ret;
    }
  }
  // Flush the parser (signal EOF) to emit the final packet.
  while (true) {
    uint8_t* out_data = nullptr;
    int out_size = 0;
    int used = av_parser_parse2(d->parser, d->ctx, &out_data, &out_size,
                                nullptr, 0, AV_NOPTS_VALUE, AV_NOPTS_VALUE, 0);
    if (out_size > 0) {
      d->pkt->data = out_data;
      d->pkt->size = out_size;
      if (avcodec_send_packet(d->ctx, d->pkt) < 0) {
        d->error = "avcodec_send_packet (flush) failed";
        return -2;
      }
      int ret = drain_frames(d);
      if (ret < 0) return ret;
    }
    if (used <= 0 && out_size <= 0) break;
  }
  // Flush the decoder.
  avcodec_send_packet(d->ctx, nullptr);
  return drain_frames(d);
}

int vdec_frame_count(void* handle) {
  return static_cast<int>(static_cast<DecoderCtx*>(handle)->frames.size());
}

// info[0]=width, info[1]=height, info[2]=bit_depth,
// info[3]=chroma_w_shift, info[4]=chroma_h_shift, info[5]=is_rgb
int vdec_frame_info(void* handle, int index, int* info) {
  auto* d = static_cast<DecoderCtx*>(handle);
  if (index < 0 || index >= static_cast<int>(d->frames.size())) return -1;
  const Frame& f = d->frames[index];
  info[0] = f.width;
  info[1] = f.height;
  info[2] = f.bit_depth;
  info[3] = f.chroma_w_shift;
  info[4] = f.chroma_h_shift;
  info[5] = f.is_rgb;
  return 0;
}

// Copies the tightly packed plane (native-endian u16 when bit_depth > 8,
// matching the reference's Image<u16> from_ne_bytes reads,
// src/decoder.rs:1009-1021). Returns the byte size copied, or <0 on error.
int64_t vdec_copy_plane(void* handle, int index, int plane, uint8_t* dst,
                        int64_t dst_size) {
  auto* d = static_cast<DecoderCtx*>(handle);
  if (index < 0 || index >= static_cast<int>(d->frames.size())) return -1;
  if (plane < 0 || plane > 2) return -2;
  const Plane& p = d->frames[index].planes[plane];
  int64_t n = static_cast<int64_t>(p.data.size());
  if (dst_size < n) return -3;
  std::memcpy(dst, p.data.data(), n);
  return n;
}

// Copies the plane in block-tiled layout: dst is [n_blocks, tile, tile]
// with blocks in row-major order — the layout the TPU reconstruction
// kernels consume directly (contiguous per-block rows). Width/height must
// be multiples of tile. Returns bytes copied or <0 on error.
int64_t vdec_copy_plane_tiled(void* handle, int index, int plane, int tile,
                              uint8_t* dst, int64_t dst_size) {
  auto* d = static_cast<DecoderCtx*>(handle);
  if (index < 0 || index >= static_cast<int>(d->frames.size())) return -1;
  if (plane < 0 || plane > 2) return -2;
  const Plane& p = d->frames[index].planes[plane];
  if (tile <= 0 || p.width % tile != 0 || p.height % tile != 0) return -4;
  int bps = p.bytes_per_sample;
  int bw = p.width / tile;
  int bh = p.height / tile;
  int64_t n = static_cast<int64_t>(p.data.size());
  if (dst_size < n) return -3;
  size_t tile_row = static_cast<size_t>(tile) * bps;
  size_t tile_bytes = tile_row * tile;
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bw; ++bx) {
      uint8_t* out = dst + (static_cast<size_t>(by) * bw + bx) * tile_bytes;
      const uint8_t* src = p.data.data() +
                           (static_cast<size_t>(by) * tile * p.width +
                            static_cast<size_t>(bx) * tile) *
                               bps;
      for (int r = 0; r < tile; ++r) {
        std::memcpy(out + static_cast<size_t>(r) * tile_row,
                    src + static_cast<size_t>(r) * p.width * bps, tile_row);
      }
    }
  }
  return n;
}

const char* vdec_error(void* handle) {
  return static_cast<DecoderCtx*>(handle)->error.c_str();
}

void vdec_close(void* handle) {
  delete static_cast<DecoderCtx*>(handle);  // dtor frees libav members
}

// ---------------------------------------------------------------------------
// Encoder (libx265) — fixture generation / encode-side capability.
// ---------------------------------------------------------------------------

struct EncoderCtx {
  const AVCodec* codec = nullptr;
  AVCodecContext* ctx = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  std::vector<uint8_t> out;  // Annex-B bytestream
  int64_t pts = 0;
  std::string error;
  ~EncoderCtx() {
    if (ctx) avcodec_free_context(&ctx);
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
  }
};

// bit_depth: 8 or 10. lossless: x265 lossless mode (needed for the
// occupancy/geometry fixtures where decoded planes must equal the input).
// Returns nullptr if the encoder or the pixel format is unavailable.
// chroma_mode: 0 = 4:2:0 (the rec0 default), 1 = 4:4:4 full-res chroma,
// 2 = 4:2:2 (half-width chroma).
void* venc_open(int width, int height, int bit_depth, int lossless, int gop,
                int qp, int chroma_mode) {
  auto* e = new EncoderCtx();
  e->codec = avcodec_find_encoder_by_name("libx265");
  if (!e->codec) {
    delete e;
    return nullptr;
  }
  AVPixelFormat fmt =
      chroma_mode == 1
          ? (bit_depth > 8 ? AV_PIX_FMT_YUV444P10LE : AV_PIX_FMT_YUV444P)
      : chroma_mode == 2
          ? (bit_depth > 8 ? AV_PIX_FMT_YUV422P10LE : AV_PIX_FMT_YUV422P)
          : (bit_depth > 8 ? AV_PIX_FMT_YUV420P10LE : AV_PIX_FMT_YUV420P);
  bool supported = false;
  for (const AVPixelFormat* p = e->codec->pix_fmts;
       p && *p != AV_PIX_FMT_NONE; ++p) {
    if (*p == fmt) supported = true;
  }
  if (!supported) {
    delete e;
    return nullptr;
  }
  e->ctx = avcodec_alloc_context3(e->codec);
  if (!e->ctx) {
    delete e;
    return nullptr;
  }
  e->ctx->width = width;
  e->ctx->height = height;
  e->ctx->time_base = {1, 30};
  e->ctx->framerate = {30, 1};
  e->ctx->pix_fmt = fmt;
  e->ctx->gop_size = gop;
  e->ctx->max_b_frames = 0;
  // frame-threads=1 makes the emitted bitstream deterministic: with
  // multiple frame threads x265's rate/CABAC bookkeeping varies with
  // thread timing and can occasionally append trailing cabac_zero_words
  // to a NALU, which an Annex-B start-code scan then splits differently
  // run-to-run (observed as a rare fixture-roundtrip flake)
  std::string params = "log-level=none:annexb=1:frame-threads=1";
  if (lossless) params += ":lossless=1";
  else params += ":qp=" + std::to_string(qp);
  av_opt_set(e->ctx->priv_data, "x265-params", params.c_str(), 0);
  av_opt_set(e->ctx->priv_data, "preset", "fast", 0);
  if (avcodec_open2(e->ctx, e->codec, nullptr) < 0) {
    delete e;
    return nullptr;
  }
  e->pkt = av_packet_alloc();
  e->frame = av_frame_alloc();
  if (!e->pkt || !e->frame) {
    delete e;
    return nullptr;
  }
  e->frame->format = fmt;
  e->frame->width = width;
  e->frame->height = height;
  if (av_frame_get_buffer(e->frame, 0) < 0) {
    delete e;
    return nullptr;
  }
  return e;
}

namespace {
int venc_drain(EncoderCtx* e) {
  while (true) {
    int ret = avcodec_receive_packet(e->ctx, e->pkt);
    if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
    if (ret < 0) {
      e->error = "avcodec_receive_packet failed";
      return ret;
    }
    e->out.insert(e->out.end(), e->pkt->data, e->pkt->data + e->pkt->size);
    av_packet_unref(e->pkt);
  }
}
}  // namespace

// Planes are tightly packed y, u, v (u16 native-endian when bit_depth=10).
int venc_encode_frame(void* handle, const uint8_t* y, const uint8_t* u,
                      const uint8_t* v) {
  auto* e = static_cast<EncoderCtx*>(handle);
  if (av_frame_make_writable(e->frame) < 0) return -1;
  const AVPixFmtDescriptor* desc = av_pix_fmt_desc_get(e->ctx->pix_fmt);
  int bps = desc->comp[0].depth > 8 ? 2 : 1;
  int w = e->ctx->width, h = e->ctx->height;
  const uint8_t* srcs[3] = {y, u, v};
  for (int p = 0; p < 3; ++p) {
    int pw = p == 0 ? w : (w >> desc->log2_chroma_w);
    int ph = p == 0 ? h : (h >> desc->log2_chroma_h);
    for (int row = 0; row < ph; ++row) {
      std::memcpy(e->frame->data[p] +
                      static_cast<size_t>(row) * e->frame->linesize[p],
                  srcs[p] + static_cast<size_t>(row) * pw * bps,
                  static_cast<size_t>(pw) * bps);
    }
  }
  e->frame->pts = e->pts++;
  if (avcodec_send_frame(e->ctx, e->frame) < 0) {
    e->error = "avcodec_send_frame failed";
    return -2;
  }
  return venc_drain(e);
}

int venc_flush(void* handle) {
  auto* e = static_cast<EncoderCtx*>(handle);
  avcodec_send_frame(e->ctx, nullptr);
  return venc_drain(e);
}

int64_t venc_output_size(void* handle) {
  return static_cast<int64_t>(static_cast<EncoderCtx*>(handle)->out.size());
}

int64_t venc_copy_output(void* handle, uint8_t* dst, int64_t dst_size) {
  auto* e = static_cast<EncoderCtx*>(handle);
  int64_t n = static_cast<int64_t>(e->out.size());
  if (dst_size < n) return -1;
  std::memcpy(dst, e->out.data(), n);
  return n;
}

const char* venc_error(void* handle) {
  return static_cast<EncoderCtx*>(handle)->error.c_str();
}

void venc_close(void* handle) {
  delete static_cast<EncoderCtx*>(handle);  // dtor frees libav members
}

// ---------------------------------------------------------------------------
// Fast ASCII PLY body formatting (the Python np.savetxt path is ~2.7s per
// million points; this is ~30ms). Output lines match the reference writer
// byte-for-byte: "x y z[ r g b]\n" (src/writer.rs:61-74).
// ---------------------------------------------------------------------------

namespace {
inline char* write_uint(char* p, uint32_t v) {
  char tmp[8];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}
}  // namespace

// positions: n x 3 u16; colors: n x 3 u8 (may be null). Returns bytes
// written, or -1 if out_cap is too small.
int64_t ply_format_body(const uint16_t* positions, const uint8_t* colors,
                        int64_t n, char* out, int64_t out_cap) {
  // worst case: 3*5 + 3*3 + 5 separators + newline = 30 bytes per line
  if (out_cap < n * 30) return -1;
  char* p = out;
  for (int64_t i = 0; i < n; ++i) {
    p = write_uint(p, positions[i * 3 + 0]);
    *p++ = ' ';
    p = write_uint(p, positions[i * 3 + 1]);
    *p++ = ' ';
    p = write_uint(p, positions[i * 3 + 2]);
    if (colors) {
      *p++ = ' ';
      p = write_uint(p, colors[i * 3 + 0]);
      *p++ = ' ';
      p = write_uint(p, colors[i * 3 + 1]);
      *p++ = ' ';
      p = write_uint(p, colors[i * 3 + 2]);
    }
    *p++ = '\n';
  }
  return static_cast<int64_t>(p - out);
}

}  // extern "C"
