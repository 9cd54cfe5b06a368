// K5: the device pack of the block-tiled sample planes into the cat.
//
// Replaces what tpu_vpcc runs as fused XLA off the TPU (its default
// there), not a Pallas kernel: tpu_vpcc/ops/tiled.py::_pack_u32_planes
// (:1006), the row-wise concat of _pretiled_gather_megarow (:1127) and
// the orientation fix of _tiles_to_words (:257-274), which transposes the
// SWAP-family tiles after the gather. Here the transpose is folded into
// the pack, so the cat comes out as the host pack writes it
// (pack_planes_host with a swap mask): every tile in patch raster order.
// For frame f, block b and pixel (r, c) of the res x res block:
//   plane A = d0 | d1 << 10 | (occ[f, b, r/prec, c/prec] > 0) << 20
//             (d1 = d0 with one map)
//   plane B = y0 | u0 << 10 | v0 << 20, chroma read at
//             (r >> chroma_shift, c >> chroma_shift)
//   plane C = y1 | u1 << 10 | v1 << 20 (C = B with one map)
//   cat[f, b, k * res^2 + (swap[f, b] ? c * res + r : r * res + c)] = plane k
// The arithmetic is u32, with no masks, as the reference's is.
//
// Bound: memory bytes; a few integer operations a word. It must read
// each plane once (occupancy 1 B a cell, geometry, luma and chroma 2 B a
// sample, the swap mask 1 B a block) and write 12 B a pixel: 72.3 MB for
// a two-frame 1280^2 flagship GOF (33.0 MB read, 39.3 MB written), 0.0216
// ms at 3.35 TB/s, computed from shapes.
//
// Design: a tile of blocks a CTA, staged through shared memory. The grid
// is (ceil(nb / R), F): CTA (x, f) packs blocks x*R .. x*R + R - 1 of
// frame f, R = 4 at res 16 (as many pixels a CTA at other edges), with
// 128 threads. Against what held the first design (one thread a word)
// back:
//   - index math: no 64-bit division. The CTA's offsets are computed once
//     in 64 bits; inside the tile everything is 32-bit, and the kernel is
//     instantiated for res 8, 16 and 32, where the divisions are by
//     constants and prec and the chroma shift are shifts. One generic
//     instantiation reads the edge at run time and takes every other
//     shape (odd edges store a word at a time; edges whose tiles do not
//     fit shared memory together are staged a plane at a time).
//   - loads: each source's R tiles are one contiguous run, loaded with
//     16-byte loads (narrower only where the run's address or length
//     asks for it: 1-byte occupancy tiles at prec = res, a frame slice at
//     an odd offset) into shared rows padded by 4 bytes. Each sample is
//     read from device memory once; chroma and occupancy are upsampled
//     from shared memory, and a flagged block's transposed reads cost no
//     extra device traffic.
//   - stores: a thread builds 4 consecutive words of one row of one plane
//     and writes them with one 16-byte streaming store, so a warp writes
//     512 contiguous bytes. In a flagged block it reads column i of its
//     tiles; the 4-byte row padding keeps those reads free of bank
//     conflicts at res 8, 16 and 32.
// Measured on the H100 against the first design and an in-place register
// design without shared memory (PERF.md, section 6, K5's redesign). ptxas:
// 32 registers at res 8, 16 and 32, 36 in the generic instantiation, no
// spills; 64 B of static shared memory, and R tiles of each source in
// dynamic shared memory (11,840 B a CTA at the flagship's res 16, prec 4,
// 4:2:0, two maps). Every word of the output is written, with no atomics:
// two calls on one input give the same bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;         // threads a CTA
constexpr int kPixels = 4 * 16 * 16;  // pixels a CTA packs: R = 4 at res 16
constexpr int kMaxBlocks = 64;        // most blocks a CTA takes
constexpr int kRowPad = 4;            // bytes after each shared row of samples
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemOptIn = 232448;

// The sources of the three planes. Plane A reads G0, G1 and OC; plane B
// Y0, U0 and V0; plane C Y1, U1 and V1 (plane B's with one map).
enum { G0, G1, OC, Y0, U0, V0, Y1, U1, V1, kSrc };

struct Source {
  const uint8_t* base;  // tile 0 of the array
  int64_t fstride;      // tiles a frame (nb, or maps * nb for colour)
  int64_t moff;         // tiles before this map's (m * nb)
  int esz;              // bytes a sample: 2, or 1 for occupancy
  int edge;             // tile edge in samples
  int ledge;            // log2(edge), or -1 where edge is no power of two
  int pitch;            // shared bytes a row
  int ts;               // shared bytes a tile
  int off;              // shared offset of the source's region
  int used;
};

struct PackParams {
  Source src[kSrc];
  const uint8_t* swap;
  int64_t nb;       // blocks a frame
  int res;          // block edge
  int prec, lprec;  // occupancy precision; log2 of it or -1
  int cs;           // chroma shift
  int two;          // two maps
  int R;            // blocks a CTA
  int passes;       // 1: all sources staged at once; 3: a plane at a time
  int vec_out;      // 16-byte stores (words a block a multiple of 4)
};

__device__ __forceinline__ int dv(int x, int d, int l) {
  return l >= 0 ? x >> l : x / d;
}

// Shared bytes a tile and a row, by kind of tile.
struct Lay {
  int tsS, piS;  // geometry and luma
  int tsC, piC;  // chroma
  int tsO, piO;  // occupancy
};

__device__ __forceinline__ uint32_t ld16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four samples of a shared row from p on (4-byte aligned).
__device__ __forceinline__ void row4(const uint8_t* p, uint32_t* s) {
  const uint32_t a = ld32(p), b = ld32(p + 4);
  s[0] = a & 0xFFFFu;
  s[1] = a >> 16;
  s[2] = b & 0xFFFFu;
  s[3] = b >> 16;
}

// stage() for any run: loads of W bytes (the run's alignment), stores of
// 4 bytes where rows are whole words, else a sample at a time.
template <int ESZ>
__device__ __noinline__ void stage_any(const uint8_t* __restrict__ g,
                                       int nbytes, uint8_t* s, int edge,
                                       int ledge, int pitch, int ts, int W) {
  const int rb = ESZ * edge;
  const int tb = rb * edge;
  const int lrb = ledge >= 0 ? ledge + (ESZ == 2 ? 1 : 0) : -1;
  const int ltb = ledge >= 0 ? 2 * ledge + (ESZ == 2 ? 1 : 0) : -1;
  const int lw = __ffs(W) - 1;
  const bool words = W >= 4 && (rb & 3) == 0;
  const int nv = nbytes >> lw;
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const uint8_t* a = g + (static_cast<size_t>(v) << lw);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (W == 16) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(a));
      w[0] = t.x;
      w[1] = t.y;
      w[2] = t.z;
      w[3] = t.w;
    } else if (W == 8) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(a));
      w[0] = t.x;
      w[1] = t.y;
    } else if (W == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(a));
    } else if (W == 2) {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(a));
    } else {
      w[0] = __ldg(a);
    }
    const int o = v << lw;
    if (words) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (4 * q < W) {
          const int e = o + 4 * q;
          const int blk = dv(e, tb, ltb);
          const int in = e - blk * tb;
          const int row = dv(in, rb, lrb);
          *reinterpret_cast<uint32_t*>(s + blk * ts + row * pitch + in -
                                       row * rb) = w[q];
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 16 / ESZ; ++q) {
        if (ESZ * q < W) {
          const int e = o + ESZ * q;
          const int blk = dv(e, tb, ltb);
          const int in = e - blk * tb;
          const int row = dv(in, rb, lrb);
          uint8_t* d = s + blk * ts + row * pitch + in - row * rb;
          const uint32_t word = w[(ESZ * q) >> 2];
          if (ESZ == 2) {
            *reinterpret_cast<uint16_t*>(d) =
                static_cast<uint16_t>(word >> (8 * ((2 * q) & 3)));
          } else {
            *d = static_cast<uint8_t>(word >> (8 * (q & 3)));
          }
        }
      }
    }
  }
}

// Stage `nbytes` of tiles from device memory at g into shared memory at s,
// a tile every ts bytes, a row every pitch bytes. The load width is the
// largest power of two, at most 16, that divides g's address and nbytes:
// 16 on the main path, where each 16-byte load goes to shared memory as
// four 4-byte stores.
template <int ESZ>
__device__ __forceinline__ void stage(const uint8_t* __restrict__ g,
                                      int nbytes, uint8_t* s, int edge,
                                      int ledge, int pitch, int ts) {
  const unsigned x =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(g)) |
      static_cast<unsigned>(nbytes) | 16u;
  const int W = static_cast<int>(x & (0u - x));
  const int rb = ESZ * edge;
  if (W == 16 && ledge >= 0 && (rb & 3) == 0) {
    const int lrb = ledge + (ESZ == 2 ? 1 : 0);
    const int ltb = 2 * ledge + (ESZ == 2 ? 1 : 0);
    for (int v = threadIdx.x; v < (nbytes >> 4); v += blockDim.x) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(g) + v);
      const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = (v << 4) + 4 * q;
        const int blk = e >> ltb;
        const int in = e - (blk << ltb);
        const int row = in >> lrb;
        *reinterpret_cast<uint32_t*>(s + blk * ts + row * pitch + in -
                                     (row << lrb)) = w[q];
      }
    }
  } else {
    stage_any<ESZ>(g, nbytes, s, edge, ledge, pitch, ts, W);
  }
}

// One word of plane k at pixel (r, c) of staged block lb. a, b, c0: the
// plane's three sources (k = 0: d0, d1, occupancy; else y, u, v).
__device__ __forceinline__ uint32_t word_at(const uint8_t* a,
                                            const uint8_t* b,
                                            const uint8_t* c0, const Lay& L,
                                            const PackParams& P, int k,
                                            int lb, int r, int c) {
  const int sa = lb * L.tsS + r * L.piS + 2 * c;
  const uint32_t x = ld16(a + sa);
  if (k == 0) {
    const uint32_t d1 = ld16(b + sa);
    const int orr = dv(r, P.prec, P.lprec), occ = dv(c, P.prec, P.lprec);
    const uint32_t on = c0[lb * L.tsO + orr * L.piO + occ] != 0;
    return x | (d1 << 10) | (on << 20);
  }
  const int sc = lb * L.tsC + (r >> P.cs) * L.piC + 2 * (c >> P.cs);
  return x | (ld16(b + sc) << 10) | (ld16(c0 + sc) << 20);
}

// The four words (i, j .. j + 3) of plane k of staged block lb, res a
// multiple of 4: a flagged block reads them down column i of its tiles.
__device__ __forceinline__ uint4 quad_at(const uint8_t* a, const uint8_t* b,
                                         const uint8_t* c0, const Lay& L,
                                         const PackParams& P, int k, int lb,
                                         int i, int j, bool flip) {
  uint32_t s0[4], s1[4], s2[4];
  const uint8_t* ta = a + lb * L.tsS;
  if (!flip) {
    row4(ta + i * L.piS + 2 * j, s0);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) s0[u] = ld16(ta + (j + u) * L.piS + 2 * i);
  }
  if (k == 0) {
    const uint8_t* tb = b + lb * L.tsS;
    if (!flip) {
      row4(tb + i * L.piS + 2 * j, s1);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) s1[u] = ld16(tb + (j + u) * L.piS + 2 * i);
    }
    const uint8_t* to = c0 + lb * L.tsO;
    if (P.lprec >= 2) {  // the four pixels share one occupancy cell
      const int x = i >> P.lprec, y = j >> P.lprec;
      const uint32_t on = to[(flip ? y : x) * L.piO + (flip ? x : y)] != 0;
      s2[0] = s2[1] = s2[2] = s2[3] = on;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int x = i >> P.lprec, y = (j + u) >> P.lprec;
        s2[u] = to[(flip ? y : x) * L.piO + (flip ? x : y)] != 0;
      }
    }
  } else {
    const uint8_t* tu = b + lb * L.tsC;
    const uint8_t* tv = c0 + lb * L.tsC;
    if (P.cs) {  // two chroma samples, each for two pixels
      uint32_t u0, u1, v0, v1;
      const int x = i >> 1, y = j >> 1;
      if (!flip) {
        const uint32_t cu = ld32(tu + x * L.piC + j);
        const uint32_t cv = ld32(tv + x * L.piC + j);
        u0 = cu & 0xFFFFu;
        u1 = cu >> 16;
        v0 = cv & 0xFFFFu;
        v1 = cv >> 16;
      } else {
        u0 = ld16(tu + y * L.piC + 2 * x);
        u1 = ld16(tu + (y + 1) * L.piC + 2 * x);
        v0 = ld16(tv + y * L.piC + 2 * x);
        v1 = ld16(tv + (y + 1) * L.piC + 2 * x);
      }
      s1[0] = s1[1] = u0;
      s1[2] = s1[3] = u1;
      s2[0] = s2[1] = v0;
      s2[2] = s2[3] = v1;
    } else if (!flip) {
      row4(tu + i * L.piC + 2 * j, s1);
      row4(tv + i * L.piC + 2 * j, s2);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s1[u] = ld16(tu + (j + u) * L.piC + 2 * i);
        s2[u] = ld16(tv + (j + u) * L.piC + 2 * i);
      }
    }
  }
  return make_uint4(s0[0] | (s1[0] << 10) | (s2[0] << 20),
                    s0[1] | (s1[1] << 10) | (s2[1] << 20),
                    s0[2] | (s1[2] << 10) | (s2[2] << 20),
                    s0[3] | (s1[3] << 10) | (s2[3] << 20));
}

// RES: the block edge (8, 16, 32), or 0 for any other (read at run time).
// Grid (ceil(nb / R), F): CTA (x, f) packs blocks x*R .. x*R + R - 1 of
// frame f.
template <int RES>
__global__ void __launch_bounds__(kThreads)
pack_tiles_kernel(const PackParams P, uint32_t* __restrict__ cat) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ uint8_t flips[kMaxBlocks];
  const int res = RES ? RES : P.res;
  const int t2 = res * res;
  const int wpb = 3 * t2;  // words a block
  const int64_t f = blockIdx.y;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * P.R;
  const int n = static_cast<int>(
      P.nb - b0 < static_cast<int64_t>(P.R) ? P.nb - b0 : P.R);
  const int64_t row = f * P.nb + b0;

  const uint8_t* p[kSrc];  // each source's first staged tile
#pragma unroll
  for (int s = 0; s < kSrc; ++s) p[s] = sm + P.src[s].off;
  const Lay L{P.src[G0].ts, P.src[G0].pitch, P.src[U0].ts,
              P.src[U0].pitch, P.src[OC].ts, P.src[OC].pitch};
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    flips[t] = __ldg(P.swap + row + t);
  }
  uint32_t* out = cat + row * wpb;
  // plane C reads map 1 with two maps, else map 0 as plane B does
  const uint8_t* pA1 = P.two ? p[G1] : p[G0];
  const uint8_t* pCY = P.two ? p[Y1] : p[Y0];
  const uint8_t* pCU = P.two ? p[U1] : p[U0];
  const uint8_t* pCV = P.two ? p[V1] : p[V0];

  for (int pass = 0; pass < P.passes; ++pass) {
    const int k0 = P.passes == 1 ? 0 : pass;
    const int nk = P.passes == 1 ? 3 : 1;
    if (pass) __syncthreads();  // the previous plane is emitted
#pragma unroll
    for (int s = 0; s < kSrc; ++s) {
      const Source& S = P.src[s];
      const int plane = s <= OC ? 0 : s <= V0 ? 1 : 2;
      const bool want = S.used && (P.passes == 1 || plane == pass ||
                                   (pass == 2 && !P.two && plane == 1));
      if (!want) continue;
      const int tb = S.esz * S.edge * S.edge;
      const uint8_t* g =
          S.base + (f * S.fstride + S.moff + b0) * static_cast<int64_t>(tb);
      if (S.esz == 2) {
        stage<2>(g, n * tb, sm + S.off, S.edge, S.ledge, S.pitch, S.ts);
      } else {
        stage<1>(g, n * tb, sm + S.off, S.edge, S.ledge, S.pitch, S.ts);
      }
    }
    __syncthreads();
    if constexpr (RES != 0) {
      // a quad of words a thread: 4 pixels of one row of one plane
      constexpr int QR = RES / 4;   // quads a row
      constexpr int QP = QR * RES;  // quads a plane
      constexpr int QB = 3 * QP;    // quads a block
      for (int q = threadIdx.x; q < n * QB; q += blockDim.x) {
        const int lb = q / QB;
        const int rem = q - lb * QB;
        const int k = rem / QP;
        const int p4 = rem - k * QP;
        const int i = p4 / QR;
        const int j = (p4 - i * QR) * 4;
        const uint8_t* a = k == 0 ? p[G0] : k == 1 ? p[Y0] : pCY;
        const uint8_t* b = k == 0 ? pA1 : k == 1 ? p[U0] : pCU;
        const uint8_t* c = k == 0 ? p[OC] : k == 1 ? p[V0] : pCV;
        __stcs(reinterpret_cast<uint4*>(out) + q,
               quad_at(a, b, c, L, P, k, lb, i, j, flips[lb] != 0));
      }
    } else if (P.vec_out) {
      // a quad of words a thread, each word located on its own (the
      // generic instantiation)
      const int qk = (nk * t2) >> 2;  // quads of this pass a block
      for (int q = threadIdx.x; q < n * qk; q += blockDim.x) {
        const int lb = q / qk;
        const int w0 = (q - lb * qk) * 4 + k0 * t2;  // word in the block
        const bool flip = flips[lb] != 0;
        uint32_t w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = (w0 + u) / t2;
          const int px = w0 + u - k * t2;
          const int i = px / res, j = px - i * res;
          const uint8_t* a = k == 0 ? p[G0] : k == 1 ? p[Y0] : pCY;
          const uint8_t* b = k == 0 ? pA1 : k == 1 ? p[U0] : pCU;
          const uint8_t* c = k == 0 ? p[OC] : k == 1 ? p[V0] : pCV;
          w[u] = word_at(a, b, c, L, P, k, lb, flip ? j : i, flip ? i : j);
        }
        __stcs(reinterpret_cast<uint4*>(out + lb * wpb + w0),
               make_uint4(w[0], w[1], w[2], w[3]));
      }
    } else {
      // odd edges: a word a thread
      const int wk = nk * t2;
      for (int q = threadIdx.x; q < n * wk; q += blockDim.x) {
        const int lb = q / wk;
        const int w0 = q - lb * wk + k0 * t2;
        const int k = w0 / t2;
        const int px = w0 - k * t2;
        const int i = px / res, j = px - i * res;
        const bool flip = flips[lb] != 0;
        const uint8_t* a = k == 0 ? p[G0] : k == 1 ? p[Y0] : pCY;
        const uint8_t* b = k == 0 ? pA1 : k == 1 ? p[U0] : pCU;
        const uint8_t* c = k == 0 ? p[OC] : k == 1 ? p[V0] : pCV;
        __stcs(out + lb * wpb + w0,
               word_at(a, b, c, L, P, k, lb, flip ? j : i, flip ? i : j));
      }
    }
  }
}

int ilog2(int x) {  // log2 of a power of two, else -1
  if (x <= 0 || (x & (x - 1))) return -1;
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// Fill P's sources and shared layout for P->R blocks a CTA; returns the
// shared bytes a CTA needs.
int layout(PackParams* P, const void* const* ptrs, int maps, int prec) {
  const int res = P->res, rc = res >> P->cs, rp = res / prec;
  const int edges[kSrc] = {res, res, rp, res, rc, rc, res, rc, rc};
  int end[3] = {0, 0, 0};
  int total = 0;
  for (int s = 0; s < kSrc; ++s) {
    Source& S = P->src[s];
    S.base = static_cast<const uint8_t*>(ptrs[s]);
    S.fstride = s >= Y0 ? maps * P->nb : P->nb;
    S.moff = s >= Y1 ? P->nb : 0;
    S.esz = s == OC ? 1 : 2;
    S.edge = edges[s];
    S.ledge = ilog2(S.edge);
    S.pitch = s == OC ? S.edge : 2 * S.edge + kRowPad;
    S.ts = S.edge * S.pitch;
    S.used = !((s == G1 || s >= Y1) && !P->two);
    const int plane = s <= OC ? 0 : s <= V0 ? 1 : 2;
    const int bytes = (P->R * S.ts + 15) & ~15;
    if (!S.used) {
      S.off = 0;
    } else if (P->passes == 1) {
      S.off = total;
      total += bytes;
    } else {  // each plane's sources from 0: a pass stages one plane
      S.off = end[plane];
      end[plane] += bytes;
    }
  }
  if (P->passes == 3) {
    total = end[0] > end[1] ? end[0] : end[1];
    total = total > end[2] ? total : end[2];
  }
  return total;
}

template <int RES>
int launch(const PackParams& P, int64_t F, int smem, uint32_t* cat,
           cudaStream_t stream) {
  const auto kern = pack_tiles_kernel<RES>;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((P.nb + P.R - 1) / P.R),
                  static_cast<unsigned>(F));
  kern<<<grid, kThreads, smem, stream>>>(P, cat);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// occ: (F, nb, res/prec, res/prec) u8; geo0, geo1: (F, nb, res, res) u16;
// ay: (F, maps, nb, res, res) u16; au, av: (F, maps, nb, res >> cs,
// res >> cs) u16; swap: (F, nb) u8; all contiguous, each at any address
// its dtype allows. cat: (F, nb, 3 * res * res) u32, 16-byte aligned,
// every word written. geo1 and map 1 are read only when two_maps.
// Returns the launch error code (0 on success), or cudaErrorInvalidValue
// for a shape the kernel does not take: more than 65,535 frames, more
// CTAs a frame than a grid holds, or tiles too large for shared memory a
// plane at a time (edges above about 190; V3C's largest is 128).
int pack_planes(const void* occ, const void* geo0, const void* geo1,
                const void* ay, const void* au, const void* av,
                const void* swap, int64_t F, int64_t nb, int maps, int res,
                int prec, int chroma_shift, int two_maps, void* cat,
                void* stream) {
  if (F < 0 || F > 65535 || nb < 0 || nb > (int64_t(1) << 40) || res < 1 ||
      prec < 1 || res % prec != 0 || chroma_shift < 0 || chroma_shift > 1 ||
      res % (1 << chroma_shift) != 0 || maps < 1 || maps > 2 ||
      (two_maps && maps < 2) || res > 4096) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F == 0 || nb == 0) return static_cast<int>(cudaGetLastError());
  PackParams P;
  P.swap = static_cast<const uint8_t*>(swap);
  P.nb = nb;
  P.res = res;
  P.prec = prec;
  P.lprec = ilog2(prec);
  P.cs = chroma_shift;
  P.two = two_maps ? 1 : 0;
  P.vec_out = (3 * res * res) % 4 == 0 &&
              (reinterpret_cast<uintptr_t>(cat) & 15) == 0;
  const int templ = res == 8 || res == 16 || res == 32;
  if (templ && !P.vec_out) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[kSrc] = {geo0, geo1, occ, ay, au, av, ay, au, av};
  // R: as many pixels a CTA as 4 blocks at res 16, cut to what fits
  int R = kPixels / (res * res);
  R = R < 1 ? 1 : R > kMaxBlocks ? kMaxBlocks : R;
  P.passes = 1;
  P.R = 1;
  const int one = layout(&P, ptrs, maps, prec);
  if (one <= kSmemOptIn) {
    P.R = R * one <= kSmemOptIn ? R : kSmemOptIn / one;
  } else {
    P.passes = 3;
  }
  const int smem = layout(&P, ptrs, maps, prec);
  if (smem > kSmemOptIn || (nb + P.R - 1) / P.R > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* out = static_cast<uint32_t*>(cat);
  switch (templ ? res : 0) {
    case 8: return launch<8>(P, F, smem, out, st);
    case 16: return launch<16>(P, F, smem, out, st);
    case 32: return launch<32>(P, F, smem, out, st);
    default: return launch<0>(P, F, smem, out, st);
  }
}

}  // extern "C"
