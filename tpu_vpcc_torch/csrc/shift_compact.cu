// K1 and K1F: stable per-frame stream compaction, in two variants.
//
// Replaces the Pallas kernel tpu_vpcc/ops/shift_compact.py::_make_kernel
// (launched by _launch, pallas_call at :499) in both of its uses. It
// computes what that kernel computes, not how the TPU made it fast: every
// valid element of the (F, S) operands moves to its emission rank within
// its frame, and per-frame counts come out beside the operands; the tail
// past a frame's count is left unwritten.
//
//   K1  (shift_compact_narrow; the kernel as entered from
//       shift_compact_ops, merge=True): the narrow words stage. The slot
//       axis is [D0 half | D1 half]; pixel p's D0 slot goes to dest0[p]
//       and its D1 slot to dest0[p] + v0[p], where dest0 is the exclusive
//       prefix sum of v0 + v1 over the frame's pixels.
//   K1F (shift_compact_full; the kernel as entered from
//       shift_compact_full_order, merge=False): the wide path, whose
//       memory order already is the emission order. dest is the
//       exclusive prefix sum of valid over the flat slot order, and three
//       u32 operands move.
//
// Bound: memory bytes, with no arithmetic to speak of. The work must read
// the validity once (1 B a slot), read each valid slot's operands and
// write them once (8-10 B for K1, 12 B for K1F), and write the counts:
// 35.2 MB for K1 and 51.0 MB for K1F at two 1280^2 flagship frames, 0.0105
// and 0.0152 ms at 3.35 TB/s. The 32-byte sectors that hold the valid
// slots hold invalid ones too, so the payload read is larger in fact.
//
// Design: one launch per call, after one memset of the call's scratch
// (the status words, one to a 128-byte line, and a ticket; nothing lives
// across calls, so calls on two streams do not share state). A tile is
// kTile items (K1: pixels, K1F: slots) of one frame, and one block of
// kTile / 16 threads takes it:
//   - Tiles are served in frame-major order by an atomic ticket, so a
//     block only ever waits on tiles whose blocks are already resident.
//   - Each thread loads one 16-byte validity vector (K1: one from each
//     half), so 16 items, and a block-wide scan gives each vector its
//     rank within the tile. Thread 0 publishes the tile's aggregate in a
//     64-bit status word (two flag bits, the value below them); a frame's
//     first tile publishes its inclusive prefix at once.
//   - Every thread issues its payload loads (below); then warp 0 reads
//     the tile's offset in its frame by decoupled look-back over 32
//     predecessors at a time, stopping at the nearest inclusive prefix
//     (never past the frame's first tile), and publishes its own.
//   - Payload loads are 16 bytes a thread, neighbouring threads on
//     neighbouring vectors (four slots of an int32 operand, eight of zs),
//     streaming (evict-first), and skipped where the vector holds no
//     valid slot. Each valid slot is written to shared memory at its rank
//     in the tile; for K1 the D0 slot goes to r0[p] and the D1 slot to
//     r0[p] + v0[p], so the D0/D1 interleave is index arithmetic.
//   - After a barrier the block copies its staged prefix to frame_base +
//     tile_offset + k (int64), consecutive threads on consecutive
//     addresses; the frame's last tile writes the count.
// No atomics touch the data, only the ticket, so two calls on one input
// give the same bytes. A stream that is not 16-byte aligned (an extent
// that is not a multiple of 16, or an offset pointer) takes the scalar
// loads of the same kernel. Against a count, scan and scatter in three
// launches, this reads the validity once, in 16-byte vectors instead of
// bytes, and stores each tile as one contiguous run per operand instead
// of a run per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Items (K1: pixels, K1F: slots) per tile and block. Chosen on the H100
// from 2048, 4096 and 8192: 8192 was slower, 2048 within noise.
constexpr int kTile = 4096;
constexpr int kThreads = kTile / 16;  // a validity vector each
// Status words are this many uint64 apart (128 bytes: one L2 line each).
// Every block's look-back reads the newest status words, up to a few
// hundred; packed sixteen to a line, those polls all went to a few L2
// slices, which then held up the payload traffic too.
constexpr int kStride = 16;
constexpr unsigned long long kFlagAgg = 1ull << 62;
constexpr unsigned long long kFlagPre = 2ull << 62;
constexpr unsigned long long kFlagMask = 3ull << 62;
constexpr unsigned long long kValueMask = ~kFlagMask;

__device__ __forceinline__ long long warp_sum64(long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Bit i set where byte i of w is not 0 (i < 4).
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((__vsetne4(w, 0u) * 0x01020408u) >> 24) & 0xFu;
}

// Bit i set where p[i] != 0, for i < min(n, 16). With kVec, p is 16-byte
// aligned and n is a multiple of 16. Every input is read once, so the
// vector loads are streaming (evict-first) loads.
template <bool kVec>
__device__ __forceinline__ unsigned valid_mask16(const uint8_t* p, int n) {
  if (n <= 0) return 0;
  if (kVec) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
    return nibble(q.x) | nibble(q.y) << 4 | nibble(q.z) << 8 |
           nibble(q.w) << 12;
  }
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i < n && p[i] != 0) m |= 1u << i;
  }
  return m;
}

// Four int32 at p (16-byte aligned with kVec); without kVec only the
// elements whose bit is set in `live` are read.
template <bool kVec>
__device__ __forceinline__ int4 load4(const int32_t* p, unsigned live) {
  if (kVec) return __ldcs(reinterpret_cast<const int4*>(p));
  int4 x = make_int4(0, 0, 0, 0);
  if (live & 1u) x.x = p[0];
  if (live & 2u) x.y = p[1];
  if (live & 4u) x.z = p[2];
  if (live & 8u) x.w = p[3];
  return x;
}

// Eight int16 at p, as load4 does it.
template <bool kVec>
__device__ __forceinline__ int4 load8(const int16_t* p, unsigned live) {
  if (kVec) return __ldcs(reinterpret_cast<const int4*>(p));
  unsigned u[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u[i] = (live >> i) & 1u ? static_cast<uint16_t>(p[i]) : 0u;
  }
  return make_int4(static_cast<int>(u[0] | u[1] << 16),
                   static_cast<int>(u[2] | u[3] << 16),
                   static_cast<int>(u[4] | u[5] << 16),
                   static_cast<int>(u[6] | u[7] << 16));
}

__device__ __forceinline__ int lane4(const int4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

__device__ __forceinline__ int16_t lane8(const int4& x, int e) {
  return static_cast<int16_t>(lane4(x, e >> 1) >> ((e & 1) * 16));
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Exclusive block-wide prefix sum of one int per thread; *total gets the
// block sum. s_warp holds kThreads / 32 + 1 ints and is read after the
// last barrier, so a block scans once.
template <int kThreads>
__device__ __forceinline__ int block_exclusive_scan(int x, int* total,
                                                    int* s_warp) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kWarps) s_warp[lane] = wi - w;
    if (lane == kWarps - 1) s_warp[kWarps] = wi;
  }
  __syncthreads();
  *total = s_warp[kWarps];
  return s_warp[warp] + incl - x;
}

__device__ __forceinline__ unsigned long long wait_status(
    const unsigned long long* p) {
  unsigned long long s;
  do {
    s = *reinterpret_cast<const volatile unsigned long long*>(p);
  } while ((s & kFlagMask) == 0);
  return s;
}

// Warp 0's look-back: the exclusive prefix of tile t of a frame whose
// status words start at fs (kStride apart), t > 0. Lane l reads
// predecessor t - 1 - l, then t - 33 - l, and so on, until the nearest
// inclusive prefix. Publishes the tile's inclusive prefix.
__device__ __forceinline__ long long look_back(unsigned long long* fs,
                                               int t, int n) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (int j = t - 1;; j -= 32) {
    const int jj = j - lane;
    const unsigned long long s =
        jj >= 0 ? wait_status(fs + static_cast<int64_t>(jj) * kStride)
                : kFlagPre;
    const unsigned pre =
        __ballot_sync(0xffffffffu, (s & kFlagMask) == kFlagPre);
    const int first = pre ? __ffs(pre) - 1 : 32;
    excl += warp_sum64(lane <= first ? static_cast<long long>(s & kValueMask)
                                     : 0);
    if (pre) break;
  }
  if (lane == 0) {
    publish(fs + static_cast<int64_t>(t) * kStride,
            kFlagPre | static_cast<unsigned long long>(excl + n));
  }
  return excl;
}

// K1F. Slots i0 + 16v .. i0 + 16v + 15 of the frame are thread v's
// vector; quads of four slots are loaded striped over the block.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
compact_full_kernel(const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ a0,
                    const int32_t* __restrict__ a1,
                    const int32_t* __restrict__ a2, int64_t S, int n_tiles,
                    int32_t* __restrict__ o0, int32_t* __restrict__ o1,
                    int32_t* __restrict__ o2, int* __restrict__ counts,
                    unsigned long long* __restrict__ status,
                    unsigned int* __restrict__ ticket) {
  extern __shared__ int4 smem[];
  int32_t* st0 = reinterpret_cast<int32_t*>(smem);
  int32_t* st1 = st0 + kTile;
  int32_t* st2 = st1 + kTile;
  __shared__ int s_tile;     // the ticket: f * n_tiles + t
  __shared__ long long s_off;  // the tile's exclusive prefix in its frame
  __shared__ int s_warp[kThreads / 32 + 1];
  __shared__ int s_ex[kThreads];
  __shared__ unsigned s_mask[kThreads];

  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int f = s_tile / n_tiles;
  const int t = s_tile - f * n_tiles;
  const int64_t i0 = static_cast<int64_t>(f) * S +
                     static_cast<int64_t>(t) * kTile;
  const int n_items = static_cast<int>(
      S - static_cast<int64_t>(t) * kTile < kTile
          ? S - static_cast<int64_t>(t) * kTile : kTile);
  unsigned long long* fs =
      status + static_cast<int64_t>(f) * n_tiles * kStride;

  const int v = threadIdx.x;
  const unsigned m = valid_mask16<kVec>(valid + i0 + 16 * v, n_items - 16 * v);
  int n;
  const int ex = block_exclusive_scan<kThreads>(__popc(m), &n, s_warp);
  if (threadIdx.x == 0) {
    publish(fs + static_cast<int64_t>(t) * kStride,
            (t == 0 ? kFlagPre : kFlagAgg) |
                static_cast<unsigned long long>(n));
  }
  s_ex[v] = ex;
  s_mask[v] = m;
  __syncthreads();

  // all of a thread's payload loads go out before warp 0's look-back
  constexpr int kQuads = kTile / 4 / kThreads;  // per thread
  int4 x0[kQuads], x1[kQuads], x2[kQuads];
  unsigned live[kQuads];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int q = j * kThreads + v;
    live[j] = (s_mask[q >> 2] >> ((q & 3) * 4)) & 0xFu;
    x0[j] = x1[j] = x2[j] = make_int4(0, 0, 0, 0);
    if (live[j] != 0) {
      const int64_t e = i0 + 4 * static_cast<int64_t>(q);
      x0[j] = load4<kVec>(a0 + e, live[j]);
      x1[j] = load4<kVec>(a1 + e, live[j]);
      x2[j] = load4<kVec>(a2 + e, live[j]);
    }
  }
  if (threadIdx.x < 32) {
    const long long off = t == 0 ? 0 : look_back(fs, t, n);
    if (threadIdx.x == 0) s_off = off;
  }
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int q = j * kThreads + v;
    const unsigned mv = s_mask[q >> 2];
    int r = s_ex[q >> 2] + __popc(mv & ((1u << ((q & 3) * 4)) - 1u));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((live[j] >> k) & 1u) {
        st0[r] = lane4(x0[j], k);
        st1[r] = lane4(x1[j], k);
        st2[r] = lane4(x2[j], k);
        ++r;
      }
    }
  }
  __syncthreads();

  const int64_t base = static_cast<int64_t>(f) * S + s_off;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    o0[base + k] = st0[k];
    o1[base + k] = st1[k];
    o2[base + k] = st2[k];
  }
  if (threadIdx.x == 0 && t == n_tiles - 1) {
    counts[f] = static_cast<int>(s_off + n);
  }
}

// K1. Pixels p0 + 16v .. p0 + 16v + 15 of the frame are thread v's
// vector: bits 0-15 of its mask are their D0 slots, bits 16-31 their D1
// slots. Quads of four pixels (int32 operands) and octets of eight (zs)
// are loaded striped over the block, from both halves.
template <bool kVec, bool kHasZs>
__global__ void __launch_bounds__(kThreads)
compact_narrow_kernel(const uint8_t* __restrict__ valid,
                      const int32_t* __restrict__ w0,
                      const int16_t* __restrict__ zs,
                      const int32_t* __restrict__ wc, int64_t S,
                      int n_tiles, int32_t* __restrict__ w0c,
                      int16_t* __restrict__ zsc, int32_t* __restrict__ wcc,
                      int* __restrict__ counts,
                      unsigned long long* __restrict__ status,
                      unsigned int* __restrict__ ticket) {
  const int64_t half = S / 2;
  extern __shared__ int4 smem[];
  int32_t* st_w0 = reinterpret_cast<int32_t*>(smem);
  int32_t* st_wc = st_w0 + 2 * kTile;
  int16_t* st_zs = reinterpret_cast<int16_t*>(st_wc + 2 * kTile);
  __shared__ int s_tile;     // the ticket: f * n_tiles + t
  __shared__ long long s_off;  // the tile's exclusive prefix in its frame
  __shared__ int s_warp[kThreads / 32 + 1];
  __shared__ int s_ex[kThreads];
  __shared__ unsigned s_mask[kThreads];

  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int f = s_tile / n_tiles;
  const int t = s_tile - f * n_tiles;
  const int64_t p0 = static_cast<int64_t>(f) * S +
                     static_cast<int64_t>(t) * kTile;
  const int n_pix = static_cast<int>(
      half - static_cast<int64_t>(t) * kTile < kTile
          ? half - static_cast<int64_t>(t) * kTile : kTile);
  unsigned long long* fs =
      status + static_cast<int64_t>(f) * n_tiles * kStride;

  const int v = threadIdx.x;
  const unsigned ma = valid_mask16<kVec>(valid + p0 + 16 * v, n_pix - 16 * v);
  const unsigned mb =
      valid_mask16<kVec>(valid + p0 + half + 16 * v, n_pix - 16 * v);
  int n;
  const int ex =
      block_exclusive_scan<kThreads>(__popc(ma) + __popc(mb), &n, s_warp);
  if (threadIdx.x == 0) {
    publish(fs + static_cast<int64_t>(t) * kStride,
            (t == 0 ? kFlagPre : kFlagAgg) |
                static_cast<unsigned long long>(n));
  }
  s_ex[v] = ex;
  s_mask[v] = ma | mb << 16;
  __syncthreads();

  // all of a thread's payload loads go out before warp 0's look-back:
  // quads of four pixels of w0 and wc, octets of eight of zs, from both
  // halves
  constexpr int kQuads = kTile / 4 / kThreads;   // per thread
  constexpr int kOctets = kTile / 8 / kThreads;  // per thread
  int4 a_w0[kQuads], a_wc[kQuads], b_w0[kQuads], b_wc[kQuads];
  unsigned live[kQuads];  // D0 bits 0-3, D1 bits 4-7
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int q = j * kThreads + v;
    const unsigned mv = s_mask[q >> 2];
    const int sh = (q & 3) * 4;
    const unsigned la = (mv >> sh) & 0xFu;
    const unsigned lb = (mv >> (16 + sh)) & 0xFu;
    live[j] = la | lb << 4;
    a_w0[j] = a_wc[j] = b_w0[j] = b_wc[j] = make_int4(0, 0, 0, 0);
    const int64_t e = p0 + 4 * static_cast<int64_t>(q);
    if (la != 0) {
      a_w0[j] = load4<kVec>(w0 + e, la);
      a_wc[j] = load4<kVec>(wc + e, la);
    }
    if (lb != 0) {
      b_w0[j] = load4<kVec>(w0 + e + half, lb);
      b_wc[j] = load4<kVec>(wc + e + half, lb);
    }
  }
  int4 za[kOctets], zb[kOctets];
  unsigned zlive[kOctets];  // D0 bits 0-7, D1 bits 8-15
  if (kHasZs) {
#pragma unroll
    for (int j = 0; j < kOctets; ++j) {
      const int o = j * kThreads + v;
      const unsigned mv = s_mask[o >> 1];
      const int sh = (o & 1) * 8;
      const unsigned la = (mv >> sh) & 0xFFu;
      const unsigned lb = (mv >> (16 + sh)) & 0xFFu;
      zlive[j] = la | lb << 8;
      za[j] = zb[j] = make_int4(0, 0, 0, 0);
      const int64_t e = p0 + 8 * static_cast<int64_t>(o);
      if (la != 0) za[j] = load8<kVec>(zs + e, la);
      if (lb != 0) zb[j] = load8<kVec>(zs + e + half, lb);
    }
  }
  if (threadIdx.x < 32) {
    const long long off = t == 0 ? 0 : look_back(fs, t, n);
    if (threadIdx.x == 0) s_off = off;
  }
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int q = j * kThreads + v;
    const unsigned mv = s_mask[q >> 2];
    const unsigned below = ((1u << ((q & 3) * 4)) - 1u) * 0x10001u;
    int r = s_ex[q >> 2] + __popc(mv & below);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((live[j] >> k) & 1u) {
        st_w0[r] = lane4(a_w0[j], k);
        st_wc[r] = lane4(a_wc[j], k);
        ++r;
      }
      if ((live[j] >> (4 + k)) & 1u) {
        st_w0[r] = lane4(b_w0[j], k);
        st_wc[r] = lane4(b_wc[j], k);
        ++r;
      }
    }
  }
  if (kHasZs) {
#pragma unroll
    for (int j = 0; j < kOctets; ++j) {
      const int o = j * kThreads + v;
      const unsigned mv = s_mask[o >> 1];
      const unsigned below = ((1u << ((o & 1) * 8)) - 1u) * 0x10001u;
      int r = s_ex[o >> 1] + __popc(mv & below);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if ((zlive[j] >> k) & 1u) st_zs[r++] = lane8(za[j], k);
        if ((zlive[j] >> (8 + k)) & 1u) st_zs[r++] = lane8(zb[j], k);
      }
    }
  }
  __syncthreads();

  const int64_t base = static_cast<int64_t>(f) * S + s_off;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    w0c[base + k] = st_w0[k];
    wcc[base + k] = st_wc[k];
    if (kHasZs) zsc[base + k] = st_zs[k];
  }
  if (threadIdx.x == 0 && t == n_tiles - 1) {
    counts[f] = static_cast<int>(s_off + n);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Zero the scratch's n_status status words (kStride apart) and the
// ticket after them on the stream, then launch one block of kThreads per
// tile with `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), size_t smem, void* scratch,
                   int64_t n_status, cudaStream_t st, Args... args) {
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, (n_status * kStride + 1) * sizeof(unsigned long long),
      st);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  kernel<<<static_cast<unsigned>(n_status), kThreads, smem, st>>>(
      args..., status,
      reinterpret_cast<unsigned int*>(status + n_status * kStride));
  return cudaGetLastError();
}

cudaError_t narrow(const uint8_t* valid, const int32_t* w0,
                   const int16_t* zs, const int32_t* wc, int32_t* w0c,
                   int16_t* zsc, int32_t* wcc, int* counts, void* scratch,
                   int64_t F, int64_t S, cudaStream_t st) {
  const int64_t half = S / 2;
  const int n_tiles = static_cast<int>((half + kTile - 1) / kTile);
  const bool vec = half % 16 == 0 && aligned16(valid) && aligned16(w0) &&
                   aligned16(wc) && (zs == nullptr || aligned16(zs));
  const size_t smem = 2 * kTile * (zs == nullptr ? 8 : 10);
  auto run = [&](auto kernel) {
    return launch(kernel, smem, scratch, F * n_tiles, st, valid, w0, zs, wc,
                  S, n_tiles, w0c, zsc, wcc, counts);
  };
  if (zs != nullptr) {
    return vec ? run(compact_narrow_kernel<true, true>)
               : run(compact_narrow_kernel<false, true>);
  }
  return vec ? run(compact_narrow_kernel<true, false>)
             : run(compact_narrow_kernel<false, false>);
}

cudaError_t full(const uint8_t* valid, const int32_t* a0, const int32_t* a1,
                 const int32_t* a2, int32_t* o0, int32_t* o1, int32_t* o2,
                 int* counts, void* scratch, int64_t F, int64_t S,
                 cudaStream_t st) {
  const int n_tiles = static_cast<int>((S + kTile - 1) / kTile);
  const bool vec = S % 16 == 0 && aligned16(valid) && aligned16(a0) &&
                   aligned16(a1) && aligned16(a2);
  const size_t smem = 3 * kTile * sizeof(int32_t);
  auto run = [&](auto kernel) {
    return launch(kernel, smem, scratch, F * n_tiles, st, valid, a0, a1, a2,
                  S, n_tiles, o0, o1, o2, counts);
  };
  return vec ? run(compact_full_kernel<true>)
             : run(compact_full_kernel<false>);
}

// F frames of `items` items (K1: pixels, K1F: slots):
// cudaErrorInvalidValue for a shape past int32 counts and tickets,
// cudaSuccess otherwise.
cudaError_t check_shape(int64_t F, int64_t S, int64_t items) {
  if (F < 0 || S < 0 || S > 0x7fffffffLL ||
      F * ((items + kTile - 1) / kTile) >= 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The tile, in items (K1: pixels, K1F: slots).
int shift_compact_tile_pixels() { return kTile; }

// Scratch words (uint64) a call on F frames of `items` items needs: a
// 128-byte line per tile for its status word, and the ticket.
int64_t shift_compact_scratch_words(int64_t F, int64_t items) {
  return F * ((items + kTile - 1) / kTile) * kStride + 1;
}

// K1. valid: (F, S) bool as bytes; w0, wc: (F, S) int32 bit patterns; zs:
// (F, S) int16 bit patterns or null (pack30). Outputs like the inputs,
// plus counts (F,) int32. S even. scratch: shift_compact_scratch_words(F,
// S / 2) uint64, zeroed here. Returns the CUDA error code (0 on success).
int shift_compact_narrow(const void* valid, const void* w0, const void* zs,
                         const void* wc, void* w0c, void* zsc, void* wcc,
                         void* counts, void* scratch, int64_t F, int64_t S,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = check_shape(F, S, S / 2);
  if (e != cudaSuccess || S % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F == 0) return static_cast<int>(cudaGetLastError());
  if (S == 0) {
    cudaMemsetAsync(counts, 0, F * sizeof(int), st);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(narrow(
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(w0),
      static_cast<const int16_t*>(zs), static_cast<const int32_t*>(wc),
      static_cast<int32_t*>(w0c), static_cast<int16_t*>(zsc),
      static_cast<int32_t*>(wcc), static_cast<int*>(counts), scratch, F, S,
      st));
}

// K1F. valid: (F, S) bool as bytes; a0, a1, a2: (F, S) int32 bit
// patterns in emission order. Outputs o0, o1, o2 like the inputs, plus
// counts (F,) int32. scratch: shift_compact_scratch_words(F, S) uint64,
// zeroed here. Returns the CUDA error code (0 on success).
int shift_compact_full(const void* valid, const void* a0, const void* a1,
                       const void* a2, void* o0, void* o1, void* o2,
                       void* counts, void* scratch, int64_t F, int64_t S,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = check_shape(F, S, S);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (F == 0) return static_cast<int>(cudaGetLastError());
  if (S == 0) {
    cudaMemsetAsync(counts, 0, F * sizeof(int), st);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(full(
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(a0),
      static_cast<const int32_t*>(a1), static_cast<const int32_t*>(a2),
      static_cast<int32_t*>(o0), static_cast<int32_t*>(o1),
      static_cast<int32_t*>(o2), static_cast<int*>(counts), scratch, F, S,
      st));
}

}  // extern "C"
