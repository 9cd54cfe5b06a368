// K1 and K1F: stable per-frame stream compaction, in two variants.
//
// Replaces the Pallas kernel tpu_vpcc/ops/shift_compact.py::_make_kernel
// in both of its uses. It computes what that kernel computes, not how
// the TPU made it fast: every valid element of the (F, S) operands moves
// to its emission rank within its frame, and per-frame counts come out
// beside the operands; the tail past a frame's count is left unwritten.
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
// Bound: memory bytes. Each slot reads 1 B of validity twice and 8-12 B
// of payload (at sector granularity: at flagship densities the valid
// slots touch nearly every sector) and each point writes its payload
// once; there is no arithmetic to speak of. At two 1280^2 flagship
// frames (3,670,016 slots, about 1.97M points) that is about 52 MB for
// K1 and 75 MB for K1F, computed from shapes. Design: three launches on
// the caller's stream, with no atomics, so the result is deterministic
// and stable by construction. Both variants share (a) and (b):
//   (a) count:   one block per (tile, frame) sums the validity over the
//                tile (v0 + v1 per pixel for K1, v per slot for K1F).
//   (b) scan:    one block per frame scans the tile sums (exclusive) and
//                writes the frame's count.
//   (c) scatter: one block per (tile, frame) rescans its tile (warp
//                shuffles plus shared memory), adds the tile offset and
//                stores each valid slot straight to its destination.
// The D0/D1 interleave that the TPU kernel built with a merge network is
// index arithmetic in K1's scatter; K1F's scatter is a plain per-slot
// scatter. Single-pass look-back and fusion with the words stage are
// left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                  // consecutive pixels per thread
constexpr int kTile = kThreads * kItems;   // pixels (K1) or slots (K1F)
constexpr int kWarps = kThreads / 32;

// Exclusive block-wide prefix sum of one int per thread; *total gets the
// block sum. Ends with a barrier, so shared memory may be reused at once.
__device__ __forceinline__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[kWarps];
  __shared__ int block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kWarps) warp_sums[lane] = wi - w;
    if (lane == kWarps - 1) block_total = wi;
  }
  __syncthreads();
  const int ex = warp_sums[warp] + incl - x;
  *total = block_total;
  __syncthreads();
  return ex;
}

// kPairs (K1): item p counts v[p] + v[n + p], the pixel's D0 and D1
// slots; otherwise (K1F) item p counts v[p]. n items per frame.
template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ valid, int64_t S, int64_t n,
             int n_tiles, int* __restrict__ tile_sums) {
  const int t = blockIdx.x;
  const int f = blockIdx.y;
  const uint8_t* v = valid + (int64_t)f * S;
  int c = 0;
  // count order does not matter: stride by the block for coalescing
  for (int i = 0; i < kItems; ++i) {
    const int64_t p = (int64_t)t * kTile + i * kThreads + threadIdx.x;
    if (p < n) c += (v[p] != 0) + (kPairs ? (v[n + p] != 0) : 0);
  }
  int total;
  block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) tile_sums[(int64_t)f * n_tiles + t] = total;
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(const int* __restrict__ tile_sums, int n_tiles,
            int* __restrict__ tile_offs, int* __restrict__ counts) {
  const int f = blockIdx.x;
  const int64_t row = (int64_t)f * n_tiles;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += kThreads) {
    const int i = base + threadIdx.x;
    const int x = i < n_tiles ? tile_sums[row + i] : 0;
    int total;
    const int ex = block_exclusive_scan(x, &total);
    if (i < n_tiles) tile_offs[row + i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) counts[f] = carry;
}

template <bool kHasZs>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ valid,
               const int32_t* __restrict__ w0,
               const int16_t* __restrict__ zs,
               const int32_t* __restrict__ wc,
               int64_t S, int64_t half, int n_tiles,
               const int* __restrict__ tile_offs,
               int32_t* __restrict__ w0c, int16_t* __restrict__ zsc,
               int32_t* __restrict__ wcc) {
  const int t = blockIdx.x;
  const int f = blockIdx.y;
  const int64_t fo = (int64_t)f * S;
  const int64_t p0 = (int64_t)t * kTile + (int64_t)threadIdx.x * kItems;
  uint8_t a[kItems];
  uint8_t b[kItems];
  int c = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t p = p0 + i;
    a[i] = p < half ? (valid[fo + p] != 0) : 0;
    b[i] = p < half ? (valid[fo + half + p] != 0) : 0;
    c += a[i] + b[i];
  }
  int total;
  const int ex = block_exclusive_scan(c, &total);
  int64_t d = fo + tile_offs[(int64_t)f * n_tiles + t] + ex;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t s0 = fo + p0 + i;
    if (a[i]) {
      w0c[d] = w0[s0];
      if (kHasZs) zsc[d] = zs[s0];
      wcc[d] = wc[s0];
      ++d;
    }
    if (b[i]) {
      const int64_t s1 = s0 + half;
      w0c[d] = w0[s1];
      if (kHasZs) zsc[d] = zs[s1];
      wcc[d] = wc[s1];
      ++d;
    }
  }
}

// K1F's scatter: three int32 operands in emission order, one slot per
// item.
__global__ void __launch_bounds__(kThreads)
scatter_full_kernel(const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ a0,
                    const int32_t* __restrict__ a1,
                    const int32_t* __restrict__ a2, int64_t S, int n_tiles,
                    const int* __restrict__ tile_offs,
                    int32_t* __restrict__ o0, int32_t* __restrict__ o1,
                    int32_t* __restrict__ o2) {
  const int t = blockIdx.x;
  const int f = blockIdx.y;
  const int64_t fo = (int64_t)f * S;
  const int64_t p0 = (int64_t)t * kTile + (int64_t)threadIdx.x * kItems;
  uint8_t a[kItems];
  int c = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t p = p0 + i;
    a[i] = p < S ? (valid[fo + p] != 0) : 0;
    c += a[i];
  }
  int total;
  const int ex = block_exclusive_scan(c, &total);
  int64_t d = fo + tile_offs[(int64_t)f * n_tiles + t] + ex;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (a[i]) {
      const int64_t s = fo + p0 + i;
      o0[d] = a0[s];
      o1[d] = a1[s];
      o2[d] = a2[s];
      ++d;
    }
  }
}

}  // namespace

extern "C" {

// Items (K1: pixels, K1F: slots) per tile: the wrapper sizes the
// (2, F, n_tiles) int32 scratch.
int shift_compact_tile_pixels() { return kTile; }

// valid: (F, S) bool as bytes; w0, wc: (F, S) int32 bit patterns; zs:
// (F, S) int16 bit patterns or null (pack30). Outputs like the inputs,
// plus counts (F,) int32. scratch: 2 * F * n_tiles int32. Returns the
// launch error code (0 on success).
int shift_compact_narrow(const void* valid, const void* w0, const void* zs,
                         const void* wc, void* w0c, void* zsc, void* wcc,
                         void* counts, void* scratch, int64_t F, int64_t S,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t half = S / 2;
  if (F == 0) return static_cast<int>(cudaGetLastError());
  if (half == 0) {
    cudaMemsetAsync(counts, 0, F * sizeof(int), st);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_tiles = static_cast<int>((half + kTile - 1) / kTile);
  int* tile_sums = static_cast<int*>(scratch);
  int* tile_offs = tile_sums + F * n_tiles;
  const dim3 grid(n_tiles, static_cast<unsigned>(F));
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  count_kernel<true><<<grid, kThreads, 0, st>>>(v, S, half, n_tiles,
                                                tile_sums);
  scan_kernel<<<static_cast<unsigned>(F), kThreads, 0, st>>>(
      tile_sums, n_tiles, tile_offs, static_cast<int*>(counts));
  if (zs != nullptr) {
    scatter_kernel<true><<<grid, kThreads, 0, st>>>(
        v, static_cast<const int32_t*>(w0), static_cast<const int16_t*>(zs),
        static_cast<const int32_t*>(wc), S, half, n_tiles, tile_offs,
        static_cast<int32_t*>(w0c), static_cast<int16_t*>(zsc),
        static_cast<int32_t*>(wcc));
  } else {
    scatter_kernel<false><<<grid, kThreads, 0, st>>>(
        v, static_cast<const int32_t*>(w0), nullptr,
        static_cast<const int32_t*>(wc), S, half, n_tiles, tile_offs,
        static_cast<int32_t*>(w0c), nullptr, static_cast<int32_t*>(wcc));
  }
  return static_cast<int>(cudaGetLastError());
}

// K1F. valid: (F, S) bool as bytes; a0, a1, a2: (F, S) int32 bit
// patterns in emission order. Outputs o0, o1, o2 like the inputs, plus
// counts (F,) int32. scratch: 2 * F * n_tiles int32. Returns the launch
// error code (0 on success).
int shift_compact_full(const void* valid, const void* a0, const void* a1,
                       const void* a2, void* o0, void* o1, void* o2,
                       void* counts, void* scratch, int64_t F, int64_t S,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F == 0) return static_cast<int>(cudaGetLastError());
  if (S == 0) {
    cudaMemsetAsync(counts, 0, F * sizeof(int), st);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_tiles = static_cast<int>((S + kTile - 1) / kTile);
  int* tile_sums = static_cast<int*>(scratch);
  int* tile_offs = tile_sums + F * n_tiles;
  const dim3 grid(n_tiles, static_cast<unsigned>(F));
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  count_kernel<false><<<grid, kThreads, 0, st>>>(v, S, S, n_tiles,
                                                 tile_sums);
  scan_kernel<<<static_cast<unsigned>(F), kThreads, 0, st>>>(
      tile_sums, n_tiles, tile_offs, static_cast<int*>(counts));
  scatter_full_kernel<<<grid, kThreads, 0, st>>>(
      v, static_cast<const int32_t*>(a0), static_cast<const int32_t*>(a1),
      static_cast<const int32_t*>(a2), S, n_tiles, tile_offs,
      static_cast<int32_t*>(o0), static_cast<int32_t*>(o1),
      static_cast<int32_t*>(o2));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
