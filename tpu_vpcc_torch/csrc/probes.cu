// K4-K6: the Mosaic probes P1-P12 as small Hopper kernels.
//
// Replace the Pallas kernels of tools/pallas_probe.py (P1-P4, K4),
// tools/pallas_probe2.py (P5-P8, K5) and tools/pallas_probe3.py (P9-P12,
// K6). Each probe checked, on the TPU, a data movement that the planned
// shift-network compaction needed from Mosaic; each kernel here is the
// same movement as the card does it, not a copy of the Mosaic workaround:
//
//   P1, P7   roll of an (R, L) int32 array along rows or lanes, through
//            shared memory; P7 reads the shift from device memory at run
//            time (probe_roll).
//   P2, P6   flat shift-down by k (element p takes element (p + k) mod n)
//            as offset loads, on int32 and on u16 carried as int16
//            (probe_flat_shift).
//   P3, P9,  the element interleave out[2i] = a[i], out[2i + 1] = b[i]:
//   P12      one 8-byte store per int32 pair, one 4-byte store per u16
//            pair (probe_interleave).
//   P4       overlapping writes of (rows, L) steps at row offsets read from
//            a device array, applied in step order: each output row takes
//            the last step that covers it, or zeros, so blocks need no
//            order and every output row is written once (probe_dyn_write).
//   P5       u32 -> little-endian u16 pairs and back: on the card a
//            reinterpretation, so the kernel is a copy, four 16-byte
//            vectors a thread in one launch (probe_reinterpret).
//   P8       each u16-stream slot moved down by its own shift and joined
//            with its high half into a u32, in one pass through shared
//            memory, one block per segment of up to 4,096 slots
//            (probe_mini_compact).
//   P10      tile-concat out[r, c] = a[r, c mod L], which is what
//            pltpu.repeat(x, 2, axis=1) computes (tools/pallas_probe3.py:63;
//            probe_tile_concat).
//   P11      lane reversal, lax.rev (tools/pallas_probe3.py:79;
//            probe_reverse_lanes).
//
// Bound: memory bytes, all of them (no arithmetic to speak of); at the
// probes' own shapes (a few KB) every launch is bound by its latency.
//
// P10 and P11 at about 64 MiB per operand: P11 must read 64 MiB and
// write 64 MiB (0.040 ms at 3.35 TB/s), P10 read 64 MiB once and write
// 128 MiB (0.060 ms; torch.cat([a, a], 1) reads a twice). One int32
// per thread behind 64-bit divisions (emulated, dozens of instructions
// each) falls well short of that. Here a 2-D grid gives each thread its
// column (blockIdx.x) and rows (blockIdx.y), so nothing is divided; a
// thread moves 16-byte vectors through read-only loads and
// streaming stores, four rows in flight; P11 reverses a vector's lanes in
// registers and P10 stores each vector it reads twice; the grid covers
// every row tile, so all 132 SMs fill. Widths that are not a multiple of
// four take the scalar path of the same kernels.
//
// P8 replaces tools/pallas_probe2.py::probe_mini_compact (kernel kern,
// pallas_call at :190), which ran a 13-stage log-shift network because
// Mosaic had no scatter. At 64 MiB per operand it must read three 64 MiB
// streams and write 128 MiB (0.100 ms at 3.35 TB/s); the network's 26
// barriers and 13 rounds of shared-memory traffic a segment, and its
// 2-byte accesses, held it to a fifth of that. The card scatters, so the
// kernel computes the function itself: per segment, 16-byte streaming
// loads of the three streams, the u32 slot values (lo | hi << 16) and
// shifts joined in registers, every slot stored to its own place in a
// shared-memory copy of the segment, one barrier, every moving slot
// (shift s > 0) stored to p - s, one barrier, and the segment written
// with 16-byte streaming stores: two barriers in place of 26, nothing
// per stage. One 256-thread block per segment (16 slots a thread, 16 KB
// of shared memory); at 46-48 registers a thread five blocks fit on an
// SM, so the 8,192 segments of the 64 MiB shape fill all 132 SMs for
// some twelve waves. Segments of
// a word count that is no multiple of four do not start on 16 bytes and
// take the scalar path of the same kernel. Preconditions (the compaction
// shifts of tools/hopper_probe2.py::mini_compact_inputs meet them): a
// shift stays inside its segment, and no two moving slots share a
// destination; a slot whose destination would leave the segment is
// skipped, colliding slots leave either value.
//
// P5 replaces tools/pallas_probe2.py::probe_bitcast (kernels kern and
// kern2, pallas_calls at :60 and :78). The u32 words and their u16 pairs
// are the same bytes here, so it must read every byte once and write it
// once: 134,217,728 bytes at its 64 MiB shape, 0.040 ms at 3.35 TB/s.
// Each thread starts four 16-byte streaming loads (__ldcs) before its
// four streaming stores (__stcs), so 64 bytes a thread are in flight and
// nothing stays in the caches the copy passes once; a block of 256
// threads takes 16 KB, eight blocks fill an SM, and the grid covers the
// array once, with no stride loop and no cap on blocks. The last block's
// threads also copy the one to three words past the last vector: one
// launch a call, whatever the size. It was chosen on the H100 over a
// bulk-copy pipeline (TMA: persistent blocks, a ring of S chunks of C KB
// in shared memory with one mbarrier a stage, one thread keeping the
// bulk loads and stores in flight), which at its best (C = 16 KB, S = 3,
// one block an SM) moved the 64 MiB shape at 84-85% of the bound against
// this kernel's 86-87%, the rate view().clone() also reaches (PERF.md).
//
// P4 replaces tools/pallas_probe.py::probe_dyn_dma (kernel at :172,
// pallas_call at :192), whose sequential grid applied each step's DMA in
// turn. It must read the winning step's row for each covered output row
// and write every output row once (0.021 ms at its 64 MiB shape, 256
// steps of 512 x 128 int32). A block of 8 warps stages the offsets in
// shared memory once (up to kOffsCap of them; more are read from device
// memory); each warp takes one output row at a time and finds its owner,
// the last step that covers it, by comparing 32 offsets at once from the
// top down with one ballot (unsorted offsets need no special case), then
// its lanes move the owner's row in 16-byte read-only loads and streaming
// stores, four rows in flight, adding 1000 * owner; a row that no step
// covers is stored as zeros in the same pass, so the output needs no fill
// first. Threads run along the row's columns and blocks along row tiles,
// so nothing is divided; widths that are no multiple of four take the
// scalar path. The wrapper range-checks the offsets (ops/probes.py); the
// kernel reads only rows of the step that covers the output row, so an
// offset out of range cannot make it read outside x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 8192;     // int32 elements of a roll tile (32 KB)
constexpr int kMaxSlots = 4096;      // P8 slots per segment
constexpr int kCompactThreads = 256;
constexpr int kSlotsPerThread = kMaxSlots / kCompactThreads;
constexpr int kOffsCap = 4096;       // P4 offsets staged in shared memory
constexpr int kRowWarps = kThreads / 32;
constexpr int kRowsInFlight = 4;     // rows a P4, P10 or P11 thread moves at once
constexpr int kCopyVectors = 4;      // 16-byte vectors a P5 thread moves

unsigned grid_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b > 132 * 64) b = 132 * 64;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

__device__ __forceinline__ int64_t pos_mod(int64_t a, int64_t n) {
  const int64_t r = a % n;
  return r < 0 ? r + n : r;
}

// One block per tile of rows_per_block rows: load the source rows into
// shared memory, then write the rolled tile. axis 1 rolls within each row,
// axis 0 takes whole rows (r - shift) mod R.
__global__ void __launch_bounds__(kThreads)
roll_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
            int64_t R, int L, int rows_per_block, int axis, int shift,
            const int32_t* __restrict__ dyn_shift) {
  __shared__ int32_t tile[kTileElems];
  const int64_t s = dyn_shift != nullptr ? *dyn_shift : shift;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t rows_left = R - r0;
  const int rows = rows_left < rows_per_block ? static_cast<int>(rows_left)
                                              : rows_per_block;
  const int n = rows * L;
  const int64_t sr = axis == 0 ? pos_mod(s, R) : 0;
  const int sl = axis == 1 ? static_cast<int>(pos_mod(s, L)) : 0;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / L;
    const int c = e - r * L;
    const int64_t src_row = axis == 0 ? pos_mod(r0 + r - sr, R) : r0 + r;
    tile[e] = x[src_row * L + c];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / L;
    const int c = e - r * L;
    int src = e;
    if (axis == 1) {
      int cc = c - sl;
      if (cc < 0) cc += L;
      src = r * L + cc;
    }
    out[(r0 + r) * L + c] = tile[src];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flat_shift_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n,
                  int64_t k) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       p < n; p += stride) {
    int64_t q = p + k;
    if (q >= n) q -= n;
    out[p] = x[q];
  }
}

__global__ void __launch_bounds__(kThreads)
interleave32_kernel(const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b, int2* __restrict__ out,
                    int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    out[i] = make_int2(a[i], b[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
interleave16_kernel(const uint16_t* __restrict__ a,
                    const uint16_t* __restrict__ b, uint32_t* __restrict__ out,
                    int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    out[i] = static_cast<uint32_t>(a[i]) | (static_cast<uint32_t>(b[i]) << 16);
  }
}

// P4: the last step whose rows [off, off + step_rows) cover row r, or -1,
// the same in every lane of the warp: lane l checks step top - l, and
// the lowest lane that covers r holds the highest step.
__device__ __forceinline__ int last_owner(const int32_t* off, int nstep,
                                          int step_rows, int64_t r,
                                          int lane) {
  for (int top = nstep - 1; top >= 0; top -= 32) {
    const int i = top - lane;
    bool covers = false;
    if (i >= 0) {
      const int64_t o = off[i];
      covers = o <= r && r < o + step_rows;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, covers);
    if (hit) return top - (__ffs(hit) - 1);
  }
  return -1;
}

__device__ __forceinline__ int32_t marked(int32_t v, unsigned m) {
  return static_cast<int32_t>(static_cast<unsigned>(v) + m);
}

// P4, block (32, kRowWarps): warp threadIdx.y takes output rows
// kRowWarps apart, kRowsInFlight at once; lane threadIdx.x takes column
// blockIdx.x * 32 + threadIdx.x of each (a 16-byte vector of four int32
// where L % 4 == 0, else one element).
__global__ void __launch_bounds__(kThreads)
dyn_write_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ offs,
                 int32_t* __restrict__ out, int nstep, int step_rows, int L,
                 int64_t out_rows, bool vec) {
  extern __shared__ int32_t offs_s[];
  const bool staged = nstep <= kOffsCap;
  if (staged) {
    for (int i = threadIdx.y * 32 + threadIdx.x; i < nstep; i += kThreads) {
      offs_s[i] = __ldg(offs + i);
    }
    __syncthreads();
  }
  const int32_t* off = staged ? offs_s : offs;
  const int cols = vec ? L / 4 : L;
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int64_t tile = static_cast<int64_t>(kRowWarps) * kRowsInFlight;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.y) * tile + threadIdx.y;
       r0 < out_rows; r0 += static_cast<int64_t>(gridDim.y) * tile) {
    int own[kRowsInFlight];
    int64_t src[kRowsInFlight];  // the owner's row in x, as (nstep * step_rows) rows
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int64_t r = r0 + u * kRowWarps;
      own[u] = r < out_rows ? last_owner(off, nstep, step_rows, r, threadIdx.x)
                            : -1;
      src[u] = own[u] < 0 ? 0
                          : static_cast<int64_t>(own[u]) * step_rows +
                                (r - off[own[u]]);
    }
    if (c >= cols) continue;
    if (vec) {
      const int4* xs = reinterpret_cast<const int4*>(x);
      int4* dst = reinterpret_cast<int4*>(out);
      int4 v[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        v[u] = own[u] < 0 ? make_int4(0, 0, 0, 0) : __ldg(xs + src[u] * cols + c);
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int64_t r = r0 + u * kRowWarps;
        if (r >= out_rows) continue;
        if (own[u] >= 0) {
          const unsigned m = 1000u * static_cast<unsigned>(own[u]);
          v[u] = make_int4(marked(v[u].x, m), marked(v[u].y, m),
                           marked(v[u].z, m), marked(v[u].w, m));
        }
        __stcs(dst + r * cols + c, v[u]);
      }
    } else {
      int32_t v[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        v[u] = own[u] < 0 ? 0 : __ldg(x + src[u] * L + c);
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int64_t r = r0 + u * kRowWarps;
        if (r >= out_rows) continue;
        if (own[u] >= 0) v[u] = marked(v[u], 1000u * static_cast<unsigned>(own[u]));
        __stcs(out + r * L + c, v[u]);
      }
    }
  }
}

// P5: thread t of block b moves the 16-byte vectors
// b * kThreads * kCopyVectors + t, + kThreads, ... (kCopyVectors of them):
// all the streaming loads, then the streaming stores, so 64 bytes a
// thread are in flight and nothing stays in the caches. The grid covers
// the n_vec vectors once, with no stride loop; the last block's threads
// also copy the bytes past them (at most three words).
__global__ void __launch_bounds__(kThreads)
vec_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                int64_t n_vec, int64_t nbytes) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kThreads * kCopyVectors + threadIdx.x;
  uint4 v[kCopyVectors];
#pragma unroll
  for (int u = 0; u < kCopyVectors; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < n_vec) v[u] = __ldcs(src + i);
  }
#pragma unroll
  for (int u = 0; u < kCopyVectors; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < n_vec) __stcs(dst + i, v[u]);
  }
  if (blockIdx.x == gridDim.x - 1) {
    const int64_t w = n_vec * 4 + threadIdx.x;
    if (w < nbytes / 4) {
      reinterpret_cast<uint32_t*>(dst)[w] =
          reinterpret_cast<const uint32_t*>(src)[w];
    }
  }
}

// P8: W consecutive u32 words at p (16-byte aligned where W is 4), read
// once, so streamed past the caches.
template <int W>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
    w[0] = a.x;
    w[1] = a.y;
    w[2] = a.z;
    w[3] = a.w;
  } else {
    w[0] = __ldcs(p);
  }
}

// P8, one block per segment of n = 2 * seg_words slots: stream slot 2w
// is the low half of word w, slot 2w + 1 its high half (the
// little-endian reinterpretation P5 probes). A thread loads word groups
// g = threadIdx.x + k * kCompactThreads of W words (W = 4 on the vector
// path, seg_words % 4 == 0; else 1), so it holds slots 2W g .. 2W g +
// 2W - 1 of each group in registers (kSlotsPerThread in all) between the
// copy and the scatter.
template <bool Vec>
__global__ void __launch_bounds__(kCompactThreads)
mini_compact_kernel(const uint32_t* __restrict__ alo,
                    const uint32_t* __restrict__ ahi,
                    const uint32_t* __restrict__ shc,
                    uint32_t* __restrict__ out, int seg_words) {
  constexpr int W = Vec ? 4 : 1;
  constexpr int kGroups = kSlotsPerThread / (2 * W);
  __shared__ __align__(16) uint32_t seg[kMaxSlots];
  const int n = 2 * seg_words;
  const int64_t in0 = static_cast<int64_t>(blockIdx.x) * seg_words;
  uint32_t val[kSlotsPerThread], sh[kSlotsPerThread];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int g = threadIdx.x + k * kCompactThreads;
    uint32_t* v = val + k * 2 * W;
    uint32_t* s = sh + k * 2 * W;
    if (g * W >= seg_words) {
#pragma unroll
      for (int j = 0; j < 2 * W; ++j) s[j] = 0;
      continue;
    }
    uint32_t lo[W], hi[W], sw[W];
    load_words<W>(alo + in0 + g * W, lo);
    load_words<W>(ahi + in0 + g * W, hi);
    load_words<W>(shc + in0 + g * W, sw);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      v[2 * w] = (lo[w] & 0xFFFFu) | (hi[w] << 16);
      v[2 * w + 1] = (lo[w] >> 16) | (hi[w] & 0xFFFF0000u);
      s[2 * w] = sw[w] & 0xFFFFu;
      s[2 * w + 1] = sw[w] >> 16;
    }
    if constexpr (Vec) {
      uint4* dst = reinterpret_cast<uint4*>(seg + 2 * W * g);
      dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
      dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
    } else {
      *reinterpret_cast<uint2*>(seg + 2 * g) = make_uint2(v[0], v[1]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int p0 = 2 * W * (threadIdx.x + k * kCompactThreads);
#pragma unroll
    for (int j = 0; j < 2 * W; ++j) {
      const uint32_t s = sh[k * 2 * W + j];
      if (s != 0 && s <= static_cast<uint32_t>(p0 + j)) {
        seg[p0 + j - static_cast<int>(s)] = val[k * 2 * W + j];
      }
    }
  }
  __syncthreads();
  if constexpr (Vec) {
    const uint4* src = reinterpret_cast<const uint4*>(seg);
    uint4* dst = reinterpret_cast<uint4*>(out + 2 * in0);
    for (int i = threadIdx.x; i < n / 4; i += kCompactThreads) {
      __stcs(dst + i, src[i]);
    }
  } else {
    for (int p = threadIdx.x; p < n; p += kCompactThreads) {
      __stcs(out + 2 * in0 + p, seg[p]);
    }
  }
}

// P10 and P11: one thread per column of a row (a 16-byte vector of four
// int32 where rows allow it, else one element), kRowsInFlight rows apart
// per thread, so the row and column come from the launch and no index
// is divided. The vector path needs L % 4 == 0 (every row then starts on
// 16 bytes, the base being 16-byte aligned); other widths take the
// scalar path of the same kernel.
struct RowTiles {
  dim3 grid, block;
};

// Threads along the columns (a power of two up to 128), the rest of the
// block's 256 threads along the rows; blocks along x cover the columns,
// along y the row tiles, with no cap short of the grid's own limit.
RowTiles row_tiles(int64_t R, int64_t cols) {
  unsigned tx = 1;
  while (tx < 128 && tx < cols) tx *= 2;
  const unsigned ty = kThreads / tx;
  const int64_t rows_per_block = static_cast<int64_t>(ty) * kRowsInFlight;
  int64_t gy = (R + rows_per_block - 1) / rows_per_block;
  if (gy > 65535) gy = 65535;  // the y-stride loop takes the rest
  return {dim3(static_cast<unsigned>((cols + tx - 1) / tx),
               static_cast<unsigned>(gy)),
          dim3(tx, ty)};
}

// P11: out[r, c] = a[r, L - 1 - c]. Vector path: output vector j of a
// row is input vector L/4 - 1 - j with its four lanes reversed.
__global__ void __launch_bounds__(kThreads)
reverse_lanes_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                     int64_t R, int L, bool vec) {
  const int cols = vec ? L / 4 : L;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int64_t step = static_cast<int64_t>(blockDim.y);
  for (int64_t r0 = static_cast<int64_t>(blockIdx.y) * step * kRowsInFlight +
                    threadIdx.y;
       r0 < R; r0 += static_cast<int64_t>(gridDim.y) * step * kRowsInFlight) {
    if (vec) {
      const int4* src = reinterpret_cast<const int4*>(a);
      int4* dst = reinterpret_cast<int4*>(out);
      int4 v[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int64_t r = r0 + u * step;
        if (r < R) v[u] = __ldg(src + r * cols + (cols - 1 - c));
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int64_t r = r0 + u * step;
        if (r < R) {
          __stcs(dst + r * cols + c, make_int4(v[u].w, v[u].z, v[u].y, v[u].x));
        }
      }
    } else {
      int32_t v[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int64_t r = r0 + u * step;
        if (r < R) v[u] = __ldg(a + r * L + (L - 1 - c));
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int64_t r = r0 + u * step;
        if (r < R) __stcs(out + r * L + c, v[u]);
      }
    }
  }
}

// P10: out[r, c] = out[r, c + L] = a[r, c], each input element or vector
// read once and stored twice.
__global__ void __launch_bounds__(kThreads)
tile_concat_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                   int64_t R, int L, bool vec) {
  const int cols = vec ? L / 4 : L;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int64_t step = static_cast<int64_t>(blockDim.y);
  for (int64_t r0 = static_cast<int64_t>(blockIdx.y) * step * kRowsInFlight +
                    threadIdx.y;
       r0 < R; r0 += static_cast<int64_t>(gridDim.y) * step * kRowsInFlight) {
    if (vec) {
      const int4* src = reinterpret_cast<const int4*>(a);
      int4* dst = reinterpret_cast<int4*>(out);
      int4 v[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int64_t r = r0 + u * step;
        if (r < R) v[u] = __ldg(src + r * cols + c);
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int64_t r = r0 + u * step;
        if (r < R) {
          __stcs(dst + r * 2 * cols + c, v[u]);
          __stcs(dst + r * 2 * cols + cols + c, v[u]);
        }
      }
    } else {
      int32_t v[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int64_t r = r0 + u * step;
        if (r < R) v[u] = __ldg(a + r * L + c);
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int64_t r = r0 + u * step;
        if (r < R) {
          __stcs(out + r * 2 * L + c, v[u]);
          __stcs(out + r * 2 * L + L + c, v[u]);
        }
      }
    }
  }
}

int done() { return static_cast<int>(cudaGetLastError()); }

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// Every entry point takes device pointers, sizes and the stream, launches
// on that stream and returns the launch error code (0 on success), or
// cudaErrorInvalidValue for a shape its kernel does not take.
extern "C" {

// P1, P7. x, out: (R, L) int32; dyn_shift: null, or one device int32 read
// at run time in place of shift (P7). np.roll semantics.
int probe_roll(const void* x, void* out, int64_t R, int L, int axis,
               int shift, const void* dyn_shift, void* stream) {
  if (R < 1 || L < 1 || L > kTileElems || (axis != 0 && axis != 1)) {
    return invalid();
  }
  const int rows_per_block = kTileElems / L;
  const int64_t blocks = (R + rows_per_block - 1) / rows_per_block;
  roll_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), R, L,
      rows_per_block, axis, shift, static_cast<const int32_t*>(dyn_shift));
  return done();
}

// P2 (elem_bytes 4), P6 (elem_bytes 2): out[p] = x[(p + k) mod n],
// 0 <= k < n.
int probe_flat_shift(const void* x, void* out, int64_t n, int64_t k,
                     int elem_bytes, void* stream) {
  if (n < 1 || k < 0 || k >= n) return invalid();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    flat_shift_kernel<int32_t><<<grid_for(n), kThreads, 0, st>>>(
        static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n, k);
  } else if (elem_bytes == 2) {
    flat_shift_kernel<uint16_t><<<grid_for(n), kThreads, 0, st>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), n, k);
  } else {
    return invalid();
  }
  return done();
}

// P3, P9 (elem_bytes 4), P12 (elem_bytes 2): out[2i] = a[i],
// out[2i + 1] = b[i], i < n. out 8-byte (int32) or 4-byte (u16) aligned.
int probe_interleave(const void* a, const void* b, void* out, int64_t n,
                     int elem_bytes, void* stream) {
  if (n < 1) return invalid();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    interleave32_kernel<<<grid_for(n), kThreads, 0, st>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        static_cast<int2*>(out), n);
  } else if (elem_bytes == 2) {
    interleave16_kernel<<<grid_for(n), kThreads, 0, st>>>(
        static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
        static_cast<uint32_t*>(out), n);
  } else {
    return invalid();
  }
  return done();
}

// P4. x: (nstep, step_rows, L) int32 and out: (out_rows, L) int32, both
// 16-byte aligned; offs: nstep device int32 row offsets, each in
// [0, out_rows - step_rows] (the caller checks). Every row of out is
// written: the last step that covers it, plus 1000 * step, or zeros.
int probe_dyn_write(const void* x, const void* offs, void* out, int nstep,
                    int step_rows, int L, int64_t out_rows, void* stream) {
  if (nstep < 1 || step_rows < 1 || L < 1 || out_rows < 1) return invalid();
  const bool vec = L % 4 == 0;
  const int cols = vec ? L / 4 : L;
  const int64_t tile = static_cast<int64_t>(kRowWarps) * kRowsInFlight;
  int64_t gy = (out_rows + tile - 1) / tile;
  if (gy > 65535) gy = 65535;  // the row-stride loop takes the rest
  const size_t smem = nstep <= kOffsCap ? nstep * sizeof(int32_t) : 0;
  dyn_write_kernel<<<dim3(static_cast<unsigned>((cols + 31) / 32),
                          static_cast<unsigned>(gy)),
                     dim3(32, kRowWarps), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(offs),
      static_cast<int32_t*>(out), nstep, step_rows, L, out_rows, vec);
  return done();
}

// P5: copies nbytes (a multiple of 4, at least 4) from src to dst, both
// 16-byte aligned, in one launch: u32 words become their little-endian
// u16 pairs, or back.
int probe_reinterpret(const void* src, void* dst, int64_t nbytes,
                      void* stream) {
  if (nbytes < 4 || nbytes % 4) return invalid();
  const int64_t n_vec = nbytes / 16;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kCopyVectors;
  const int64_t grid = n_vec ? (n_vec + per_block - 1) / per_block : 1;
  if (grid > 0x7fffffffLL) return invalid();
  vec_copy_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n_vec,
      nbytes);
  return done();
}

// P8. alo, ahi, shc: n_seg segments of seg_words u32 words each, read as
// u16 streams of 2 * seg_words <= 4096 slots; out: n_seg * 2 * seg_words
// u32. All four 16-byte aligned. Every slot p of a segment keeps its
// value lo | hi << 16, and then each slot with shift s > 0 puts it at
// p - s of the same segment (shifts stay inside it and never collide).
int probe_mini_compact(const void* alo, const void* ahi, const void* shc,
                       void* out, int64_t n_seg, int seg_words, void* stream) {
  if (n_seg < 1 || seg_words < 1 || 2 * seg_words > kMaxSlots ||
      n_seg > 0x7fffffffLL) {
    return invalid();
  }
  const unsigned grid = static_cast<unsigned>(n_seg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* lo = static_cast<const uint32_t*>(alo);
  const uint32_t* hi = static_cast<const uint32_t*>(ahi);
  const uint32_t* sh = static_cast<const uint32_t*>(shc);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (seg_words % 4 == 0) {
    mini_compact_kernel<true><<<grid, kCompactThreads, 0, st>>>(lo, hi, sh, o,
                                                               seg_words);
  } else {
    mini_compact_kernel<false><<<grid, kCompactThreads, 0, st>>>(lo, hi, sh, o,
                                                                seg_words);
  }
  return done();
}

// P10. a: (R, L) int32; out: (R, 2L) int32 = [a | a] along the lanes.
// Both 16-byte aligned; L < 2^31.
int probe_tile_concat(const void* a, void* out, int64_t R, int64_t L,
                      void* stream) {
  if (R < 1 || L < 1 || L > 0x7fffffffLL) return invalid();
  const bool vec = L % 4 == 0;
  const RowTiles t = row_tiles(R, vec ? L / 4 : L);
  tile_concat_kernel<<<t.grid, t.block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<int32_t*>(out), R,
      static_cast<int>(L), vec);
  return done();
}

// P11. a, out: (R, L) int32, 16-byte aligned; out[r, c] = a[r, L - 1 - c];
// L < 2^31.
int probe_reverse_lanes(const void* a, void* out, int64_t R, int64_t L,
                        void* stream) {
  if (R < 1 || L < 1 || L > 0x7fffffffLL) return invalid();
  const bool vec = L % 4 == 0;
  const RowTiles t = row_tiles(R, vec ? L / 4 : L);
  reverse_lanes_kernel<<<t.grid, t.block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<int32_t*>(out), R,
      static_cast<int>(L), vec);
  return done();
}

}  // extern "C"
