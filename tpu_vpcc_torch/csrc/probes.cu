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
//            the last step that covers it, so blocks need no order
//            (probe_dyn_write).
//   P5       u32 -> little-endian u16 pairs and back: on the card a
//            reinterpretation, so the kernel is a 16-byte-vector copy
//            (probe_reinterpret).
//   P8       the 13-stage log-shift compaction network of
//            tools/pallas_probe2.py on u16 streams held in shared memory,
//            one block per segment of up to 4,096 slots (probe_mini_compact).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 8192;     // int32 elements of a roll tile (32 KB)
constexpr int kMaxSlots = 4096;      // P8 slots per segment
constexpr int kCompactThreads = 512;
constexpr int kSlotsPerThread = kMaxSlots / kCompactThreads;

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

// One block per tile of rows_per_block output rows: one thread per row
// finds the last step covering it (scanning the offsets backwards), then
// the block copies that step's row, plus the probe's 1000 * step marker.
__global__ void __launch_bounds__(kThreads)
dyn_write_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ offs,
                 int32_t* __restrict__ out, int nstep, int step_rows, int L,
                 int64_t out_rows, int rows_per_block) {
  __shared__ int owner[kThreads];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t rows_left = out_rows - r0;
  const int rows = rows_left < rows_per_block ? static_cast<int>(rows_left)
                                              : rows_per_block;
  if (threadIdx.x < rows) {
    const int64_t r = r0 + threadIdx.x;
    int o = -1;
    for (int i = nstep - 1; i >= 0; --i) {
      const int64_t off = offs[i];
      if (off <= r && r < off + step_rows) {
        o = i;
        break;
      }
    }
    owner[threadIdx.x] = o;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * L; e += kThreads) {
    const int rr = e / L;
    const int c = e - rr * L;
    const int i = owner[rr];
    if (i < 0) continue;
    const int64_t r = r0 + rr;
    const int64_t src = (static_cast<int64_t>(i) * step_rows + (r - offs[i])) * L;
    out[r * L + c] = x[src + c] + 1000 * i;
  }
}

__global__ void __launch_bounds__(kThreads)
copy16_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
              int64_t n_vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
copy4_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
             int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    dst[i] = src[i];
  }
}

// One block per segment of n = 2 * seg_words u16 slots. lo, hi and s are
// the segment's three u32 word arrays read as little-endian u16 streams
// (the reinterpretation P5 probes). Stage b moves every slot whose shift
// has bit b set down by 2^b; it reads the old streams into registers,
// then writes the new ones, so each stage sees the previous one whole.
__global__ void __launch_bounds__(kCompactThreads)
mini_compact_kernel(const uint16_t* __restrict__ lo_in,
                    const uint16_t* __restrict__ hi_in,
                    const uint16_t* __restrict__ s_in,
                    uint32_t* __restrict__ out, int n, int nb) {
  __shared__ uint16_t lo[kMaxSlots];
  __shared__ uint16_t hi[kMaxSlots];
  __shared__ uint16_t sh[kMaxSlots];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  for (int p = threadIdx.x; p < n; p += kCompactThreads) {
    lo[p] = lo_in[base + p];
    hi[p] = hi_in[base + p];
    sh[p] = s_in[base + p];
  }
  __syncthreads();
  for (int b = 0; b < nb; ++b) {
    const int k = static_cast<int>((1ll << b) % n);
    uint16_t nlo[kSlotsPerThread], nhi[kSlotsPerThread], ns[kSlotsPerThread];
#pragma unroll
    for (int j = 0; j < kSlotsPerThread; ++j) {
      const int p = threadIdx.x + j * kCompactThreads;
      if (p >= n) break;
      int q = p + k;
      if (q >= n) q -= n;
      const uint16_t s_q = sh[q];
      const bool move_in = (s_q >> b) & 1;
      const bool self_mv = (sh[p] >> b) & 1;
      nlo[j] = move_in ? lo[q] : lo[p];
      nhi[j] = move_in ? hi[q] : hi[p];
      ns[j] = move_in ? s_q : (self_mv ? static_cast<uint16_t>(0) : sh[p]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSlotsPerThread; ++j) {
      const int p = threadIdx.x + j * kCompactThreads;
      if (p >= n) break;
      lo[p] = nlo[j];
      hi[p] = nhi[j];
      sh[p] = ns[j];
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < n; p += kCompactThreads) {
    out[base + p] = static_cast<uint32_t>(lo[p]) |
                    (static_cast<uint32_t>(hi[p]) << 16);
  }
}

// P10 and P11: one thread per column of a row (a 16-byte vector of four
// int32 where rows allow it, else one element), kRowsInFlight rows apart
// per thread, so the row and column come from the launch and no index
// is divided. The vector path needs L % 4 == 0 (every row then starts on
// 16 bytes, the base being 16-byte aligned); other widths take the
// scalar path of the same kernel.
constexpr int kRowsInFlight = 4;

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

// P4. x: (nstep, step_rows, L) int32; offs: nstep device int32 row
// offsets, each in [0, out_rows - step_rows]; out: (out_rows, L) int32,
// whose rows no step covers are left as they are.
int probe_dyn_write(const void* x, const void* offs, void* out, int nstep,
                    int step_rows, int L, int64_t out_rows, void* stream) {
  if (nstep < 1 || step_rows < 1 || L < 1 || out_rows < 1) return invalid();
  int rows_per_block = kTileElems / L;
  if (rows_per_block > kThreads) rows_per_block = kThreads;
  if (rows_per_block < 1) rows_per_block = 1;
  const int64_t blocks = (out_rows + rows_per_block - 1) / rows_per_block;
  dyn_write_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(offs),
      static_cast<int32_t*>(out), nstep, step_rows, L, out_rows,
      rows_per_block);
  return done();
}

// P5: copies nbytes (a multiple of 4) from src to dst, both 16-byte
// aligned: u32 words become their little-endian u16 pairs, or back.
int probe_reinterpret(const void* src, void* dst, int64_t nbytes,
                      void* stream) {
  if (nbytes < 4 || nbytes % 4) return invalid();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_vec = nbytes / 16;
  if (n_vec) {
    copy16_kernel<<<grid_for(n_vec), kThreads, 0, st>>>(
        static_cast<const uint4*>(src), static_cast<uint4*>(dst), n_vec);
  }
  const int64_t tail = (nbytes - n_vec * 16) / 4;
  if (tail) {
    copy4_kernel<<<1, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(src) + n_vec * 4,
        static_cast<uint32_t*>(dst) + n_vec * 4, tail);
  }
  return done();
}

// P8. alo, ahi, shc: n_seg segments of seg_words u32 words each, read as
// u16 streams of 2 * seg_words <= 4096 slots; out: n_seg * 2 * seg_words
// u32, the value lo | hi << 16 of every stream slot after nb stages.
int probe_mini_compact(const void* alo, const void* ahi, const void* shc,
                       void* out, int64_t n_seg, int seg_words, int nb,
                       void* stream) {
  if (n_seg < 1 || seg_words < 1 || 2 * seg_words > kMaxSlots || nb < 0 ||
      nb > 16 || n_seg > 0x7fffffffLL) {
    return invalid();
  }
  mini_compact_kernel<<<static_cast<unsigned>(n_seg), kCompactThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(alo), static_cast<const uint16_t*>(ahi),
      static_cast<const uint16_t*>(shc), static_cast<uint32_t*>(out),
      2 * seg_words, nb);
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
