// K3: the cursor compaction experiment, in one pass with a carried cursor.
//
// Replaces the Pallas kernel tools/compaction_experiment.py::_cursor_kernel
// (run_pallas_cursor). The flat word streams w0, w1, w2 and their validity
// (N = F * S elements) are cut into chunks of kCH = 8192 elements. For chunk
// i, n_i is its valid count, cursor_i = sum_{j<i} n_j and win_i =
// cursor_i / kCH. The TPU's sequential grid copies every chunk, uncompacted,
// to output elements [win_i * kCH, win_i * kCH + kCH) in chunk order, so a
// later chunk overwrites an earlier one, and writes the total count. Every
// window 0..win_last is written (the cursor grows by at most kCH per chunk);
// elements past (win_last + 1) * kCH are unspecified.
//
// Bound: memory bytes. Each chunk reads its 8 KB of validity; the chunks
// that copy read and write 96 KB (three words). Design, one launch on the
// caller's stream after a memset of the scratch:
//   - Blocks run in no order on Hopper, so one block per chunk takes a
//     ticket from an atomic counter: blocks are served in chunk order, and
//     none waits on a chunk whose block is not yet resident.
//   - The block reduces its own n_i with 16-byte loads of the validity.
//   - It publishes its aggregate, then its inclusive prefix, in one 64-bit
//     status word per chunk (two flag bits, the value below them), and
//     reads cursor_i by decoupled look-back: one warp reads 32 predecessors'
//     status words at a time and stops at the nearest inclusive prefix.
//   - It copies its chunk only if it is the last writer of its window:
//     (cursor_i + n_i) / kCH != win_i, or it is the last chunk. Windows are
//     nondecreasing in i, so the last writer's chunk is what the sequential
//     grid leaves there, and no two blocks write the same window: the
//     result is deterministic. The copy uses 16-byte loads and stores.
//   - The last chunk writes the count.
// The last-writer rule moves fewer bytes than the TPU's copy of every
// chunk: about 241 of 448 chunks copy at two 1280^2 flagship frames.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCH = 8192;       // elements per chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kFlagAgg = 1ull << 62;
constexpr unsigned long long kFlagPre = 2ull << 62;
constexpr unsigned long long kFlagMask = 3ull << 62;
constexpr unsigned long long kValueMask = ~kFlagMask;

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ long long warp_sum64(long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum of the four bytes of a word whose bytes are 0 or 1.
__device__ __forceinline__ int byte_sum(unsigned int w) {
  return static_cast<int>((w * 0x01010101u) >> 24);
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ unsigned long long wait_status(
    const unsigned long long* p) {
  unsigned long long s;
  do {
    s = *reinterpret_cast<const volatile unsigned long long*>(p);
  } while ((s & kFlagMask) == 0);
  return s;
}

__global__ void __launch_bounds__(kThreads)
cursor_kernel(const uint8_t* __restrict__ valid, const int4* __restrict__ w0,
              const int4* __restrict__ w1, const int4* __restrict__ w2,
              int4* __restrict__ o0, int4* __restrict__ o1,
              int4* __restrict__ o2, int* __restrict__ count,
              unsigned long long* __restrict__ status,
              unsigned int* __restrict__ ticket, int nc) {
  __shared__ int s_chunk;
  __shared__ int s_warp[kWarps];
  __shared__ long long s_cursor;
  __shared__ int s_n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_chunk = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int i = s_chunk;

  // n_i: 8192 validity bytes, 512 uint4, two per thread
  const uint4* v4 = reinterpret_cast<const uint4*>(
      valid + static_cast<int64_t>(i) * kCH);
  int c = 0;
  for (int k = threadIdx.x; k < kCH / 16; k += kThreads) {
    const uint4 q = v4[k];
    c += byte_sum(q.x) + byte_sum(q.y) + byte_sum(q.z) + byte_sum(q.w);
  }
  c = warp_sum(c);
  if (lane == 0) s_warp[warp] = c;
  __syncthreads();

  if (warp == 0) {
    const int n = warp_sum(lane < kWarps ? s_warp[lane] : 0);
    long long excl = 0;
    if (i == 0) {
      if (lane == 0) publish(status, kFlagPre | static_cast<unsigned long long>(n));
    } else {
      if (lane == 0) {
        publish(status + i, kFlagAgg | static_cast<unsigned long long>(n));
      }
      // decoupled look-back over the predecessors, 32 at a time; chunk 0
      // always holds an inclusive prefix, so the walk stops at or before it
      int j = i - 1;
      while (true) {
        const int jj = j - lane;
        const unsigned long long s =
            jj >= 0 ? wait_status(status + jj) : kFlagPre;
        const unsigned int pre =
            __ballot_sync(0xffffffffu, (s & kFlagMask) == kFlagPre);
        const int first = pre ? __ffs(pre) - 1 : 32;
        const long long val =
            lane <= first ? static_cast<long long>(s & kValueMask) : 0;
        excl += warp_sum64(val);
        if (pre) break;
        j -= 32;
      }
      if (lane == 0) {
        publish(status + i,
                kFlagPre | static_cast<unsigned long long>(excl + n));
      }
    }
    if (lane == 0) {
      s_cursor = excl;
      s_n = n;
    }
  }
  __syncthreads();

  const long long cursor = s_cursor;
  const int n = s_n;
  const long long win = cursor / kCH;
  const bool last_chunk = i == nc - 1;
  if (last_chunk || (cursor + n) / kCH != win) {
    constexpr int kVec = kCH / 4;  // int4 per word per chunk
    const int64_t src = static_cast<int64_t>(i) * kVec;
    const int64_t dst = win * kVec;
    for (int k = threadIdx.x; k < kVec; k += kThreads) {
      const int4 a = w0[src + k];
      const int4 b = w1[src + k];
      const int4 d = w2[src + k];
      o0[dst + k] = a;
      o1[dst + k] = b;
      o2[dst + k] = d;
    }
  }
  if (last_chunk && threadIdx.x == 0) *count = static_cast<int>(cursor + n);
}

}  // namespace

extern "C" {

// Elements per chunk: N must be a positive multiple of it.
int cursor_compact_chunk() { return kCH; }

// valid: N bool bytes; w0, w1, w2: N int32 bit patterns; outputs o0, o1,
// o2: N int32 (past the last written window, unspecified); count: one
// int32. scratch: nc + 1 uint64 (status words and the ticket counter),
// zeroed here on the stream. All pointers 16-byte aligned. Returns the
// launch error code (0 on success), or cudaErrorInvalidValue for a shape
// the kernel does not take.
int cursor_compact(const void* valid, const void* w0, const void* w1,
                   const void* w2, void* o0, void* o1, void* o2, void* count,
                   void* scratch, int64_t N, void* stream) {
  if (N <= 0 || N % kCH != 0 || N > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = static_cast<int>(N / kCH);
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  cudaError_t e =
      cudaMemsetAsync(status, 0, (nc + 1) * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  cursor_kernel<<<nc, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(valid), static_cast<const int4*>(w0),
      static_cast<const int4*>(w1), static_cast<const int4*>(w2),
      static_cast<int4*>(o0), static_cast<int4*>(o1), static_cast<int4*>(o2),
      static_cast<int*>(count), status,
      reinterpret_cast<unsigned int*>(status + nc), nc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
