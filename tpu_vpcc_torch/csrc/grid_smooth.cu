// Grid smoothing on the card: the cell statistics and the eight-corner
// apply of geometry and colour smoothing.
//
// Replaces no TPU kernel: tpu_vpcc/ops/smoothing.py (_smooth_core,
// _smooth_color_core) smooths with XLA scatters and gathers, not Pallas.
// Their plain PyTorch transcription (ops/smoothing.py: _stats_plain,
// geometry_apply_plain, color_apply_plain) is some 250 small operations a
// pass whose launches cost the host far more than the card's work behind
// them. Here a pass is three launches; the plain functions stay for CPU
// tensors and as the oracle the kernels are held to. Callers: the wide
// path (ops/tiled.py::smooth_words_shards, on one card and on a mesh,
// whose shards' grids ops/smoothing.py::combine_stats adds up) and the
// gather fallback (smooth_flat, smooth_colors_flat).
//
//   smooth_init_kernel   the six int32 grids of n_frames * gw^3 cells, the
//                        rows of one (6, cells) buffer: 0 for the count and
//                        the three sums, BIG for min pid, -BIG for max pid.
//   smooth_stats_kernel  one thread a slot: a valid slot adds 1 to its
//                        cell's count and its payload (a, b, c) to the three
//                        sums, and takes its pid into min and max, with
//                        integer atomics, after the lanes of a warp that
//                        share a cell have folded their updates into one
//                        (__match_any_sync and a tree of shuffles). Integer
//                        adds (mod 2^32), mins and maxes give the same bytes
//                        in any order, so the grids are the plain path's.
//                        The cell id is clipped within the slot's frame
//                        before the frame's base is added, as the per-frame
//                        oracle clips it.
//   smooth_apply_kernel<COLOR>  one thread a slot: the axis
//                        neighbourhood, the eight corners in the reference's
//                        (dz, dy, dx) order, each corner's rounded centroid
//                        from its count and sums, the other-cluster test on
//                        min and max pid, and the move (geometry: the
//                        squared distance to the blend against the
//                        threshold; colour: the corners' luma spread and the
//                        point's luma deviation). A slot that does not move
//                        keeps its input values.
//
// Every // of the plain code floors; C's / truncates toward zero, so
// floor_div floors (the gather path's coordinates may be negative). The
// plain code's int32 arithmetic wraps; here it runs on uint32 so that it
// wraps the same way (signed overflow is undefined in C++).
//
// Bound: memory bytes. The statistics read a byte of validity a slot and,
// of a valid slot, its coordinates, payload, pid and frame (25 B in the
// geometry pass, whose payload is its coordinates), and write 24 B a
// cell; the apply reads each slot's validity and payload and writes its
// three outputs, reads a valid slot's coordinates, pid and frame, and
// reads the six grids of each cell that a valid slot's neighbourhood
// touches. Neighbouring slots of a patch land mostly in the same cells,
// so the grid reads of the apply hit L2, and a warp's atomics meet at few
// addresses: folding them first took the statistics kernel from 0.139 to
// 0.100 ms on a flagship two-frame dispatch (tools/kernel_times.py
// --smooth, NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kBig = 1 << 30;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

// a // b for b > 0, flooring as Python, numpy and torch do
__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// the plain code's _round_div, (num + den // 2) // den, for den > 0
__device__ __forceinline__ int32_t round_div(int32_t num, int32_t den) {
  return floor_div(wadd(num, den / 2), den);
}

struct StatsParams {
  int64_t n;         // slots
  int64_t n_frames;  // grids
  int64_t cells;     // gw^3, one frame's grid
  int64_t gw;        // grid width, cells an axis
  int32_t gs;        // grid size, coordinates a cell
};

struct Grids {
  const int32_t* count;
  const int32_t* sum[3];
  const int32_t* min_p;
  const int32_t* max_p;
};

struct ApplyParams {
  int64_t n;
  int64_t n_frames;
  int64_t cells;
  int64_t gw;
  int32_t gs;
  int32_t thr_a;  // geometry: threshold; colour: threshold_variation
  int32_t thr_b;  // colour: threshold_difference
};

__global__ void __launch_bounds__(kThreads)
smooth_init_kernel(int32_t* __restrict__ grids, int64_t cells_total) {
  // a thread fills four consecutive cells of one row
  const int64_t quads = (cells_total + 3) / 4;
  const bool vec = (cells_total & 3) == 0;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < 6 * quads; j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = j / quads;
    const int64_t c0 = (j - row * quads) * 4;
    const int32_t v = row < 4 ? 0 : (row == 4 ? kBig : -kBig);
    int32_t* dst = grids + row * cells_total + c0;
    if (vec) {
      *reinterpret_cast<int4*>(dst) = make_int4(v, v, v, v);
    } else {
      for (int k = 0; k < 4 && c0 + k < cells_total; ++k) dst[k] = v;
    }
  }
}

// The sums, minimum and maximum over this lane's peers (the lanes of the
// warp with the same cell), left in the peers' lowest lane: a tree over
// each group's ranks, one shuffle a value a round. Every lane of the warp
// takes part.
__device__ __forceinline__ void reduce_peers(unsigned peers, int32_t s[3],
                                             int32_t& lo, int32_t& hi) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);
  while (__any_sync(kFullMask, above != 0)) {
    const int next = __ffs(above);  // 1-based, 0 for none
    const int src = next ? next - 1 : static_cast<int>(lane);
    const int32_t t0 = __shfl_sync(kFullMask, s[0], src);
    const int32_t t1 = __shfl_sync(kFullMask, s[1], src);
    const int32_t t2 = __shfl_sync(kFullMask, s[2], src);
    const int32_t tlo = __shfl_sync(kFullMask, lo, src);
    const int32_t thi = __shfl_sync(kFullMask, hi, src);
    if (next) {
      s[0] = wadd(s[0], t0);
      s[1] = wadd(s[1], t1);
      s[2] = wadd(s[2], t2);
      lo = min(lo, tlo);
      hi = max(hi, thi);
    }
    // odd ranks have handed their values down: they leave the tree
    above &= ~__ballot_sync(kFullMask, rank & 1u);
    rank >>= 1;
  }
}

__global__ void __launch_bounds__(kThreads)
smooth_stats_kernel(const int32_t* __restrict__ xs,
                    const int32_t* __restrict__ ys,
                    const int32_t* __restrict__ zs,
                    const int32_t* __restrict__ pa,
                    const int32_t* __restrict__ pb,
                    const int32_t* __restrict__ pc,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ pid,
                    const int64_t* __restrict__ frame, StatsParams P,
                    int32_t* __restrict__ grids) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  bool live = i < P.n && valid[i] != 0;
  int64_t cid = 0;
  int32_t s[3] = {0, 0, 0};
  int32_t lo = kBig, hi = -kBig;
  if (live) {
    const int64_t f = frame[i];
    // a frame outside the grids is the caller's error: never written
    live = f >= 0 && f < P.n_frames;
    if (live) {
      int64_t local =
          static_cast<int64_t>(floor_div(zs[i], P.gs)) * (P.gw * P.gw) +
          static_cast<int64_t>(floor_div(ys[i], P.gs)) * P.gw +
          floor_div(xs[i], P.gs);
      local = local < 0 ? 0 : (local >= P.cells ? P.cells - 1 : local);
      cid = f * P.cells + local;
      s[0] = pa[i];
      s[1] = pb[i];
      s[2] = pc[i];
      lo = hi = pid[i];
    }
  }
  const unsigned lane = threadIdx.x & 31u;
  // a lane with no slot keys a value no cell id reaches
  const unsigned long long key =
      live ? static_cast<unsigned long long>(cid) : ~0ull - lane;
  const unsigned peers = __match_any_sync(kFullMask, key);
  const int32_t cnt = __popc(peers);
  reduce_peers(peers, s, lo, hi);
  if (!live || __ffs(peers) - 1 != static_cast<int>(lane)) return;
  const int64_t cells_total = P.n_frames * P.cells;
  atomicAdd(grids + cid, cnt);
  atomicAdd(grids + cells_total + cid, s[0]);
  atomicAdd(grids + 2 * cells_total + cid, s[1]);
  atomicAdd(grids + 3 * cells_total + cid, s[2]);
  atomicMin(grids + 4 * cells_total + cid, lo);
  atomicMax(grids + 5 * cells_total + cid, hi);
}

struct Axis {
  int32_t s;     // lower neighbour cell
  int32_t w_hi;  // the upper cell's trilinear weight
  bool ok;       // both cells inside the grid
};

// the plain code's _axis_neighborhood
__device__ __forceinline__ Axis axis_neighbourhood(int32_t coord, int32_t gs,
                                                   int64_t gw) {
  const int32_t c = floor_div(coord, gs);
  const int32_t local = wsub(coord, wmul(c, gs));
  const int32_t s = wadd(c, local < gs / 2 ? -1 : 0);
  const int32_t w_hi =
      wadd(wmul(wsub(coord, wadd(wmul(s, gs), gs / 2)), 2), 1);
  return {s, w_hi, s >= 0 && static_cast<int64_t>(wadd(s, 1)) < gw};
}

template <bool COLOR>
__global__ void __launch_bounds__(kThreads)
smooth_apply_kernel(Grids g, const int32_t* __restrict__ xs,
                    const int32_t* __restrict__ ys,
                    const int32_t* __restrict__ zs,
                    const int32_t* __restrict__ pa,
                    const int32_t* __restrict__ pb,
                    const int32_t* __restrict__ pc,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ pid,
                    const int64_t* __restrict__ frame, ApplyParams P,
                    int32_t* __restrict__ oa, int32_t* __restrict__ ob,
                    int32_t* __restrict__ oc) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= P.n) return;
  const int32_t v[3] = {pa[i], pb[i], pc[i]};
  int32_t b[3] = {0, 0, 0};
  bool move = false;
  if (valid[i] != 0) {
    const int64_t f = frame[i];
    const Axis ax = axis_neighbourhood(xs[i], P.gs, P.gw);
    const Axis ay = axis_neighbourhood(ys[i], P.gs, P.gw);
    const Axis az = axis_neighbourhood(zs[i], P.gs, P.gw);
    if (ax.ok && ay.ok && az.ok && f >= 0 && f < P.n_frames) {
      const int32_t p = pid[i];
      const int64_t base = f * P.cells;
      const int32_t two_gs = 2 * P.gs;
      int32_t V[3] = {0, 0, 0};
      int32_t W = 0;
      bool other = false;
      int32_t y_min = kBig, y_max = -kBig;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int32_t wz = dz ? az.w_hi : wsub(two_gs, az.w_hi);
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int32_t wy = dy ? ay.w_hi : wsub(two_gs, ay.w_hi);
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const int32_t wx = dx ? ax.w_hi : wsub(two_gs, ax.w_hi);
            const int64_t nid = base +
                                static_cast<int64_t>(az.s + dz) * P.gw * P.gw +
                                static_cast<int64_t>(ay.s + dy) * P.gw +
                                (ax.s + dx);
            const int32_t cnt = g.count[nid];
            if (cnt <= 0) continue;  // an empty cell weighs 0
            const int32_t w = wmul(wmul(wx, wy), wz);
            int32_t cen0 = 0;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              const int32_t cen = round_div(g.sum[k][nid], cnt);
              V[k] = wadd(V[k], wmul(w, cen));
              if (k == 0) cen0 = cen;
            }
            W = wadd(W, w);
            other = other || g.min_p[nid] != p || g.max_p[nid] != p;
            if (COLOR) {
              y_min = min(y_min, cen0);
              y_max = max(y_max, cen0);
            }
          }
        }
      }
      const int32_t w_safe = max(W, 1);
#pragma unroll
      for (int k = 0; k < 3; ++k) b[k] = round_div(V[k], w_safe);
      bool gate;
      if (COLOR) {
        const int32_t spread = wsub(y_max, y_min);
        const int32_t d = wsub(v[0], b[0]);
        const int32_t dev = d < 0 ? wsub(0, d) : d;
        gate = spread <= P.thr_a && dev >= P.thr_b;
      } else {
        int32_t dist2 = 0;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int32_t d = wsub(v[k], b[k]);
          dist2 = wadd(dist2, wmul(d, d));
        }
        gate = dist2 >= P.thr_a;
      }
      move = other && W > 0 && gate;
    }
  }
  oa[i] = move ? b[0] : v[0];
  ob[i] = move ? b[1] : v[1];
  oc[i] = move ? b[2] : v[2];
}

unsigned blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

bool bad_grid(int64_t n, int64_t n_frames, int gs, int gw) {
  return n < 0 || n_frames < 1 || gs < 1 || gw < 1 ||
         n / kThreads >= (1ll << 31);
}

}  // namespace

extern "C" {

// The cell statistics of one pass (two launches: the grids'
// initialisation, then the statistics). Slot arrays of n: xs, ys, zs, the
// payload pa, pb, pc and pid int32, valid bytes (0/1), frame int64.
// grids: (6, n_frames * gw^3) int32, written whole: count, sum a, sum b,
// sum c, min pid, max pid. Returns the launch error code (0 on success),
// or cudaErrorInvalidValue for a shape the kernels do not take.
int smooth_stats(const void* xs, const void* ys, const void* zs,
                 const void* pa, const void* pb, const void* pc,
                 const void* valid, const void* pid, const void* frame,
                 int64_t n, int64_t n_frames, int gs, int gw, void* grids,
                 void* stream) {
  if (bad_grid(n, n_frames, gs, gw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  StatsParams P;
  P.n = n;
  P.n_frames = n_frames;
  P.gw = gw;
  P.cells = static_cast<int64_t>(gw) * gw * gw;
  P.gs = gs;
  const int64_t cells_total = n_frames * P.cells;
  const int64_t quads = (cells_total + 3) / 4;
  if (6 * quads / kThreads >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one thread a quad of cells: 24,576 blocks for two frames of 128^3
  smooth_init_kernel<<<blocks_for(6 * quads), kThreads, 0, st>>>(
      static_cast<int32_t*>(grids), cells_total);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  smooth_stats_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(ys),
      static_cast<const int32_t*>(zs), static_cast<const int32_t*>(pa),
      static_cast<const int32_t*>(pb), static_cast<const int32_t*>(pc),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(pid),
      static_cast<const int64_t*>(frame), P, static_cast<int32_t*>(grids));
  return static_cast<int>(cudaGetLastError());
}

// The apply of one pass (one launch). count, s0, s1, s2, min_p, max_p:
// the pass's grids, each n_frames * gw^3 int32. Slot arrays as for
// smooth_stats; color 0: geometry (the payload is xs, ys, zs; thr_a the
// threshold), 1: colour (the payload is cy, cu, cv; thr_a the variation
// threshold, thr_b the difference threshold). Outputs oa, ob, oc: n
// int32, the smoothed payload. Returns as smooth_stats.
int smooth_apply(int color, const void* count, const void* s0,
                 const void* s1, const void* s2, const void* min_p,
                 const void* max_p, const void* xs, const void* ys,
                 const void* zs, const void* pa, const void* pb,
                 const void* pc, const void* valid, const void* pid,
                 const void* frame, int64_t n, int64_t n_frames, int gs,
                 int gw, int thr_a, int thr_b, void* oa, void* ob, void* oc,
                 void* stream) {
  if (bad_grid(n, n_frames, gs, gw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Grids g;
  g.count = static_cast<const int32_t*>(count);
  g.sum[0] = static_cast<const int32_t*>(s0);
  g.sum[1] = static_cast<const int32_t*>(s1);
  g.sum[2] = static_cast<const int32_t*>(s2);
  g.min_p = static_cast<const int32_t*>(min_p);
  g.max_p = static_cast<const int32_t*>(max_p);
  ApplyParams P;
  P.n = n;
  P.n_frames = n_frames;
  P.gw = gw;
  P.cells = static_cast<int64_t>(gw) * gw * gw;
  P.gs = gs;
  P.thr_a = thr_a;
  P.thr_b = thr_b;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GRID_SMOOTH_APPLY_ARGS                                             \
  g, static_cast<const int32_t*>(xs), static_cast<const int32_t*>(ys),     \
      static_cast<const int32_t*>(zs), static_cast<const int32_t*>(pa),    \
      static_cast<const int32_t*>(pb), static_cast<const int32_t*>(pc),    \
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(pid), \
      static_cast<const int64_t*>(frame), P, static_cast<int32_t*>(oa),    \
      static_cast<int32_t*>(ob), static_cast<int32_t*>(oc)
  if (color) {
    smooth_apply_kernel<true><<<blocks_for(n), kThreads, 0, st>>>(
        GRID_SMOOTH_APPLY_ARGS);
  } else {
    smooth_apply_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(
        GRID_SMOOTH_APPLY_ARGS);
  }
#undef GRID_SMOOTH_APPLY_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
