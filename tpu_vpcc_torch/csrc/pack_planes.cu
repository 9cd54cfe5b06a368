// K5: the device pack of the block-tiled sample planes into the cat.
//
// Replaces what tpu_vpcc runs as fused XLA off the TPU (its default
// there): tpu_vpcc/ops/tiled.py::_pack_u32_planes (:1006, not a Pallas
// kernel), the row-wise concat of _pretiled_gather_megarow (:1127) and
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
// Design, simple first: one thread per destination word of the cat, so
// each warp stores 128 contiguous bytes and each plane's region is
// written in order. A thread derives (frame, block, plane, pixel) from
// its word's index, reads the source at the transposed coordinate when
// the block is flagged, and upsamples occupancy and chroma by index
// division. A flagged block's reads are strided, but its 512 B of u16
// samples sit in L1/L2 either way. No shared memory, no atomics: two
// calls on one input give the same bytes, and every word of the output
// is written.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct PackParams {
  int64_t total;  // F * nb * 3 * t2 words
  int64_t nb;     // blocks per frame
  int res;        // block edge
  int t2;         // res * res
  int prec;       // occupancy precision (pixels a cell edge)
  int rp;         // res / prec, the occupancy tile edge
  int cs;         // chroma shift
  int rc;         // res >> cs, the chroma tile edge
  int maps;       // the map axis of the colour planes
  int two_maps;   // map_count > 1
};

__global__ void __launch_bounds__(kThreads)
pack_planes_kernel(const uint8_t* __restrict__ occ,
                   const uint16_t* __restrict__ geo0,
                   const uint16_t* __restrict__ geo1,
                   const uint16_t* __restrict__ ay,
                   const uint16_t* __restrict__ au,
                   const uint16_t* __restrict__ av,
                   const uint8_t* __restrict__ swap, PackParams P,
                   uint32_t* __restrict__ cat) {
  const int64_t o =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (o >= P.total) return;
  const int64_t words = 3 * static_cast<int64_t>(P.t2);
  const int64_t row = o / words;  // f * nb + b
  const int q = static_cast<int>(o - row * words);
  const int k = q / P.t2;
  const int p = q - k * P.t2;
  const int i = p / P.res;
  const int j = p - i * P.res;
  const bool flip = swap[row] != 0;
  const int r = flip ? j : i;
  const int c = flip ? i : j;

  uint32_t w;
  if (k == 0) {
    const int64_t g = row * P.t2 + r * P.res + c;
    const uint32_t d0 = geo0[g];
    const uint32_t d1 = P.two_maps ? static_cast<uint32_t>(geo1[g]) : d0;
    const uint32_t on =
        occ[(row * P.rp + r / P.prec) * P.rp + c / P.prec] != 0 ? 1u : 0u;
    w = d0 | (d1 << 10) | (on << 20);
  } else {
    const int64_t f = row / P.nb;
    const int64_t b = row - f * P.nb;
    const int m = (k == 2 && P.two_maps) ? 1 : 0;
    const int64_t mrow = (f * P.maps + m) * P.nb + b;
    const uint32_t y = ay[mrow * P.t2 + r * P.res + c];
    const int64_t ci = (mrow * P.rc + (r >> P.cs)) * P.rc + (c >> P.cs);
    w = y | (static_cast<uint32_t>(au[ci]) << 10) |
        (static_cast<uint32_t>(av[ci]) << 20);
  }
  cat[o] = w;
}

}  // namespace

extern "C" {

// occ: (F, nb, res/prec, res/prec) u8; geo0, geo1: (F, nb, res, res) u16;
// ay: (F, maps, nb, res, res) u16; au, av: (F, maps, nb, res >> cs,
// res >> cs) u16; swap: (F, nb) u8; all contiguous. cat: (F, nb,
// 3 * res * res) u32, every word written. geo1 and map 1 are read only
// when two_maps. Returns the launch error code (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.
int pack_planes(const void* occ, const void* geo0, const void* geo1,
                const void* ay, const void* au, const void* av,
                const void* swap, int64_t F, int64_t nb, int maps, int res,
                int prec, int chroma_shift, int two_maps, void* cat,
                void* stream) {
  if (F < 0 || nb < 0 || res < 1 || res > 4096 || prec < 1 ||
      res % prec != 0 || chroma_shift < 0 || chroma_shift > 1 ||
      res % (1 << chroma_shift) != 0 || maps < 1 || maps > 2 ||
      (two_maps && maps < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PackParams P;
  P.nb = nb;
  P.res = res;
  P.t2 = res * res;
  P.prec = prec;
  P.rp = res / prec;
  P.cs = chroma_shift;
  P.rc = res >> chroma_shift;
  P.maps = maps;
  P.two_maps = two_maps ? 1 : 0;
  P.total = F * nb * 3 * static_cast<int64_t>(P.t2);
  if (P.total == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (P.total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  pack_planes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(occ), static_cast<const uint16_t*>(geo0),
      static_cast<const uint16_t*>(geo1), static_cast<const uint16_t*>(ay),
      static_cast<const uint16_t*>(au), static_cast<const uint16_t*>(av),
      static_cast<const uint8_t*>(swap), P, static_cast<uint32_t*>(cat));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
