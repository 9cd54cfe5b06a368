// K2W: the wide words stage, with the cat-row gather fused in.
//
// Replaces the Pallas kernel tpu_vpcc/ops/pallas_kernels.py::
// _payload_kernel together with its wrapper's per-pixel interleave
// (tiles_to_payload_pallas), and computes what the wide branch of
// tpu_vpcc/ops/tiled.py::_grids_to_words computes before smoothing, which
// is more than _payload_kernel does: trailing-layer passes (drop_map0),
// one map, relative D1 and the inverse 45-degree rotation of patches on
// additional planes. Per owned group (one row of the (F, G, n_fields)
// field table) it reads the group's cat row straight from the packed,
// host-oriented cat by G_BLOCKID, so the gathered tiles are never written
// out, and per pixel it
//   - unpacks d0, d1 and the occupancy bit (plane A) and the two maps'
//     colour samples (planes B and C);
//   - turns depth into the normal coordinate (projection mode, D1 shift),
//     and the pixel's patch raster into tangent and bitangent;
//   - drops a D1 point equal to its D0 point and sets validity;
//   - assembles x, y, z from the axis permutation, applies the inverse
//     45-degree rotation when the dispatch has additional planes;
//   - writes both maps' words interleaved: w0 = x | y << 16,
//     w1 = z | cy << 16, w2 = cu | cv << 16, and the validity byte.
// The outputs are (F, S) with S = G * 2 * res^2, in emission order:
// group-major, patch raster inside the group, the maps interleaved per
// pixel.
//
// Bound: memory bytes, with some integer ALU work. Per pixel it reads
// 12 B of cat and writes two slots of 13 B (three words and a validity
// byte each): about 35 MB per 1280^2 flagship frame, computed from
// shapes. Design: one block per (group, frame), one thread per pixel of
// the group's res x res tile. The group's field row is loaded once into
// shared memory; consecutive threads read consecutive pixels of one cat
// row (coalesced) and write their two interleaved slots as one 8-byte
// store per word and one 2-byte store of validity, so each warp's
// stores are contiguous. No shared-memory staging of the tiles is
// needed: the tile is read once and the writes are already contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxFields = 64;

// Column of each group-table field the kernel reads (the caller passes
// tpu_vpcc.atlas.groups' indices).
struct FieldIdx {
  int valid, d1, mode, t00, lodx, b00, lody, normal, tangent, bitangent,
      blockid, plane;
};
constexpr int kNumFieldIdx = 12;

struct WideParams {
  int64_t gc;       // groups per frame
  int64_t nb;       // cat blocks per frame
  int nf;           // fields per group row
  int res;          // tile edge
  int t2;           // res * res
  int geo_shift;    // depth = sample >> geo_shift
  int absolute_d1;  // D1 map absolute (else relative to D0)
  int two_maps;     // map_count > 1
  int drop_map0;    // trailing-layer pass: D0 slots never emit
  int rot45;        // the dispatch has 45-degree additional planes
  int rot_shift;    // (1 << (geometry_bitdepth_3d - 1)) - 1
};

__device__ __forceinline__ int32_t pack16(int a, int b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) |
                              (static_cast<uint32_t>(b) << 16));
}

// Inverse 45-degree rotation (tpu_vpcc/ops/reconstruct.py::
// apply_inverse_rot45): >> on int is an arithmetic shift (floor).
__device__ __forceinline__ void inverse_rot45(int* c, int plane, int shift) {
  const int x = c[0], y = c[1], z = c[2];
  if (plane == 1) {
    c[0] = (x - z + shift) >> 1;
    c[2] = (x + z - shift) >> 1;
  } else if (plane == 2) {
    c[2] = (z - y + shift) >> 1;
    c[1] = (z + y - shift) >> 1;
  } else if (plane == 3) {
    c[1] = (y - x + shift) >> 1;
    c[0] = (y + x - shift) >> 1;
  }
  c[0] &= 0xFFFF;
  c[1] &= 0xFFFF;
  c[2] &= 0xFFFF;
}

__global__ void __launch_bounds__(kMaxThreads)
wide_words_kernel(const int32_t* __restrict__ fields,
                  const uint32_t* __restrict__ cat, FieldIdx fi,
                  WideParams P, int32_t* __restrict__ w0,
                  int32_t* __restrict__ w1, int32_t* __restrict__ w2,
                  uint8_t* __restrict__ valid) {
  __shared__ int row[kMaxFields];
  const int64_t g = blockIdx.x;
  const int64_t f = blockIdx.y;
  const int32_t* fr = fields + (f * P.gc + g) * P.nf;
  for (int i = threadIdx.x; i < P.nf; i += blockDim.x) row[i] = fr[i];
  __syncthreads();

  const int64_t t2 = P.t2;
  const uint32_t* src = cat + (f * P.nb + row[fi.blockid]) * 3 * t2;
  const int64_t slot0 = (f * P.gc + g) * 2 * t2;
  const bool live = row[fi.valid] > 0;
  const int mode = row[fi.mode];
  const int d1p = row[fi.d1];
  const int t00 = row[fi.t00], lodx = row[fi.lodx];
  const int b00 = row[fi.b00], lody = row[fi.lody];
  const int ax_n = row[fi.normal], ax_t = row[fi.tangent];
  const int ax_b = row[fi.bitangent];
  const int plane = row[fi.plane];

  for (int p = threadIdx.x; p < P.t2; p += blockDim.x) {
    const uint32_t ta = src[p];
    const uint32_t tb = src[t2 + p];
    const uint32_t tc = src[2 * t2 + p];
    const int d0 = static_cast<int>(ta & 0x3FFu) >> P.geo_shift;
    const int d1 = static_cast<int>((ta >> 10) & 0x3FFu) >> P.geo_shift;
    const bool occ = ((ta >> 20) & 1u) != 0;

    const int v1 = p / P.res;
    const int u1 = p - v1 * P.res;
    const int tangent = (t00 + lodx * u1) & 0xFFFF;
    const int bitangent = (b00 + lody * v1) & 0xFFFF;
    const int n0 = (mode == 0 ? d0 + d1p : max(d1p, d0) - d0) & 0xFFFF;
    int n1;
    if (P.absolute_d1) {
      n1 = (mode == 0 ? d1 + d1p : max(d1p, d1) - d1) & 0xFFFF;
    } else {
      n1 = (mode == 0 ? n0 + d1 : n0 - d1) & 0xFFFF;
    }
    const bool on = live && occ;
    const uint8_t val0 = (on && !P.drop_map0) ? 1 : 0;
    const uint8_t val1 = (on && P.two_maps && n1 != n0) ? 1 : 0;

    // one-hot assembly on the axis permutation, as the reference sums
    // it (padding rows, all axes 0, sum into x)
    int c0[3], c1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int tb_sum = (ax_t == c ? tangent : 0) + (ax_b == c ? bitangent : 0);
      c0[c] = (ax_n == c ? n0 : 0) + tb_sum;
      c1[c] = (ax_n == c ? n1 : 0) + tb_sum;
    }
    if (P.rot45) {
      inverse_rot45(c0, plane, P.rot_shift);
      inverse_rot45(c1, plane, P.rot_shift);
    }
    const int cy0 = tb & 0x3FF, cu0 = (tb >> 10) & 0x3FF;
    const int cv0 = (tb >> 20) & 0x3FF;
    const int cy1 = tc & 0x3FF, cu1 = (tc >> 10) & 0x3FF;
    const int cv1 = (tc >> 20) & 0x3FF;

    const int64_t s = slot0 + 2 * static_cast<int64_t>(p);
    *reinterpret_cast<int2*>(w0 + s) =
        make_int2(pack16(c0[0], c0[1]), pack16(c1[0], c1[1]));
    *reinterpret_cast<int2*>(w1 + s) =
        make_int2(pack16(c0[2], cy0), pack16(c1[2], cy1));
    *reinterpret_cast<int2*>(w2 + s) =
        make_int2(pack16(cu0, cv0), pack16(cu1, cv1));
    *reinterpret_cast<uchar2*>(valid + s) = make_uchar2(val0, val1);
  }
}

}  // namespace

extern "C" {

// fields: (F, G, nf) int32; cat: (F, nb, 3*res*res) u32 (int32 bit
// patterns), host-oriented (every tile in patch raster order).
// field_idx: host array of the 12 field columns, in FieldIdx order.
// Outputs w0, w1, w2: (F, G*2*res*res) int32; valid: the same shape as
// bytes. Returns the launch error code (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.
int wide_words(const void* fields, const void* cat, const int* field_idx,
               int nf, int64_t F, int64_t G, int64_t nb, int res,
               int geo_shift, int absolute_d1, int two_maps, int drop_map0,
               int rot45, int geometry_bitdepth_3d, void* w0, void* w1,
               void* w2, void* valid, void* stream) {
  if (nf > kMaxFields || nf < 1 || res < 1 || F > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < kNumFieldIdx; ++i) {
    if (field_idx[i] < 0 || field_idx[i] >= nf) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (F == 0 || G == 0) return static_cast<int>(cudaGetLastError());
  FieldIdx fi;
  fi.valid = field_idx[0];
  fi.d1 = field_idx[1];
  fi.mode = field_idx[2];
  fi.t00 = field_idx[3];
  fi.lodx = field_idx[4];
  fi.b00 = field_idx[5];
  fi.lody = field_idx[6];
  fi.normal = field_idx[7];
  fi.tangent = field_idx[8];
  fi.bitangent = field_idx[9];
  fi.blockid = field_idx[10];
  fi.plane = field_idx[11];
  WideParams P;
  P.gc = G;
  P.nb = nb;
  P.nf = nf;
  P.res = res;
  P.t2 = res * res;
  P.geo_shift = geo_shift;
  P.absolute_d1 = absolute_d1;
  P.two_maps = two_maps;
  P.drop_map0 = drop_map0;
  P.rot45 = rot45;
  P.rot_shift = (1 << (geometry_bitdepth_3d - 1)) - 1;
  int threads = ((P.t2 + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid(static_cast<unsigned>(G), static_cast<unsigned>(F));
  wide_words_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fields), static_cast<const uint32_t*>(cat),
      fi, P, static_cast<int32_t*>(w0), static_cast<int32_t*>(w1),
      static_cast<int32_t*>(w2), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
