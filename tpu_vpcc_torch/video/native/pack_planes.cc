// Host-side sample-plane pack for the cat-mode device dispatch.
//
// Packs the block-tiled occupancy / geometry / attribute planes into the
// three u32 sample planes concatenated row-wise — the exact layout
// tpu_vpcc.ops.tiled.pack_planes_host (numpy) emits and the device's
// mega-row gather consumes (see _gather_tiles cat-mode):
//
//   out[f, b, :T2]      plane A: d0 | d1 << 10 | occ_bit << 20
//   out[f, b, T2:2*T2]  plane B: y0 | u0 << 10 | v0 << 20
//   out[f, b, 2*T2:]    plane C: y1 | u1 << 10 | v1 << 20  (B if mc == 1)
//
// Occupancy and chroma are upsampled nearest-neighbour by index division,
// bit-identical to the reference decoder's sampling
// (src/codec.rs:568-658) and to the numpy/device packs
// (pinned by tests/test_pretiled.py). Element sizes are passed per plane
// family because decoded planes are u8 for 8-bit streams and u16 for
// 10-bit ones (see video/codec.py).
//
// Single-threaded: the pipeline already overlaps host prep across GOFs
// with a thread pool, and real hosts parallelize across frames there.

#include <cstdint>
#include <cstddef>

namespace {

// element types are templated so the hot loops carry no per-element
// size branch and vectorize (u8/u16 per plane family; 3-4x over the
// branching form measured on the flagship shapes)
template <typename O, typename Gt, typename A, bool TWO_MAPS>
void pack_impl(const O* occ, const Gt* geo0, const Gt* geo1, const A* ay,
               const A* au, const A* av, const uint8_t* swap,
               uint32_t* out, int64_t F, int64_t nb, int res, int prec,
               int cshift, int mc) {
  const int rp = res / prec;
  const int rc = res >> cshift;
  const int T2 = res * res;
  const int P2 = rp * rp;
  const int C2 = rc * rc;
  for (int64_t f = 0; f < F; ++f) {
    for (int64_t b = 0; b < nb; ++b) {
      const size_t tb = static_cast<size_t>(f * nb + b);
      const O* o = occ + tb * P2;
      const Gt* g0 = geo0 + tb * T2;
      const Gt* g1 = geo1 + tb * T2;
      const size_t t0 = (static_cast<size_t>(f) * mc) * nb + b;
      const A* y0 = ay + t0 * T2;
      const A* u0 = au + t0 * C2;
      const A* v0 = av + t0 * C2;
      const A *y1 = y0, *u1 = u0, *v1 = v0;
      if (TWO_MAPS) {
        const size_t t1 = (static_cast<size_t>(f) * mc + 1) * nb + b;
        y1 = ay + t1 * T2;
        u1 = au + t1 * C2;
        v1 = av + t1 * C2;
      }
      uint32_t* oa = out + tb * 3 * T2;
      uint32_t* ob = oa + T2;
      uint32_t* oc = ob + T2;
      // host orientation fix folded into the pack: a SWAP-owned block
      // writes transposed (out index x*res+y), which costs nothing in
      // this per-pixel loop — no separate orientation pass needed
      const bool tr = swap != nullptr && swap[tb] != 0;
      const int ostep_x = tr ? res : 1;
      for (int y = 0; y < res; ++y) {
        const O* orow = o + (y / prec) * rp;
        const A* u0r = u0 + (y >> cshift) * rc;
        const A* v0r = v0 + (y >> cshift) * rc;
        const A* u1r = u1 + (y >> cshift) * rc;
        const A* v1r = v1 + (y >> cshift) * rc;
        const int i0 = y * res;
        const int o0 = tr ? y : i0;
        for (int x = 0; x < res; ++x) {
          const int i = i0 + x;
          const int oi = o0 + x * ostep_x;
          const int cx = x >> cshift;
          const uint32_t occ_bit = orow[x / prec] > 0;
          const uint32_t d0 = g0[i];
          const uint32_t d1 = TWO_MAPS ? static_cast<uint32_t>(g1[i]) : d0;
          oa[oi] = d0 | (d1 << 10) | (occ_bit << 20);
          const uint32_t pb = static_cast<uint32_t>(y0[i]) |
                              (static_cast<uint32_t>(u0r[cx]) << 10) |
                              (static_cast<uint32_t>(v0r[cx]) << 20);
          ob[oi] = pb;
          oc[oi] = TWO_MAPS ? (static_cast<uint32_t>(y1[i]) |
                               (static_cast<uint32_t>(u1r[cx]) << 10) |
                               (static_cast<uint32_t>(v1r[cx]) << 20))
                            : pb;
        }
      }
    }
  }
}

template <typename O, typename Gt, typename A>
void pack_maps(const void* occ, const void* geo0, const void* geo1,
               const void* ay, const void* au, const void* av,
               const uint8_t* swap, uint32_t* out, int64_t F, int64_t nb,
               int res, int prec, int cshift, int mc) {
  if (mc > 1)
    pack_impl<O, Gt, A, true>(
        static_cast<const O*>(occ), static_cast<const Gt*>(geo0),
        static_cast<const Gt*>(geo1), static_cast<const A*>(ay),
        static_cast<const A*>(au), static_cast<const A*>(av), swap, out,
        F, nb, res, prec, cshift, mc);
  else
    pack_impl<O, Gt, A, false>(
        static_cast<const O*>(occ), static_cast<const Gt*>(geo0),
        static_cast<const Gt*>(geo1), static_cast<const A*>(ay),
        static_cast<const A*>(au), static_cast<const A*>(av), swap, out,
        F, nb, res, prec, cshift, mc);
}

}  // namespace

extern "C" int vpp_pack_planes(
    const uint8_t* occ, int occ_es,      // (F, nb, rp, rp)
    const uint8_t* geo0,                 // (F, nb, res, res)
    const uint8_t* geo1, int geo_es,     // (F, nb, res, res)
    const uint8_t* ay,                   // (F, mc, nb, res, res)
    const uint8_t* au,                   // (F, mc, nb, rc, rc)
    const uint8_t* av, int attr_es,      // (F, mc, nb, rc, rc)
    const uint8_t* swap,                 // (F, nb) 0/1 or NULL
    uint32_t* out,                       // (F, nb, 3*res*res)
    int64_t F, int64_t nb, int res, int prec, int cshift, int mc) {
  if (res <= 0 || prec <= 0 || res % prec != 0 || cshift < 0 || mc < 1)
    return -1;
  if ((occ_es != 1 && occ_es != 2) || (geo_es != 1 && geo_es != 2) ||
      (attr_es != 1 && attr_es != 2))
    return -1;
  const int key = (occ_es == 2) << 2 | (geo_es == 2) << 1 | (attr_es == 2);
  switch (key) {
    case 0: pack_maps<uint8_t, uint8_t, uint8_t>(occ, geo0, geo1, ay, au, av, swap, out, F, nb, res, prec, cshift, mc); break;
    case 1: pack_maps<uint8_t, uint8_t, uint16_t>(occ, geo0, geo1, ay, au, av, swap, out, F, nb, res, prec, cshift, mc); break;
    case 2: pack_maps<uint8_t, uint16_t, uint8_t>(occ, geo0, geo1, ay, au, av, swap, out, F, nb, res, prec, cshift, mc); break;
    case 3: pack_maps<uint8_t, uint16_t, uint16_t>(occ, geo0, geo1, ay, au, av, swap, out, F, nb, res, prec, cshift, mc); break;
    case 4: pack_maps<uint16_t, uint8_t, uint8_t>(occ, geo0, geo1, ay, au, av, swap, out, F, nb, res, prec, cshift, mc); break;
    case 5: pack_maps<uint16_t, uint8_t, uint16_t>(occ, geo0, geo1, ay, au, av, swap, out, F, nb, res, prec, cshift, mc); break;
    case 6: pack_maps<uint16_t, uint16_t, uint8_t>(occ, geo0, geo1, ay, au, av, swap, out, F, nb, res, prec, cshift, mc); break;
    default: pack_maps<uint16_t, uint16_t, uint16_t>(occ, geo0, geo1, ay, au, av, swap, out, F, nb, res, prec, cshift, mc); break;
  }
  return 0;
}
