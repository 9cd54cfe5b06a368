"""Single-map pixel-interleaved geometry decode (framework extension).

``asps_pixel_deinterleaving_flag`` (the reference asserts it false,
``reader.rs:1066``, and rec0 excludes the profile): the stream codes
ONE map whose geometry video interleaves the near/far surfaces on the
pixel parity checkerboard — the sample at (x, y) is the NEAR depth
(D0) when (x + y) is even and the FAR depth (D1) when odd. The
reference offers no reconstruction to mirror, so this framework
defines the derivation (pinned by the fixture/encoder/tests triple,
like raw/EOM/PLR):

- Every 4-neighbor of a pixel has the OPPOSITE parity, so for an
  even-parity pixel the occupied 4-neighborhood carries far-surface
  samples and vice versa.
- The missing map at each occupied pixel derives from that
  neighborhood in the video-depth domain (mode-agnostic — the patch's
  projection handling applies downstream):

      D1[even pixel] = max(v, max occupied 4-neighbor samples)
      D0[odd pixel]  = min(v, min occupied 4-neighbor samples)

  taking the pixel's own sample as the bound keeps D0 <= D1; a pixel
  with no occupied neighbor degenerates to D0 = D1 (its single point
  survives duplicate suppression).

The derivation runs ONCE on the host per frame (vectorized shifts at
canvas scale, far below device-dispatch cost) and produces ordinary
two-map D0/D1 planes — every downstream consumer (oracle, XLA kernels,
device dispatch, attribute transfer) is untouched and the decode stays
bit-exact across paths by construction.
"""

from __future__ import annotations

import numpy as np


def shift2d(arr: np.ndarray, dy: int, dx: int, fill):
    """``arr`` translated by (dy, dx) with ``fill`` at the exposed edge
    — the shared neighborhood primitive of the deinterleave and the
    PBF occupancy-synthesis filters."""
    H, W = arr.shape
    out = np.full((H, W), fill, dtype=arr.dtype)
    ys_dst = slice(max(0, -dy), H - max(0, dy))
    xs_dst = slice(max(0, -dx), W - max(0, dx))
    ys_src = slice(max(0, dy), H - max(0, -dy))
    xs_src = slice(max(0, dx), W - max(0, -dx))
    out[ys_dst, xs_dst] = arr[ys_src, xs_src]
    return out


def deinterleave_geometry(plane: np.ndarray, occ_canvas: np.ndarray):
    """Derive (D0, D1) planes from one pixel-interleaved geometry plane.

    ``plane``: (H, W) uint16 video samples (MSB alignment preserved —
    min/max commute with the shift). ``occ_canvas``: (H, W) occupancy
    at canvas resolution (non-zero = occupied). Returns two (H, W)
    uint16 planes."""
    H, W = plane.shape
    v = plane.astype(np.int64)
    occ = occ_canvas > 0
    parity = (
        np.arange(H, dtype=np.int64)[:, None]
        + np.arange(W, dtype=np.int64)[None, :]
    ) & 1

    BIG = np.int64(1) << 32

    def neighbor_extreme(fill, reduce):
        """min/max of the occupied 4-neighborhood per pixel."""
        masked = np.where(occ, v, fill)
        acc = np.full((H, W), fill, dtype=np.int64)
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            acc = reduce(acc, shift2d(masked, dy, dx, fill))
        return acc

    nb_max = neighbor_extreme(-BIG, np.maximum)
    nb_min = neighbor_extreme(BIG, np.minimum)

    d1 = np.where(parity == 1, v, np.maximum(v, nb_max))
    d0 = np.where(parity == 0, v, np.minimum(v, nb_min))
    # unoccupied pixels keep the raw sample on both maps (they emit
    # nothing; keeping them v-valued avoids BIG leaking into the planes)
    d0 = np.where(occ, d0, v)
    d1 = np.where(occ, d1, v)
    return d0.astype(np.uint16), d1.astype(np.uint16)


def upsample_occupancy_full(occ_plane: np.ndarray, precision: int):
    """Nearest-neighbour occupancy upscale of the FULL plane (no crop;
    the tile-aware oracle variant lives in reconstruction.oracle)."""
    if precision == 1:
        return occ_plane
    return np.repeat(np.repeat(occ_plane, precision, axis=0),
                     precision, axis=1)
