"""Point-local-reconstruction (PLR) point generation (framework
extension).

PLR is V-PCC's single-map thickness recovery: with only the D0
geometry map coded, each patch (or each of its blocks) selects a mode
from the ASPS PLR table — an (interpolate, filling, minimum_depth,
neighbour) tuple — and the decoder derives the missing far-surface
points from the D0 neighborhood. The reference panics on the enabling
ASPS flag (``src/bitstream/reader.rs:1082``) and at
every reconstruction site (``codec.rs:402-403,539-540``); this module
implements the 23090-5 §8.3.6.1.2/§8.3.7.9 syntax with reconstruction
semantics pinned by this repo's encoder/decoder/tests (nothing exists
here to diff TMC2 exactness against):

- ``interpolate``: deltaD = the maximum depth step from the pixel to
  any occupied pixel in its (2r+1)² canvas neighbourhood
  (r = neighbour_minus1 + 1), toward the patch's far surface
  (projection mode 0: deeper; mode 1: shallower), clamped to
  [0, surface_thickness] (the ASPS VPCC-extension bound, which the
  bitstream codes precisely when PLR or pixel interleaving is on).
  Without ``interpolate``, deltaD = 0.
- ``minimum_depth``: deltaD is raised to at least 1 (a far-surface
  point always exists).
- ``filling``: every depth d0+1 .. d0+deltaD emits a point; otherwise
  only d0+deltaD (when deltaD > 0).
- Each derived point takes its pixel's map-0 attribute — the same
  sample its D0 point took.
- PLR points append AFTER the frame's regular points and after
  smoothing (TMC2 interleaves them per pixel; the tail placement is
  this framework's device-friendly ordering, like raw/EOM points).

Host-side NumPy by design: the variable per-pixel multiplicity breaks
the device kernels' fixed two-slots-per-pixel layout, and the
neighborhood max is a handful of vectorized shifted-window passes per
frame, far below device-dispatch scale.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..atlas.patches import FrameMeta, inverse_rotate_45_np
from .eom_points import _block_owner_map
from .raw_points import _extract_region

_NEG = -(10**9)


def _delta_map(
    d0: np.ndarray, occupied: np.ndarray, r: int, sign: int, thickness: int
) -> np.ndarray:
    """Per-pixel max occupied-neighbour depth step toward the far
    surface (``sign=+1`` for projection mode 0, ``-1`` for mode 1),
    clamped to [0, thickness]. Meaningful only at occupied pixels."""
    h, w = d0.shape
    dpad = np.zeros((h + 2 * r, w + 2 * r), np.int32)
    opad = np.zeros((h + 2 * r, w + 2 * r), bool)
    dpad[r : r + h, r : r + w] = d0
    opad[r : r + h, r : r + w] = occupied
    best = np.full((h, w), _NEG, np.int32)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            nd = dpad[dy : dy + h, dx : dx + w]
            no = opad[dy : dy + h, dx : dx + w]
            cand = np.where(no, sign * (nd - d0), _NEG)
            np.maximum(best, cand, out=best)
    return np.clip(best, 0, thickness)


def plr_points_for_frame(
    meta: FrameMeta,
    occ_plane: np.ndarray,
    geo_plane0: np.ndarray,
    attr_planes: Optional[List[np.ndarray]],
    geo_shift: int,
    chroma_shift: int,
    width: int,
    occupancy_precision: int,
    modes: Tuple[Tuple[bool, bool, bool, int], ...],
    thickness: int,
    tile_size: int = 0,
    left_top: Tuple[int, int] = (0, 0),
    geometry_bitdepth_3d: int = 10,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """All PLR-derived points of one frame, patches in bitstream order
    (blocks in patch raster order, pixels raster, depths ascending).

    ``modes`` is the ASPS PLR table as (interpolate, filling,
    minimum_depth, neighbour_minus1) tuples; ``thickness`` the clamp
    bound. Returns ``(positions (N, 3) uint16, colors16 (N, 3) uint16
    or None)``."""
    lt_x, lt_y = left_top
    H, W = meta.height, meta.width
    # canvas-resolution occupancy (nearest-neighbour upsample) and D0
    ys = (lt_y + np.arange(H)) // occupancy_precision
    xs = (lt_x + np.arange(W)) // occupancy_precision
    occupied = occ_plane[np.ix_(ys, xs)] > 0
    d0_canvas = (
        _extract_region(geo_plane0, lt_x, lt_y, W, H, tile_size, width)
        .astype(np.int32)
        >> geo_shift
    )
    owner = _block_owner_map(meta, occupied)
    delta_cache = {}

    def delta(r: int, sign: int) -> np.ndarray:
        key = (r, sign)
        if key not in delta_cache:
            delta_cache[key] = _delta_map(
                d0_canvas, occupied, r, sign, thickness
            )
        return delta_cache[key]

    pos_parts: List[np.ndarray] = []
    pix_parts: List[np.ndarray] = []  # (canvas y, x) per point, for colors
    for patch_index, patch in enumerate(meta.patches):
        if patch.plr_modes is None:
            continue
        res = patch.occupancy_resolution
        bw, bh = W // res, H // res
        a, b, cx, c, d, cy = patch.orientation_coeffs(res)
        v1g, u1g = np.divmod(np.arange(res * res), res)
        normal, tangent, bitangent = patch.axes
        lodx, lody = patch.level_of_detail
        sign = 1 if patch.projection_mode == 0 else -1
        for v0 in range(patch.size_uv0[1]):
            for u0 in range(patch.size_uv0[0]):
                mode = patch.plr_modes[v0 * patch.size_uv0[0] + u0]
                if mode < 0:
                    continue
                bidx = patch.patch_block_to_canvas_block(u0, v0, bw, bh)
                if owner[bidx] != patch_index + 1:
                    continue
                interp, filling, min_depth, nb_m1 = modes[mode]
                u = u0 * res + u1g
                v = v0 * res + v1g
                x = a * u + b * v + cx
                y = c * u + d * v + cy
                occ = occupied[y, x]
                dd = (
                    delta(nb_m1 + 1, sign)[y, x]
                    if interp
                    else np.zeros(res * res, np.int32)
                )
                if min_depth:
                    dd = np.maximum(dd, 1)
                dd = np.where(occ, dd, 0)
                if not dd.any():
                    continue
                base = d0_canvas[y, x]
                if filling:
                    # depths d0+1 .. d0+dd, pixel-major then ascending
                    kmax = int(dd.max())
                    ks = np.arange(1, kmax + 1)
                    sel = ks[None, :] <= dd[:, None]
                    pix, kk = np.nonzero(sel)
                    depth = base[pix] + ks[kk]
                else:
                    pix = np.nonzero(dd)[0]
                    depth = base[pix] + dd[pix]
                if patch.projection_mode == 0:
                    nrm = depth + patch.d1
                else:
                    nrm = np.maximum(patch.d1, depth) - depth
                pos = np.empty((pix.shape[0], 3), dtype=np.uint16)
                pos[:, normal] = (nrm & 0xFFFF).astype(np.uint16)
                pos[:, tangent] = (
                    (u[pix] * lodx + patch.uv1[0]) & 0xFFFF
                ).astype(np.uint16)
                pos[:, bitangent] = (
                    (v[pix] * lody + patch.uv1[1]) & 0xFFFF
                ).astype(np.uint16)
                if patch.axis_of_additional_plane != 0:
                    # 45-degree views: PLR points rotate like regular
                    # points (framework extension, see atlas.patches)
                    pos = inverse_rotate_45_np(
                        patch.axis_of_additional_plane,
                        geometry_bitdepth_3d, pos,
                    )
                pos_parts.append(pos)
                pix_parts.append(
                    np.stack([y[pix] + lt_y, x[pix] + lt_x], axis=1)
                )

    pos = (
        np.concatenate(pos_parts)
        if pos_parts
        else np.empty((0, 3), dtype=np.uint16)
    )
    if attr_planes is None:
        return pos, None
    if pos.shape[0] == 0:
        return pos, np.empty((0, 3), dtype=np.uint16)
    pp = np.concatenate(pix_parts)
    col = np.empty((pos.shape[0], 3), dtype=np.uint16)
    # the planes may be block-tiled: sample via full-plane extraction
    # once (host tail scale)
    ay = _extract_region(attr_planes[0], lt_x, lt_y, W, H, tile_size, width)
    col[:, 0] = ay[pp[:, 0] - lt_y, pp[:, 1] - lt_x]
    csh = chroma_shift
    ctile = tile_size >> csh if tile_size else 0
    xc0, yc0 = lt_x >> csh, lt_y >> csh
    wc = ((lt_x + W + (1 << csh) - 1) >> csh) - xc0
    hc = ((lt_y + H + (1 << csh) - 1) >> csh) - yc0
    cu = _extract_region(
        attr_planes[1], xc0, yc0, wc, hc, ctile, width >> csh
    )
    cv = _extract_region(
        attr_planes[2], xc0, yc0, wc, hc, ctile, width >> csh
    )
    col[:, 1] = cu[(pp[:, 0] >> csh) - yc0, (pp[:, 1] >> csh) - xc0]
    col[:, 2] = cv[(pp[:, 0] >> csh) - yc0, (pp[:, 1] >> csh) - xc0]
    return pos, col
