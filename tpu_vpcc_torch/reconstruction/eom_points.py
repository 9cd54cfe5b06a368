"""EOM-patch point reconstruction (framework extension).

EOM (enhanced occupancy map) codes the in-between points of thick
surfaces: for an occupied pixel the occupancy video carries a multi-bit
codeword whose bits mark which depths strictly between the pixel's D0
and D1 points hold a point. The reference panics on the enabling ASPS
flag (``src/bitstream/reader.rs:1069``) and comments
the whole data path out (``reader.rs:2059-2076``,
``decoder.rs:499-501``); this module implements the 23090-5 §8.3.7.8 /
TMC2-v18 semantics with the codeword container convention pinned by
this repo's encoder/decoder/tests (the reference offers nothing to
diff against and MPEG CTC streams are unavailable here):

- A pixel is occupied iff its occupancy value is non-zero — exactly the
  binarization every regular path already applies (``ops/tiled.py``,
  the native pack, the oracle), so EOM codewords never perturb the
  regular D0/D1 decode.
- EOM codeword = occupancy value − 1. Bit ``j`` (ascending from 0) set
  means a point at depth ``d0 + j + 1`` along the patch normal (the
  projection-mode sign rides :meth:`Patch.generate_normal_coordinate`).
  An occupied pixel with no in-between points codes value 1.
- EOM decode therefore requires the occupancy video at source
  resolution (``occupancy_precision == 1``) — per-pixel codewords
  cannot survive the nearest-neighbour upsample. TMC2's lossless CTC
  configurations couple EOM with occupancyPrecision=1 the same way.
- Attributes: one pixel per EOM point from the EOM patch's 2D region
  of the attribute video, raster order from the region origin. Point
  ``k`` of the region (counting over member patches in epdu order,
  each patch's pixels in its block-major emission order, codeword bits
  ascending) samples Y at raster index ``k``; U/V at the
  chroma-subsampled position.
- EOM points append AFTER the frame's regular points (before raw
  points) and after smoothing. TMC2 interleaves them into the per-pixel
  emission; the tail placement is this framework's device-friendly
  ordering (defined behavior — the reference has none to match).

Host-side NumPy by design, like ``raw_points.py``: EOM points are the
thin in-between tail of thick surfaces, far below device-dispatch
scale, and their per-pixel variable multiplicity (0..8 points) would
break the kernels' fixed two-points-per-pixel slot layout.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..atlas.patches import FrameMeta, inverse_rotate_45_np
from ..v3c.syntax import UnsupportedFeature
from .raw_points import _extract_region


def _block_owner_map(meta: FrameMeta, occ_canvas: np.ndarray) -> np.ndarray:
    """Vectorized twin of the oracle's ``generate_block_to_patch``
    (``src/codec.rs:205-250``): later patches overwrite earlier ones
    (reversed under ``meta.patch_precedence``), ownership gated on any
    occupancy inside the canvas block."""
    res = meta.patches[0].occupancy_resolution if meta.patches else 1
    bw = meta.width // res
    bh = meta.height // res
    blk_occ = (
        occ_canvas[: bh * res, : bw * res]
        .reshape(bh, res, bw, res)
        .any(axis=(1, 3))
        .reshape(-1)
    )
    owner = np.zeros(bw * bh, dtype=np.int64)
    order = (
        range(len(meta.patches) - 1, -1, -1)
        if meta.patch_precedence else range(len(meta.patches))
    )
    for pi in order:
        patch = meta.patches[pi]
        for v0 in range(patch.size_uv0[1]):
            for u0 in range(patch.size_uv0[0]):
                bidx = patch.patch_block_to_canvas_block(u0, v0, bw, bh)
                if blk_occ[bidx]:
                    owner[bidx] = pi + 1
    return owner


def _patch_eom_points(
    meta: FrameMeta,
    patch_index: int,
    owner: np.ndarray,
    occ_canvas: np.ndarray,
    geo_plane0: np.ndarray,
    geo_shift: int,
    width: int,
    tile_size: int,
    left_top: Tuple[int, int],
    geometry_bitdepth_3d: int = 10,
    fix_bit_count=None,
) -> np.ndarray:
    """One member patch's EOM points, (N, 3) uint16, in emission order
    (blocks in patch raster order, pixels in within-block raster order,
    codeword bits ascending)."""
    patch = meta.patches[patch_index]
    res = patch.occupancy_resolution
    bw = meta.width // res
    bh = meta.height // res
    a, b, cx, c, d, cy = patch.orientation_coeffs(res)
    v1g, u1g = np.divmod(np.arange(res * res), res)  # within-block raster
    normal, tangent, bitangent = patch.axes
    lodx, lody = patch.level_of_detail
    out: List[np.ndarray] = []
    for v0 in range(patch.size_uv0[1]):
        for u0 in range(patch.size_uv0[0]):
            bidx = patch.patch_block_to_canvas_block(u0, v0, bw, bh)
            if owner[bidx] != patch_index + 1:
                continue
            u = u0 * res + u1g
            v = v0 * res + v1g
            x = a * u + b * v + cx
            y = c * u + d * v + cy
            codes = occ_canvas[y, x].astype(np.int64)
            codes = np.where(codes > 0, codes - 1, 0)  # codeword = value-1
            if not codes.any():
                continue
            # the signed-permutation affine maps the block onto an
            # axis-aligned rect of the same pixel set — one extraction
            # covers it even on block-tiled planes
            xmin, ymin = x.min(), y.min()
            geo_rect = _extract_region(
                geo_plane0,
                xmin + left_top[0],
                ymin + left_top[1],
                x.max() - xmin + 1,
                y.max() - ymin + 1,
                tile_size,
                width,
            )
            d0 = geo_rect[y - ymin, x - xmin].astype(np.int64) >> geo_shift
            nbits = int(codes.max()).bit_length()
            if fix_bit_count is not None and nbits > fix_bit_count:
                # single-map streams: codewords have a FIXED bit count
                # (asps_eom_fix_bit_count_minus1 + 1); wider values are
                # not decodable content
                raise UnsupportedFeature(
                    f"EOM codeword needs {nbits} bits, the ASPS fixes "
                    f"{fix_bit_count} (single-map EOM)"
                )
            bits = (codes[:, None] >> np.arange(nbits)[None, :]) & 1
            pix, bit = np.nonzero(bits)  # row-major: pixel-major, bit-minor
            depth = d0[pix] + bit + 1
            if patch.projection_mode == 0:
                nrm = depth + patch.d1
            else:
                nrm = np.maximum(patch.d1, depth) - depth
            pos = np.empty((pix.shape[0], 3), dtype=np.uint16)
            pos[:, normal] = (nrm & 0xFFFF).astype(np.uint16)
            pos[:, tangent] = ((u[pix] * lodx + patch.uv1[0]) & 0xFFFF).astype(
                np.uint16
            )
            pos[:, bitangent] = (
                (v[pix] * lody + patch.uv1[1]) & 0xFFFF
            ).astype(np.uint16)
            if patch.axis_of_additional_plane != 0:
                # 45-degree views: EOM points rotate like regular
                # points (framework extension, see atlas.patches)
                pos = inverse_rotate_45_np(
                    patch.axis_of_additional_plane,
                    geometry_bitdepth_3d, pos,
                )
            out.append(pos)
    return (
        np.concatenate(out) if out else np.empty((0, 3), dtype=np.uint16)
    )


def eom_points_for_frame(
    meta: FrameMeta,
    occ_plane: np.ndarray,
    geo_plane0: np.ndarray,
    attr_planes: Optional[List[np.ndarray]],
    geo_shift: int,
    chroma_shift: int,
    width: int,
    occupancy_precision: int,
    tile_size: int = 0,
    left_top: Tuple[int, int] = (0, 0),
    geometry_bitdepth_3d: int = 10,
    fix_bit_count=None,
    aux_attr_planes: Optional[List[np.ndarray]] = None,
    aux_chroma_shift: int = 1,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """All EOM points of one frame, patches in bitstream order.

    ``occ_plane`` is the frame's RAW occupancy plane (never tiled — see
    ``GofData``); geometry/attribute planes may be block-tiled
    (``tile_size > 0``). Returns ``(positions (N, 3) uint16,
    colors16 (N, 3) uint16 or None)``."""
    if not meta.eom_patches:
        z = np.empty((0, 3), dtype=np.uint16)
        return z, (None if attr_planes is None else z.copy())
    if occupancy_precision != 1:
        raise UnsupportedFeature(
            f"EOM patches need per-pixel occupancy codewords "
            f"(occupancy precision 1, stream has {occupancy_precision})"
        )
    lt_x, lt_y = left_top
    occ_canvas = occ_plane[
        lt_y : lt_y + meta.height, lt_x : lt_x + meta.width
    ]
    owner = _block_owner_map(meta, occ_canvas)

    pos_parts: List[np.ndarray] = []
    col_parts: List[np.ndarray] = []
    for ep in meta.eom_patches:
        res = ep.occupancy_resolution
        w_pix = ep.size_u0 * res
        ep_pos: List[np.ndarray] = []
        for m, declared in zip(ep.member_patches, ep.member_points):
            pts = _patch_eom_points(
                meta, m, owner, occ_canvas, geo_plane0, geo_shift,
                width, tile_size, left_top, geometry_bitdepth_3d,
                fix_bit_count,
            )
            if pts.shape[0] != declared:
                raise UnsupportedFeature(
                    f"EOM patch declares {declared} points for member "
                    f"patch {m} but the occupancy codewords decode "
                    f"{pts.shape[0]}"
                )
            ep_pos.append(pts)
        pos = (
            np.concatenate(ep_pos)
            if ep_pos
            else np.empty((0, 3), dtype=np.uint16)
        )
        pos_parts.append(pos)
        if attr_planes is None or pos.shape[0] == 0:
            continue
        # colors: raster order over the EOM patch's attribute region —
        # in the AUXILIARY attribute video for aux-flagged patches
        # (framework extension; coordinates relative to the aux origin)
        if ep.in_aux_video:
            if aux_attr_planes is None:
                raise UnsupportedFeature(
                    "aux-flagged EOM patch but no auxiliary attribute "
                    "video"
                )
            src_planes, src_csh = aux_attr_planes, aux_chroma_shift
            src_tile, src_w = 0, aux_attr_planes[0].shape[1]
            # coordinates are relative to the owning tile's aux band
            x0, y0 = ep.u0 * res, ep.v0 * res + ep.aux_band_y
        else:
            src_planes, src_csh = attr_planes, chroma_shift
            src_tile, src_w = tile_size, width
            x0 = ep.u0 * res + lt_x
            y0 = ep.v0 * res + lt_y
        n = pos.shape[0]
        idx = np.arange(n)
        px = x0 + (idx % w_pix)
        py = y0 + (idx // w_pix)
        h_used = int(py.max()) - y0 + 1
        if src_tile == 0 and (
            y0 + h_used > src_planes[0].shape[0]
            or x0 + w_pix > src_planes[0].shape[1]
        ):
            raise UnsupportedFeature(
                f"EOM attribute region {w_pix}x{h_used} at ({x0},{y0}) "
                f"leaves the {src_planes[0].shape[1]}x"
                f"{src_planes[0].shape[0]} attribute plane"
            )
        ay = _extract_region(
            src_planes[0], x0, y0, w_pix, h_used, src_tile, src_w
        ).reshape(-1)
        col = np.empty((n, 3), dtype=np.uint16)
        col[:, 0] = ay[:n]
        csh = src_csh
        ctile = src_tile >> csh if src_tile else 0
        xc0, yc0 = x0 >> csh, y0 >> csh
        wc = ((x0 + w_pix + (1 << csh) - 1) >> csh) - xc0
        hc = ((y0 + h_used + (1 << csh) - 1) >> csh) - yc0
        cu = _extract_region(
            src_planes[1], xc0, yc0, wc, hc, ctile, src_w >> csh
        )
        cv = _extract_region(
            src_planes[2], xc0, yc0, wc, hc, ctile, src_w >> csh
        )
        col[:, 1] = cu[(py >> csh) - yc0, (px >> csh) - xc0]
        col[:, 2] = cv[(py >> csh) - yc0, (px >> csh) - xc0]
        col_parts.append(col)

    pos = (
        np.concatenate(pos_parts)
        if pos_parts
        else np.empty((0, 3), dtype=np.uint16)
    )
    if attr_planes is None:
        return pos, None
    col = (
        np.concatenate(col_parts)
        if col_parts
        else np.empty((0, 3), dtype=np.uint16)
    )
    return pos, col
