"""Raw-patch point reconstruction (framework extension).

Raw patches carry points that the projection stage could not represent
(isolated/occluded points); their coordinates are stored VERBATIM in the
geometry video and their colors in the attribute video, inside the
patch's 2D region. The reference panics on the enabling ASPS flag
(``src/bitstream/reader.rs:1068``) and comments the
whole data path out (``reader.rs:2042-2057``, ``decoder.rs:495-499``);
this module implements the 23090-5 / TMC2-v18 semantics:

- The region's pixel raster (row-major from the region origin) holds
  ``3 * n_points`` geometry samples as three consecutive runs: all x
  values, then all y values, then all z values. Decoded coordinate =
  ``(sample >> geo_shift) + rpdu_3d_offset`` per axis — the same
  MSB-alignment shift every geometry sample in this container gets
  (``src/codec.rs:532-534``), so in-geometry-video raw coordinates span
  ``2^(container_bitdepth - geo_shift)`` values per axis before the
  offset (full-range raw coordinates belong to auxiliary video, which
  is outside this decoder's envelope).
- The attribute video carries ONE pixel per point over the same raster
  (point i at raster index i): Y at the pixel, U/V at the
  chroma-subsampled position.
- Raw points append AFTER the frame's regular points, per raw patch in
  bitstream order — and after smoothing, which operates on projected
  surfaces only (defined behavior; the reference has none to match).

Host-side NumPy by design: raw patches are a tiny tail (outlier points),
far below any extent where the device pipeline's batched gather/compact
machinery pays for itself.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..atlas.patches import RawPatch
from ..v3c.syntax import UnsupportedFeature


def _extract_region(
    plane: np.ndarray,
    x0: int,
    y0: int,
    w: int,
    h: int,
    tile: int,
    width: int,
) -> np.ndarray:
    """Copy the pixel rect ``[y0:y0+h, x0:x0+w]`` out of a plane that is
    either raster ``(H, W)`` (``tile == 0``) or block-tiled
    ``(n_blocks, tile, tile)`` with blocks raster-ordered over a
    ``width``-wide canvas (the native decoder's tiled layout — see
    ``video/codec.py``)."""
    if tile == 0:
        return plane[y0 : y0 + h, x0 : x0 + w]
    bw = width // tile
    out = np.empty((h, w), dtype=plane.dtype)
    ty0, ty1 = y0 // tile, (y0 + h - 1) // tile
    tx0, tx1 = x0 // tile, (x0 + w - 1) // tile
    for ty in range(ty0, ty1 + 1):
        for tx in range(tx0, tx1 + 1):
            t = plane[ty * bw + tx]
            # intersection of this tile with the region, tile-local
            ylo = max(y0, ty * tile)
            yhi = min(y0 + h, (ty + 1) * tile)
            xlo = max(x0, tx * tile)
            xhi = min(x0 + w, (tx + 1) * tile)
            out[ylo - y0 : yhi - y0, xlo - x0 : xhi - x0] = t[
                ylo - ty * tile : yhi - ty * tile,
                xlo - tx * tile : xhi - tx * tile,
            ]
    return out


def raw_patch_points(
    rp: RawPatch,
    geo_plane: np.ndarray,
    attr_planes: Optional[List[np.ndarray]],
    geo_shift: int,
    chroma_shift: int,
    width: int,
    tile_size: int = 0,
    left_top: Tuple[int, int] = (0, 0),
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Decode one raw patch from the map-0 geometry/attribute planes.

    Returns ``(positions (N, 3) uint16, colors16 (N, 3) uint16 or
    None)``. ``tile_size > 0`` means the planes are block-tiled (the
    device pipeline's native layout; chroma tiles are
    ``tile_size >> chroma_shift``)."""
    res = rp.occupancy_resolution
    n = rp.n_points
    x0 = rp.u0 * res + left_top[0]
    y0 = rp.v0 * res + left_top[1]
    w = rp.size_u0 * res
    h = rp.size_v0 * res
    if tile_size == 0 and (
        y0 + h > geo_plane.shape[0] or x0 + w > geo_plane.shape[1]
    ):
        # raster planes (incl. the auxiliary video, whose dimensions the
        # derivation cannot bound-check) clip silently on slicing
        raise UnsupportedFeature(
            f"raw patch region {w}x{h} at ({x0},{y0}) leaves the "
            f"{geo_plane.shape[1]}x{geo_plane.shape[0]} geometry plane"
        )
    if tile_size == 0 and attr_planes is not None and w > 0:
        # the attribute video is a SEPARATE plane (per-family aux videos
        # may even be sized independently of the aux geometry video) —
        # bound-check the rows the n color pixels actually touch, like
        # the EOM tail does (eom_points.py)
        h_used = (n + w - 1) // w
        if (
            y0 + h_used > attr_planes[0].shape[0]
            or x0 + w > attr_planes[0].shape[1]
        ):
            raise UnsupportedFeature(
                f"raw patch attribute region {w}x{h_used} at ({x0},{y0}) "
                f"leaves the {attr_planes[0].shape[1]}x"
                f"{attr_planes[0].shape[0]} attribute plane"
            )

    vals = _extract_region(geo_plane, x0, y0, w, h, tile_size, width)
    vals = (vals.reshape(-1).astype(np.int64) >> geo_shift)[: 3 * n]
    pos = np.empty((n, 3), dtype=np.uint16)
    pos[:, 0] = ((vals[0:n] + rp.u1) & 0xFFFF).astype(np.uint16)
    pos[:, 1] = ((vals[n : 2 * n] + rp.v1) & 0xFFFF).astype(np.uint16)
    pos[:, 2] = ((vals[2 * n : 3 * n] + rp.d1) & 0xFFFF).astype(np.uint16)

    if attr_planes is None:
        return pos, None
    # one attribute pixel per point, region raster order
    ay = _extract_region(
        attr_planes[0], x0, y0, w, h, tile_size, width
    ).reshape(-1)
    idx = np.arange(n)
    px = x0 + (idx % w)
    py = y0 + (idx // w)
    col = np.empty((n, 3), dtype=np.uint16)
    col[:, 0] = ay[:n]
    csh = chroma_shift
    ctile = tile_size >> csh if tile_size else 0
    # the chroma rect covering the region: floor the origin, ceil the
    # far edge (an occupancy_resolution-1 stream can have odd region
    # corners at 4:2:0)
    xc0, yc0 = x0 >> csh, y0 >> csh
    wc = ((x0 + w + (1 << csh) - 1) >> csh) - xc0
    hc = ((y0 + h + (1 << csh) - 1) >> csh) - yc0
    cu = _extract_region(
        attr_planes[1], xc0, yc0, wc, hc, ctile, width >> csh
    )
    cv = _extract_region(
        attr_planes[2], xc0, yc0, wc, hc, ctile, width >> csh
    )
    col[:, 1] = cu[(py >> csh) - yc0, (px >> csh) - xc0]
    col[:, 2] = cv[(py >> csh) - yc0, (px >> csh) - xc0]
    return pos, col


def raw_points_for_frame(
    raw_patches: List[RawPatch],
    geo_plane: np.ndarray,
    attr_planes: Optional[List[np.ndarray]],
    geo_shift: int,
    chroma_shift: int,
    width: int,
    tile_size: int = 0,
    left_top: Tuple[int, int] = (0, 0),
    aux_geo_plane: Optional[np.ndarray] = None,
    aux_attr_planes: Optional[List[np.ndarray]] = None,
    aux_geo_shift: int = 0,
    aux_chroma_shift: int = 1,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """All raw points of one frame, patches in bitstream order.

    Aux-flagged patches (``rp.in_aux_video``, framework extension) read
    the AUXILIARY video planes instead: raster layout, coordinates
    relative to the owning tile's aux band (``rp.aux_band_y``; 0 for
    single-tile streams)."""
    pos_parts, col_parts = [], []
    for rp in raw_patches:
        if rp.in_aux_video:
            if aux_geo_plane is None or (
                attr_planes is not None and aux_attr_planes is None
            ):
                raise UnsupportedFeature(
                    "aux-flagged raw patch but no auxiliary video planes"
                )
            pos, col = raw_patch_points(
                rp, aux_geo_plane, aux_attr_planes, aux_geo_shift,
                aux_chroma_shift, aux_geo_plane.shape[1],
                left_top=(0, rp.aux_band_y),
            )
        else:
            pos, col = raw_patch_points(
                rp, geo_plane, attr_planes, geo_shift, chroma_shift, width,
                tile_size=tile_size, left_top=left_top,
            )
        pos_parts.append(pos)
        if col is not None:
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
