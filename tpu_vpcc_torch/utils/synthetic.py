"""Synthetic V-PCC scene generation for tests, fixtures and benchmarks.

Builds consistent (patch metadata, occupancy/geometry/attribute planes)
tuples resembling what a real V-PCC encoder produces: non-overlapping
patches packed on the atlas, block-aligned occupancy at video resolution,
D0/D1 geometry with bounded surface thickness, and YUV420 attributes.
The environment carries no MPEG CTC streams, so these scenes (plus the
V3C writer and the lossless HEVC encoder) stand in as conformance
fixtures: the NumPy oracle defines the expected output.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np

from ..atlas.patches import FrameMeta, Patch
from ..v3c.syntax import PatchOrientation


@dataclass
class SyntheticFrame:
    meta: FrameMeta
    occ_plane: np.ndarray  # (H/prec, W/prec) uint8, 0/1
    geo_planes: List[np.ndarray]  # map-interleaved Y planes (H, W) uint16
    attr_planes: List[List[np.ndarray]]  # per map: [y, u, v] uint16
    occupancy_precision: int
    occupancy_resolution: int
    map_count: int
    # auxiliary raw-patch video planes (framework extension): one
    # luma-only geometry plane + one [y, u, v] attribute set per frame,
    # (authored by the JAX package's fixture helpers; None here)
    aux_geo_plane: "np.ndarray" = None
    aux_attr_planes: "List[np.ndarray]" = None


def make_synthetic_frame(
    rng: np.random.Generator,
    width: int = 128,
    height: int = 128,
    occupancy_resolution: int = 16,
    occupancy_precision: int = 4,
    map_count: int = 2,
    n_patches: int = 4,
    frame_index: int = 0,
    occupancy_fill: float = 0.8,
    allow_swap: bool = True,
    geometry_bitdepth_3d: int = 10,
    patches: Optional[List[Patch]] = None,
) -> SyntheticFrame:
    """Generate one consistent frame.

    Patches are placed on a non-overlapping block grid; occupancy is
    random at *video* resolution within patch footprints (so upsampled
    occupancy is block-constant at `occupancy_precision` granularity,
    exactly as real streams behave); geometry D0 is random with D1 =
    D0 + small delta (surface thickness), both stored premultiplied by 4
    in 10-bit planes to mirror the decode-side ``/4`` convention.
    """
    res = occupancy_resolution
    bw, bh = width // res, height // res
    assert width % res == 0 and height % res == 0
    assert res % occupancy_precision == 0

    # --- place patches on the block grid (greedy shelves) ---------------
    if patches is not None:
        # caller-specified patch metadata (e.g. P-frame fixtures whose
        # patches are derived from a reference frame's); only the planes
        # are generated here
        patches = [replace(p) for p in patches]
        meta = FrameMeta(
            frame_index=frame_index, width=width, height=height, patches=patches
        )
        return _fill_planes(
            rng, meta, width, height, occupancy_precision, res, map_count,
            occupancy_fill,
        )
    patches = []
    occupied = np.zeros((bh, bw), dtype=bool)
    attempts = 0
    while len(patches) < n_patches and attempts < 200:
        attempts += 1
        su0 = int(rng.integers(1, max(2, bw // 2)))
        sv0 = int(rng.integers(1, max(2, bh // 2)))
        orientation = (
            PatchOrientation.SWAP
            if allow_swap and rng.random() < 0.4
            else PatchOrientation.DEFAULT
        )
        # canvas footprint in blocks
        fw, fh = (sv0, su0) if orientation == PatchOrientation.SWAP else (su0, sv0)
        if fw > bw or fh > bh:
            continue
        u0 = int(rng.integers(0, bw - fw + 1))
        v0 = int(rng.integers(0, bh - fh + 1))
        if occupied[v0 : v0 + fh, u0 : u0 + fw].any():
            continue
        occupied[v0 : v0 + fh, u0 : u0 + fw] = True
        view_id = int(rng.integers(0, 6))
        max3d = 1 << geometry_bitdepth_3d
        patch = Patch(
            uv0=(u0, v0),
            size_uv0=(su0, sv0),
            uv1=(int(rng.integers(0, 200)), int(rng.integers(0, 200))),
            occupancy_resolution=res,
            patch_orientation=orientation,
        )
        patch.set_view_id(view_id)
        offset_d = int(rng.integers(0, 128))
        if patch.projection_mode == 0:
            patch.d1 = offset_d
        else:
            patch.d1 = max3d - offset_d
        patch.size_d = 255
        patches.append(patch)

    meta = FrameMeta(
        frame_index=frame_index,
        width=width,
        height=height,
        patches=patches,
    )
    return _fill_planes(
        rng, meta, width, height, occupancy_precision, res, map_count,
        occupancy_fill,
    )


def _fill_planes(
    rng: np.random.Generator,
    meta: FrameMeta,
    width: int,
    height: int,
    occupancy_precision: int,
    res: int,
    map_count: int,
    occupancy_fill: float,
) -> SyntheticFrame:
    """Generate consistent occupancy/geometry/attribute planes for a
    given patch layout."""
    patches = meta.patches
    # --- occupancy at video resolution ----------------------------------
    occ_h, occ_w = height // occupancy_precision, width // occupancy_precision
    occ_plane = np.zeros((occ_h, occ_w), dtype=np.uint8)
    for patch in patches:
        for v0 in range(patch.size_uv0[1]):
            for u0 in range(patch.size_uv0[0]):
                # block's canvas rect (pixel coords)
                xs, ys = [], []
                for (u, v) in ((0, 0), (res - 1, 0), (0, res - 1), (res - 1, res - 1)):
                    x, y = patch.patch_to_canvas(
                        u0 * res + u, v0 * res + v, width, height
                    )
                    xs.append(x)
                    ys.append(y)
                x_lo, x_hi = min(xs), max(xs) + 1
                y_lo, y_hi = min(ys), max(ys) + 1
                blk = (
                    rng.random(
                        ((y_hi - y_lo) // occupancy_precision,
                         (x_hi - x_lo) // occupancy_precision)
                    )
                    < occupancy_fill
                ).astype(np.uint8)
                occ_plane[
                    y_lo // occupancy_precision : y_hi // occupancy_precision,
                    x_lo // occupancy_precision : x_hi // occupancy_precision,
                ] = blk

    # --- geometry (monotone surface layers D0 <= D1 <= ...), 10-bit
    # planes carrying depth*4. Small per-layer thickness increments keep
    # real duplicate runs (increment 0) so dedup suppression is
    # exercised on every map pair.
    depth = rng.integers(0, 256, (height, width)).astype(np.uint16)
    geo_planes: List[np.ndarray] = [(depth * 4).astype(np.uint16)]
    # one thickness draw happens even for single-map frames so the RNG
    # sequence (and every seeded fixture downstream) is unchanged from
    # the historical 2-map-only generator
    for _m in range(1, max(map_count, 2)):
        thickness = rng.integers(0, 4, (height, width)).astype(np.uint16)
        depth = np.minimum(depth + thickness, 255).astype(np.uint16)
        if _m < map_count:
            geo_planes.append((depth * 4).astype(np.uint16))

    # --- attribute YUV420, 10-bit ----------------------------------------
    attr_planes: List[List[np.ndarray]] = []
    for m in range(map_count):
        y = rng.integers(0, 1024, (height, width)).astype(np.uint16)
        u = rng.integers(0, 1024, (height // 2, width // 2)).astype(np.uint16)
        v = rng.integers(0, 1024, (height // 2, width // 2)).astype(np.uint16)
        attr_planes.append([y, u, v])

    return SyntheticFrame(
        meta=meta,
        occ_plane=occ_plane,
        geo_planes=geo_planes,
        attr_planes=attr_planes,
        occupancy_precision=occupancy_precision,
        occupancy_resolution=res,
        map_count=map_count,
    )
