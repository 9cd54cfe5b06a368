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

from ..atlas.patches import EomPatch, FrameMeta, Patch, RawPatch
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
    # authored by plant_raw_patch(aux=...) / plant_eom_patch(aux=...)
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


def ensure_aux_planes(sf: SyntheticFrame, size=(64, 64)) -> None:
    """Allocate the frame's auxiliary video planes (zeros) if absent:
    a luma-only geometry plane plus a 4:2:0 attribute set."""
    if sf.aux_geo_plane is not None:
        return
    h, w = size
    sf.aux_geo_plane = np.zeros((h, w), np.uint16)
    sf.aux_attr_planes = [
        np.zeros((h, w), np.uint16),
        np.zeros((h // 2, w // 2), np.uint16),
        np.zeros((h // 2, w // 2), np.uint16),
    ]


def plant_raw_patch(
    rng: np.random.Generator,
    sf: SyntheticFrame,
    region_blocks: tuple,
    n_points: int,
    offsets: tuple = (0, 0, 0),
    geo_shift: int = 2,
    aux: bool = False,
    aux_size=(64, 64),
) -> RawPatch:
    """Author one raw patch on a synthetic frame (framework extension).

    Plants ``3 * n_points`` coordinate samples into the map-0 geometry
    plane over the region's pixel raster (three consecutive runs: x, y,
    z — the layout ``reconstruction/raw_points.py`` reads back) and one
    attribute pixel per point, then appends the :class:`RawPatch` to
    ``sf.meta.raw_patches``. ``region_blocks`` = (u0, v0, size_u0,
    size_v0) in block units; the caller keeps it off regular patches.
    Values are stored MSB-aligned (``<< geo_shift``), so coordinates
    span ``[0, 2**(10 - geo_shift))`` before the 3D offset. Occupancy
    over the used pixels is set to 1 (as a real encoder would) — the
    decoder must ignore occupied blocks no patch owns.
    """
    u0, v0, su0, sv0 = region_blocks
    res = sf.occupancy_resolution
    x0, y0, w, h = u0 * res, v0 * res, su0 * res, sv0 * res
    assert 3 * n_points <= w * h, "region too small"
    cmax = 1 << (10 - geo_shift)
    coords = rng.integers(0, cmax, (3, n_points)).astype(np.uint16)

    if aux:
        # auxiliary-video raw patch (framework extension): runs and
        # colors live in the aux planes, region coords relative to the
        # aux video origin; the MAIN canvas/occupancy stay untouched
        ensure_aux_planes(sf, aux_size)
        geo = sf.aux_geo_plane
        assert y0 + h <= geo.shape[0] and x0 + w <= geo.shape[1], (
            "aux region leaves the aux video"
        )
    else:
        geo = sf.geo_planes[0]
    flat = coords.reshape(-1) << geo_shift  # [x run | y run | z run]
    idx = np.arange(3 * n_points)
    px, py = x0 + idx % w, y0 + idx // w
    geo[py, px] = flat
    if not aux:
        # occupancy 1 over every used geometry/attribute pixel
        prec = sf.occupancy_precision
        sf.occ_plane[py // prec, px // prec] = 1

    ay, au, av = (
        sf.aux_attr_planes if aux else sf.attr_planes[0]
    )
    csh = 0 if au.shape == ay.shape else 1
    pxa, pya = px[:n_points], py[:n_points]
    ay[pya, pxa] = rng.integers(0, 1024, n_points).astype(np.uint16)
    au[pya >> csh, pxa >> csh] = rng.integers(0, 1024, n_points).astype(
        np.uint16
    )
    av[pya >> csh, pxa >> csh] = rng.integers(0, 1024, n_points).astype(
        np.uint16
    )

    rp = RawPatch(
        u0=u0, v0=v0, size_u0=su0, size_v0=sv0,
        u1=offsets[0], v1=offsets[1], d1=offsets[2],
        n_points=n_points, occupancy_resolution=res,
        in_aux_video=aux,
    )
    sf.meta.raw_patches.append(rp)
    return rp


def plant_eom_patch(
    rng: np.random.Generator,
    sf: SyntheticFrame,
    region_blocks: tuple,
    member_patch_indices: List[int],
    eom_fraction: float = 0.5,
    geo_shift: int = 2,
    max_bits: int = 3,
    aux: bool = False,
    aux_size=(64, 64),
) -> EomPatch:
    """Author one EOM patch on a synthetic frame (framework extension).

    For each member patch, a random ``eom_fraction`` of its occupied
    pixels with surface thickness ≥ 2 get an in-between point pattern
    written into the occupancy plane as ``pattern + 1`` (the codeword
    convention ``reconstruction/eom_points.py`` reads back: codeword =
    occupancy value − 1, bit j → a point at depth d0 + j + 1, strictly
    between the pixel's D0 and D1). One attribute pixel per EOM point
    is planted over the region's raster, and the :class:`EomPatch`
    (with the per-member counts) appends to ``sf.meta.eom_patches``.

    Requires ``occupancy_precision == 1`` (per-pixel codewords).
    Two-map frames bound the pattern by the D0..D1 gap; single-map
    frames (no D1 surface) use ``max_bits`` codeword bits — the fixed
    bit count the ASPS codes as ``asps_eom_fix_bit_count_minus1 + 1``.
    ``region_blocks`` = (u0, v0, size_u0, size_v0) in block units; the
    caller keeps it off regular patches.
    """
    assert sf.occupancy_precision == 1, "EOM needs per-pixel occupancy"
    u0r, v0r, su0, sv0 = region_blocks
    res = sf.occupancy_resolution
    width, height = sf.meta.width, sf.meta.height
    geo0 = sf.geo_planes[0]
    geo1 = sf.geo_planes[1] if sf.map_count >= 2 else None
    remaining = su0 * sv0 * res * res  # attribute capacity of the region
    counts: List[int] = []
    for pi in member_patch_indices:
        patch = sf.meta.patches[pi]
        n = 0
        for v0 in range(patch.size_uv0[1]):
            for u0 in range(patch.size_uv0[0]):
                for v1 in range(res):
                    for u1 in range(res):
                        u, v = u0 * res + u1, v0 * res + v1
                        x, y = patch.patch_to_canvas(u, v, width, height)
                        if sf.occ_plane[y, x] == 0:
                            continue
                        if geo1 is not None:
                            d0 = int(geo0[y, x]) >> geo_shift
                            d1 = int(geo1[y, x]) >> geo_shift
                            nb = d1 - d0 - 1
                        else:
                            nb = max_bits
                        if nb <= 0 or rng.random() >= eom_fraction:
                            continue
                        pattern = int(rng.integers(1, 1 << nb))
                        bits = bin(pattern).count("1")
                        if bits > remaining:  # region full — as a real
                            continue  # encoder, stop adding EOM points
                        remaining -= bits
                        sf.occ_plane[y, x] = pattern + 1
                        n += bits
        counts.append(n)

    # attribute pixels over the region raster, one per point; occupancy
    # 1 over the used pixels (as a real encoder would — the decoder must
    # ignore occupied blocks no patch owns). Aux-flagged patches place
    # the region in the AUXILIARY attribute video instead (framework
    # extension): no main-canvas occupancy, coords aux-origin-relative.
    total = sum(counts)
    x0, y0, w = u0r * res, v0r * res, su0 * res
    assert total <= w * sv0 * res, "EOM region too small"
    if aux:
        ensure_aux_planes(sf, aux_size)
        assert (
            y0 + sv0 * res <= sf.aux_attr_planes[0].shape[0]
            and x0 + w <= sf.aux_attr_planes[0].shape[1]
        ), "aux EOM region leaves the aux video"
    if total:
        idx = np.arange(total)
        px, py = x0 + idx % w, y0 + idx // w
        if aux:
            ay, au, av = sf.aux_attr_planes
        else:
            sf.occ_plane[py, px] = 1
            ay, au, av = sf.attr_planes[0]
        csh = 0 if au.shape == ay.shape else 1
        ay[py, px] = rng.integers(0, 1024, total).astype(np.uint16)
        au[py >> csh, px >> csh] = rng.integers(0, 1024, total).astype(
            np.uint16
        )
        av[py >> csh, px >> csh] = rng.integers(0, 1024, total).astype(
            np.uint16
        )

    ep = EomPatch(
        u0=u0r, v0=v0r, size_u0=su0, size_v0=sv0,
        member_patches=list(member_patch_indices),
        member_points=counts,
        occupancy_resolution=res,
        in_aux_video=aux,
    )
    sf.meta.eom_patches.append(ep)
    return ep


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
