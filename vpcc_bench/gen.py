"""The traffic's content: synthetic 8iVFB-like V-PCC frames from a seed.

A frozen copy of the decoder's own synthetic scene generator (patches on
a non-overlapping block grid, block-constant occupancy at video
resolution, D0/D1 geometry with a small surface thickness, 10-bit 4:2:0
attributes), kept here so that a change to the program cannot change
what the benchmark feeds it. It makes plain arrays and imports nothing
of the program: :mod:`vpcc_bench.adapter` builds the program's objects
from them, and :mod:`vpcc_bench.ref` reconstructs from them.

The random draws are the generator's, in its order; only the
occupancy's per-block draws are made in one call per frame, which
yields the same numbers.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List

import numpy as np

#: patch orientations the generator places: the canvas footprint is the
#: patch's own (DEFAULT) or transposed (SWAP)
DEFAULT, SWAP = 0, 1

#: view id -> (normal, tangent, bitangent, projection mode): the six
#: axis-aligned views of rec0 (no 45-degree plane)
VIEW_AXES = {
    0: (0, 2, 1, 0),
    1: (1, 2, 0, 0),
    2: (2, 0, 1, 0),
    3: (0, 2, 1, 1),
    4: (1, 2, 0, 1),
    5: (2, 0, 1, 1),
}

#: columns of :attr:`FramePlain.patches`
(P_U0, P_V0, P_SU0, P_SV0, P_U1, P_V1, P_D1, P_SIZE_D, P_ORIENT, P_VIEW,
 P_NORMAL, P_TANGENT, P_BITANGENT, P_MODE) = range(14)
N_PATCH_COLS = 14


@dataclass
class FramePlain:
    """One frame as plain arrays: ``patches`` (P, 14) int64 in the
    columns above (block units for u0, v0 and the sizes), ``occ``
    (H/prec, W/prec) uint8, ``geo`` one (H, W) uint16 plane per map
    (depth * 4, 10-bit), ``attr`` per map [y, u, v] uint16 10-bit planes
    (chroma at half resolution)."""

    patches: np.ndarray
    occ: np.ndarray
    geo: List[np.ndarray]
    attr: List[List[np.ndarray]]


def make_frame(rng: np.random.Generator, width: int, height: int,
               occupancy_resolution: int, occupancy_precision: int,
               map_count: int, n_patches: int, occupancy_fill: float,
               swap_share: float = 0.4,
               geometry_bitdepth_3d: int = 10) -> FramePlain:
    """One frame, drawing from ``rng`` exactly as the program's
    ``utils.synthetic.make_synthetic_frame`` does with ``allow_swap``."""
    res, prec = occupancy_resolution, occupancy_precision
    bw, bh = width // res, height // res
    if width % res or height % res or res % prec:
        raise ValueError("canvas, block and precision sizes do not divide")

    rows = []
    occupied = np.zeros((bh, bw), dtype=bool)
    attempts = 0
    while len(rows) < n_patches and attempts < 200:
        attempts += 1
        su0 = int(rng.integers(1, max(2, bw // 2)))
        sv0 = int(rng.integers(1, max(2, bh // 2)))
        orient = SWAP if rng.random() < swap_share else DEFAULT
        fw, fh = (sv0, su0) if orient == SWAP else (su0, sv0)
        if fw > bw or fh > bh:
            continue
        u0 = int(rng.integers(0, bw - fw + 1))
        v0 = int(rng.integers(0, bh - fh + 1))
        if occupied[v0:v0 + fh, u0:u0 + fw].any():
            continue
        occupied[v0:v0 + fh, u0:u0 + fw] = True
        view = int(rng.integers(0, 6))
        u1 = int(rng.integers(0, 200))
        v1 = int(rng.integers(0, 200))
        normal, tangent, bitangent, mode = VIEW_AXES[view]
        offset_d = int(rng.integers(0, 128))
        d1 = offset_d if mode == 0 else (1 << geometry_bitdepth_3d) - offset_d
        rows.append((u0, v0, su0, sv0, u1, v1, d1, 255, orient, view,
                     normal, tangent, bitangent, mode))
    patches = np.array(rows, dtype=np.int64).reshape(-1, N_PATCH_COLS)

    # occupancy: per patch, per block in patch raster order, a
    # (res/prec)^2 draw over the block's canvas footprint
    occ = np.zeros((height // prec, width // prec), dtype=np.uint8)
    c = res // prec
    n_blocks = int((patches[:, P_SU0] * patches[:, P_SV0]).sum())
    draws = rng.random(n_blocks * c * c) < occupancy_fill
    blocks = draws.reshape(n_blocks, c, c).astype(np.uint8)
    k = 0
    for p in patches:
        su0, sv0 = int(p[P_SU0]), int(p[P_SV0])
        n = su0 * sv0
        vb, ub = np.divmod(np.arange(n), su0)  # patch block raster
        if p[P_ORIENT] == SWAP:
            bx, by = p[P_U0] + vb, p[P_V0] + ub
        else:
            bx, by = p[P_U0] + ub, p[P_V0] + vb
        tiles = occ.reshape(height // res, c, width // res, c)
        tiles[by, :, bx, :] = blocks[k:k + n]
        k += n

    depth = rng.integers(0, 256, (height, width)).astype(np.uint16)
    geo = [(depth * 4).astype(np.uint16)]
    for m in range(1, max(map_count, 2)):
        thickness = rng.integers(0, 4, (height, width)).astype(np.uint16)
        depth = np.minimum(depth + thickness, 255).astype(np.uint16)
        if m < map_count:
            geo.append((depth * 4).astype(np.uint16))

    attr = []
    for _m in range(map_count):
        y = rng.integers(0, 1024, (height, width)).astype(np.uint16)
        u = rng.integers(0, 1024, (height // 2, width // 2)).astype(np.uint16)
        v = rng.integers(0, 1024, (height // 2, width // 2)).astype(np.uint16)
        attr.append([y, u, v])
    return FramePlain(patches=patches, occ=occ, geo=geo, attr=attr)


def frame_seed(seed: int, k: int) -> int:
    """The seed of frame ``k`` of a pool made from ``seed`` (the program's
    ``models.flagship.example_frames`` convention, ``seed + k``, taken
    modulo 2**64 so that any whole number is a seed)."""
    return (int(seed) + k) % (1 << 64)


#: threads that make a pool's frames: numpy's bulk draws release the
#: interpreter lock
POOL_THREADS = 4


def make_pool(seed: int, config: dict, n_frames: int) -> List[FramePlain]:
    """``n_frames`` distinct frames of ``config``, frame k from
    ``frame_seed(seed, k)``."""
    content = config["content"]

    def one(k):
        return make_frame(
            np.random.default_rng(frame_seed(seed, k)),
            width=config["width"], height=config["height"],
            occupancy_resolution=config["occupancy_resolution"],
            occupancy_precision=config["occupancy_precision"],
            map_count=config["map_count"],
            n_patches=content["n_patches"],
            occupancy_fill=content["occupancy_fill"],
            swap_share=content["swap_share"],
            geometry_bitdepth_3d=config["geometry_bitdepth_3d"],
        )

    with ThreadPoolExecutor(max_workers=POOL_THREADS) as ex:
        return list(ex.map(one, range(n_frames)))
