"""The yardstick for the kernels: the card's peak, the bytes each kernel
must move, and the names that find its launches in a trace.

Frozen here from the program's ``tools/kernel_times.py`` (the published
peak, ``bound_ms``, ``pack_bytes``) and the byte rule its kernel table
uses for the compactions (the validity read once, each valid slot's
operands read and written, the counts written). Every count is taken
per frame from the benchmark's plain arrays and the reference's point
counts, so a run's total is the sum over the frames it decoded, however
the program chunks them.
"""

from __future__ import annotations

import numpy as np

from .gen import P_ORIENT, P_SU0, P_SV0, P_U0, P_V0, SWAP

#: the H100 SXM's memory rate (NVIDIA's data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12

#: a kernel's launches in a trace: the short name its records carry
KERNEL_NAMES = {
    "k1": "compact_narrow_kernel",
    "k1f": "compact_full_kernel",
    "k2w": "wide_words_kernel",
    "k5": "pack_tiles_kernel",
}

#: int32 fields of a group row (the program's group table)
GROUP_FIELDS = 21
#: bytes of a valid slot's compacted operands: narrow words under the
#: 10-bit coordinate packing (position word, colour word); wide words
#: (three)
NARROW_OPERAND_BYTES = 8
WIDE_OPERAND_BYTES = 12


def bound_ms(nbytes: float) -> float:
    """The least time the card could take to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def owned_blocks(patches: np.ndarray, width: int, height: int,
                 res: int) -> int:
    """Canvas blocks that some patch's footprint covers: the frame's
    groups (one per owned block)."""
    cover = np.zeros((height // res, width // res), dtype=bool)
    for p in patches:
        su0, sv0 = int(p[P_SU0]), int(p[P_SV0])
        fw, fh = (sv0, su0) if p[P_ORIENT] == SWAP else (su0, sv0)
        cover[p[P_V0]:p[P_V0] + fh, p[P_U0]:p[P_U0] + fw] = True
    return int(cover.sum())


def bucket(n_live: int, g_cap: int, min_bucket: int = 256) -> int:
    """A GOF's group rows: its largest frame's groups rounded up to
    ``m * 2^e`` with m in 4..7, clamped to the canvas's blocks."""
    n = max(int(n_live), min_bucket, 1)
    if n < g_cap:
        e = max(n.bit_length() - 3, 0)
        n = (-(-n >> e)) << e
    return min(n, g_cap)


def pack_bytes_per_frame(config: dict) -> int:
    """K5: the occupancy, each map's geometry, luma and chroma, and the
    swap mask read once; the cat (three int32 words a pixel) written."""
    W, H = config["width"], config["height"]
    res, prec = config["occupancy_resolution"], config["occupancy_precision"]
    maps = config["map_count"]
    nb = (W // res) * (H // res)
    read = (nb * (res // prec) ** 2 + maps * nb * res * res * 2 + nb
            + maps * (nb * res * res * 2 + 2 * nb * (res // 2) ** 2 * 2))
    return read + nb * 3 * res * res * 4


def gof_bytes(config: dict, patches_per_frame, points_per_frame) -> dict:
    """Bytes each kernel must move over one GOF, by kernel key."""
    W, H = config["width"], config["height"]
    res = config["occupancy_resolution"]
    g_cap = (W // res) * (H // res)
    live = [owned_blocks(p, W, H, res) for p in patches_per_frame]
    g = bucket(max(live), g_cap)
    S = g * res * res * 2
    pts = [int(n) for n in points_per_frame]
    F = len(pts)
    return {
        "k5": F * pack_bytes_per_frame(config),
        "k1": sum(S + 2 * n * NARROW_OPERAND_BYTES + 4 for n in pts),
        "k1f": sum(S + 2 * n * WIDE_OPERAND_BYTES + 4 for n in pts),
        "k2w": sum(g * GROUP_FIELDS * 4 + n_live * 3 * res * res * 4 + S * 13
                   for n_live in live),
    }
