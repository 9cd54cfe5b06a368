"""Occupancy synthesis / patch border filtering (framework extension).

The occupancy-synthesis SEI (H.20.2.18, method_type 1 = PBF) asks the
decoder to refine a lossily coded occupancy map before reconstruction.
The reference can neither parse the payload (``reader.rs:1402-1412``)
nor act on it (``decoder.rs:240-242`` is ``unimplemented!``), so this
framework defines the filter (pinned, like raw/EOM/PLR/45°, by the
fixture/decoder/tests triple):

- The occupancy upsamples to canvas resolution first (nearest
  neighbour, exactly the regular decode's sampling), so synthesis is a
  per-pixel refinement; downstream the stream behaves like an
  occupancy-precision-1 stream.
- A BORDER pixel is an occupied pixel with at least one unoccupied
  4-neighbor. Lossy occupancy errs at patch borders, where it can mark
  pixels whose geometry sample is garbage (the encoder never wrote a
  depth there); interior pixels are trusted.
- Per pass, a border pixel is CLEARED when its depth is more than
  ``threshold`` away from EVERY other occupied pixel in its
  ``(2r+1)²`` window — a depth outlier supported by no neighbour:

      clear(p)  iff  border(p)  and
                     min_{q != p, occupied, |q-p|_inf <= r} |d(p)-d(q)|
                         > threshold

  with threshold = 2^(pbf_log2_threshold_minus1 + 1),
  r = pbf_filter_size_minus1 + 1, and
  passes = pbf_passes_count_minus1 + 1 (the border set is recomputed
  each pass, so clearing can propagate inward pass by pass). A border
  pixel with NO occupied window-mate is kept (an isolated 1-pixel
  patch carries no evidence against itself).

The filter runs ONCE per frame on the host, before any reconstruction
stage, so the oracle and every device kernel consume the SAME
synthesized occupancy — the two paths stay bit-identical by
construction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .pixel_interleave import shift2d, upsample_occupancy_full


@dataclass(frozen=True)
class OccupancySynthesisConfig:
    """PBF parameters from the SEI instance (method_type 1)."""

    threshold: int  # 2^(pbf_log2_threshold_minus1 + 1)
    passes: int     # pbf_passes_count_minus1 + 1
    radius: int     # pbf_filter_size_minus1 + 1


def synthesize_occupancy(
    occ_plane: np.ndarray,
    precision: int,
    d0_plane: np.ndarray,
    geo_shift: int,
    cfg: OccupancySynthesisConfig,
) -> np.ndarray:
    """Apply PBF to one frame: returns the synthesized CANVAS-resolution
    occupancy (uint8 0/1; the caller treats the stream as
    occupancy-precision 1 afterwards)."""
    occ = upsample_occupancy_full(occ_plane, precision) > 0
    H, W = occ.shape
    d = d0_plane.astype(np.int64) >> geo_shift
    r = cfg.radius
    BIG = np.int64(1) << 32

    for _ in range(cfg.passes):
        nb4 = np.zeros((H, W), dtype=np.int32)
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            nb4 += shift2d(occ.astype(np.int32), dy, dx, 0)
        border = occ & (nb4 < 4)
        if not border.any():
            break
        # min |d(p) - d(q)| over occupied window-mates q != p
        min_dev = np.full((H, W), BIG, dtype=np.int64)
        any_mate = np.zeros((H, W), dtype=bool)
        masked = np.where(occ, d, BIG)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dy == 0 and dx == 0:
                    continue
                q = shift2d(masked, dy, dx, BIG)
                has = q != BIG
                dev = np.where(has, np.abs(d - q), BIG)
                min_dev = np.minimum(min_dev, dev)
                any_mate |= has
        clear = border & any_mate & (min_dev > cfg.threshold)
        if not clear.any():
            break
        occ = occ & ~clear
    return occ.astype(np.uint8)
