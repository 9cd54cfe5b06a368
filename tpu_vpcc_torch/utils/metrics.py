"""Point-cloud quality metrics (framework extension).

The MPEG V-PCC workflow evaluates decoders with the ``pc_error`` D1/D2
geometry metrics and per-channel color PSNR; neither the reference nor
this environment ships that tool, so the D1 point-to-point metric is
implemented here for comparing decodes (e.g. smoothed vs unsmoothed, or
this decoder vs another's PLY output via :func:`tpu_vpcc_torch.utils.ply.read_ply`).

D1 follows the standard definition: for each point in A, the squared
Euclidean distance to its nearest neighbor in B; MSE is the mean over A;
the symmetric metric takes the max of both directions; PSNR uses a peak
of ``(2^bitdepth - 1) * sqrt(3)`` squared (the MPEG convention uses the
signal peak over the diagonal of the bounding cube of the coordinate
space).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..reconstruction.pointset import PointSet3


@dataclass
class GeometryMetric:
    mse_ab: float  # A -> B
    mse_ba: float  # B -> A
    mse: float  # symmetric (max of the two)
    psnr: float  # dB, peak = ((2^bitdepth - 1) * sqrt(3))^2


def d1_metric(a: PointSet3, b: PointSet3, bitdepth: int = 10) -> GeometryMetric:
    """Symmetric D1 point-to-point geometry metric between two clouds."""
    from scipy.spatial import cKDTree

    pa = np.asarray(a.positions, dtype=np.float64)
    pb = np.asarray(b.positions, dtype=np.float64)
    if len(pa) == 0 or len(pb) == 0:
        raise ValueError("empty point cloud")
    d_ab, _ = cKDTree(pb).query(pa, k=1, workers=-1)
    d_ba, _ = cKDTree(pa).query(pb, k=1, workers=-1)
    mse_ab = float(np.mean(d_ab**2))
    mse_ba = float(np.mean(d_ba**2))
    mse = max(mse_ab, mse_ba)
    peak2 = 3.0 * ((1 << bitdepth) - 1) ** 2
    psnr = float("inf") if mse == 0 else 10.0 * math.log10(peak2 / mse)
    return GeometryMetric(mse_ab=mse_ab, mse_ba=mse_ba, mse=mse, psnr=psnr)


def color_psnr(a: PointSet3, b: PointSet3) -> dict:
    """Per-channel color PSNR between identically-ordered clouds (or
    clouds matched by nearest neighbor when sizes differ)."""
    ca = np.asarray(a.colors, dtype=np.float64)
    cb = np.asarray(b.colors, dtype=np.float64)
    if len(ca) != len(cb):
        from scipy.spatial import cKDTree

        _, idx = cKDTree(np.asarray(b.positions, np.float64)).query(
            np.asarray(a.positions, np.float64), k=1, workers=-1
        )
        cb = cb[idx]
    out = {}
    for i, name in enumerate(("r", "g", "b")):
        mse = float(np.mean((ca[:, i] - cb[:, i]) ** 2))
        out[name] = float("inf") if mse == 0 else 10.0 * math.log10(255.0**2 / mse)
    return out


def main(argv=None) -> int:
    """``python -m tpu_vpcc_torch.utils.metrics a.ply b.ply`` — D1 + color PSNR."""
    import argparse

    from .ply import read_ply

    parser = argparse.ArgumentParser(description="Point-cloud D1/color metrics")
    parser.add_argument("a")
    parser.add_argument("b")
    parser.add_argument("--bitdepth", type=int, default=10)
    args = parser.parse_args(argv)
    a = read_ply(open(args.a, "rb").read())
    b = read_ply(open(args.b, "rb").read())
    m = d1_metric(a, b, bitdepth=args.bitdepth)
    print(f"D1 mse(A->B)={m.mse_ab:.6f} mse(B->A)={m.mse_ba:.6f} "
          f"mse={m.mse:.6f} psnr={m.psnr:.3f} dB")
    if a.with_colors or len(a.colors):
        c = color_psnr(a, b)
        print("color psnr: " + " ".join(f"{k}={v:.3f}" for k, v in c.items()))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
