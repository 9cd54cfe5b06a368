"""Exhaustive proof that the port's runtime colour conversion equals the
reference f64 chain over the whole 10-bit input domain, on a torch device.

    python -m tpu_vpcc_torch.tools.verify_color_exact [--quick N] [--device cuda|cpu]

Counterpart of the repository's ``tools/verify_color_exact.py``. The
integer side is :func:`tpu_vpcc_torch.ops.color.rgb8_from_yuv16`, the
conversion the decoder runs on the fetched points, called on packed
``(n, 3)`` YUV samples; a clean run proves that conversion, not a
lookalike built from its tables. Channels r and b depend on (y, v) and
(y, u): all 2^20 pairs in one call. Channel g depends on (y, u, v): all
2^30 triples in 1024 u-slices of 2^20 (y, v) samples (``--quick N``
checks the first N slices only).

The f64 side reproduces ``src/codec.rs:661-687`` operation for operation
on the same device, in eager torch ops, one rounding each, in the op
order of the repository's verifier: ``(y - a) - b`` (g) or ``y + c``
(r, b), then ``/ 1023``, ``* 255``, floor and clamp. The divisor is a
tensor on the device: for a Python-scalar divisor PyTorch's CUDA
``div`` multiplies by the reciprocal, which is not IEEE division.

A card is required unless ``--device cpu`` is named; the run fails on
any mismatch.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..ops.color import (
    B_U_COEF,
    G_U_COEF,
    G_V_COEF,
    R_V_COEF,
    rgb8_from_yuv16,
)
from . import resolve_device

N = 1024  # 10-bit samples
F64 = torch.float64


def _f64_chain(num, den):
    """clamp(floor(num / 1023 * 255), 0, 255) with one rounding per op."""
    x = torch.floor(torch.div(num, den) * 255.0)
    return x.clamp(0.0, 255.0).to(torch.int64)


def _report(name, ref, got, where):
    """Mismatches of one channel; prints the first few."""
    bad = (ref != got.to(torch.int64)).nonzero()
    for row in bad[:5].tolist():
        print(f"  {name} mismatch at {where(row)}: ref "
              f"{int(ref[tuple(row)])} got {int(got[tuple(row)])}")
    return int(bad.shape[0])


def check_rb(device):
    """Channels r and b over all 2^20 (y, chroma) pairs: sample (y, c, c)
    gives r at (y, v = c) and b at (y, u = c). Returns the mismatch
    counts of r and b."""
    y = torch.arange(N, device=device).repeat_interleave(N)
    c = torch.arange(N, device=device).repeat(N)
    rgb = rgb8_from_yuv16(torch.stack([y, c, c], dim=-1).to(torch.int32))
    yf = y.to(F64)
    d = c.to(F64) - 512.0
    den = torch.full((1,), 1023.0, dtype=F64, device=device)
    counts = {}
    for name, coef, col in (("r", R_V_COEF, 0), ("b", B_U_COEF, 2)):
        ref = _f64_chain(yf + coef * d, den)
        counts[name] = _report(
            name, ref, rgb[:, col],
            lambda row: f"y={row[0] // N} chroma={row[0] % N}")
        print(f"channel {name}: {N * N} pairs, {counts[name]} mismatches")
    return counts


def check_g(device, n_slices: int = N):
    """Channel g over ``n_slices`` u-slices of all (y, v): returns the
    mismatch count."""
    y = torch.arange(N, device=device).repeat_interleave(N)
    v = torch.arange(N, device=device).repeat(N)
    yf = y.to(F64)
    bterm = G_V_COEF * (v.to(F64) - 512.0)  # per-v f64 term
    den = torch.full((1,), 1023.0, dtype=F64, device=device)
    yuv = torch.stack([y, torch.zeros_like(y), v], dim=-1).to(torch.int32)
    total = 0
    t0 = time.perf_counter()
    for u in range(n_slices):
        yuv[:, 1] = u
        got = rgb8_from_yuv16(yuv)[:, 1]
        # the reference's scalar f64 term, rounded once as in the chain
        aterm = torch.full((1,), G_U_COEF * (float(u) - 512.0), dtype=F64,
                           device=device)
        ref = _f64_chain((yf - aterm) - bterm, den)
        total += _report(
            "g", ref, got,
            lambda row, u=u: f"y={row[0] // N} u={u} v={row[0] % N}")
        if u % 128 == 127:
            print(f"  g: {u + 1}/{n_slices} u-slices, {total} mismatches, "
                  f"{time.perf_counter() - t0:.1f} s")
    print(f"channel g: {n_slices * N * N} triples, {total} mismatches")
    return total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Exhaustive check of rgb8_from_yuv16 against the f64 "
                    "chain over the 10-bit domain")
    parser.add_argument("--quick", type=int, default=N, metavar="N",
                        help="check the first N u-slices of channel g only")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, or cpu for a run without "
                             "a card)")
    args = parser.parse_args(argv)
    if not 1 <= args.quick <= N:
        parser.error(f"--quick must lie in 1..{N}")
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    counts = check_rb(device)
    counts["g"] = check_g(device, args.quick)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ok = not any(counts.values())
    full = (" (full domain)" if args.quick == N
            else f" ({args.quick}/{N} u-slices of g only)")
    print(f"device {device}: mismatches r={counts['r']} g={counts['g']} "
          f"b={counts['b']} in {time.perf_counter() - t0:.2f} s")
    print(f"RESULT: {'PROVEN EXACT' if ok else 'MISMATCHES FOUND'}{full}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
