"""Hopper probes P1-P4 (kernel library K4 in ``csrc/probes.cu``).

Counterpart of ``tools/pallas_probe.py``, which checked on the TPU the
data movements a shift-network compaction kernel needed from Mosaic. The
same inputs (sizes taken as arguments, defaulting to the probe's own), the
same report lines against the same numpy ``want``, each movement done by
a small CUDA kernel as the card does it (``tpu_vpcc_torch.ops.probes``):

  P1  lane and row rolls of an (R, 128) int32 array, through shared memory
  P2  the flat shift-down by k, as offset loads
  P3  the D0/D1 element interleave, one 8-byte store per pair. Both of the
      reference's constructions (stack-reshape, repeat-dilate) are this
      one interleave here; the TPU's repeat-dilate failed its own check,
      and the Hopper kernel computes the probe's ``want``.
  P4  overlapping writes at row offsets read from a device array, in step
      order (the last step wins), as the TPU's sequential grid applies them

    python -m tpu_vpcc_torch.tools.hopper_probe [--device cuda|cpu]

Without ``--device cpu`` it needs a card and raises when it finds none;
on the CPU it runs the plain versions.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, NamedTuple

import numpy as np
import torch

from ..ops import probes
from . import resolve_device


class Case(NamedTuple):
    """One report line: what ran (``probe`` on ``args``), what came back
    (``got``, as the report compares it) and the numpy ``want``."""

    name: str
    probe: str
    args: tuple
    got: np.ndarray
    want: np.ndarray


def to_numpy(t) -> np.ndarray:
    """A tensor's values as numpy, int16 carriers read back as uint16."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)
    return a.view(np.uint16) if a.dtype == np.int16 else a


def report(name, got, want) -> bool:
    """``tools/pallas_probe.py``'s report line."""
    got = to_numpy(got)
    want = np.asarray(want)
    ok = got.shape == want.shape and np.array_equal(got, want)
    print(f"{name}: {'OK' if ok else 'FAIL'}"
          + ("" if ok else f" mismatches={np.sum(got != want)} "
             f"shape={got.shape} vs {want.shape}"))
    return ok


def _t(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


Run = Callable[..., torch.Tensor]


def probe_rolls(device, run: Run = probes.call, R: int = 16,
                L: int = 128) -> List[Case]:
    x = np.arange(R * L, dtype=np.int32).reshape(R, L)
    xt = _t(x, device)
    cases = []
    for name, shift, axis in (("P1 lane roll -3", -3, 1),
                              ("P1 row roll -2", -2, 0)):
        args = (xt, shift, axis)
        cases.append(Case(name, "P1", args, to_numpy(run("P1", *args)),
                          np.roll(x, shift, axis=axis)))
    return cases


def probe_flat_shift(device, run: Run = probes.call, R: int = 16,
                     L: int = 128,
                     ks=(1, 2, 4, 32, 127, 128, 256, 1024)) -> List[Case]:
    x = np.arange(R * L, dtype=np.int32).reshape(R, L)
    xt = _t(x, device)
    flat = x.reshape(-1)
    cases = []
    for k in ks:
        args = (xt, k)
        got = to_numpy(run("P2", *args)).reshape(-1)[: flat.size - k]
        # only the non-wrapped prefix matters
        want = np.roll(flat, -k)[: flat.size - k]
        cases.append(Case(f"P2 flat shift {k}", "P2", args, got, want))
    return cases


def probe_interleave(device, run: Run = probes.call, R: int = 8,
                     L: int = 128) -> List[Case]:
    a = np.arange(R * L, dtype=np.int32).reshape(R, L)
    b = (np.arange(R * L, dtype=np.int32) + 100000).reshape(R, L)
    want = np.empty((2 * R * L,), np.int32)
    want[0::2] = a.reshape(-1)
    want[1::2] = b.reshape(-1)
    want2d = want.reshape(2 * R, L)
    args = (_t(a, device), _t(b, device))
    got = to_numpy(run("P3", *args)).reshape(2 * R, L)
    return [Case(f"P3 {c} interleave", "P3", args, got, want2d)
            for c in ("stack-reshape", "repeat-dilate")]


def probe_dyn_dma(device, run: Run = probes.call, nstep: int = 4,
                  step_rows: int = 2, L: int = 128, offs=None) -> List[Case]:
    """``nstep`` steps of (step_rows, L) at overlapping row offsets
    (default the probe's [0, 1, 3, 4]) into two rows more than they
    cover, as the probe's (8, 128)."""
    offs = np.array([0, 1, 3, 4] if offs is None else offs, np.int32)
    x = np.arange(nstep * step_rows * L, dtype=np.int32).reshape(
        nstep, step_rows, L)
    out_rows = int(offs.max()) + step_rows + 2
    args = (_t(x, device), _t(offs, device), out_rows)
    got = to_numpy(run("P4", *args))
    want = np.zeros((out_rows, L), np.int32)
    covered = np.zeros(out_rows, bool)
    for i in range(nstep):
        want[offs[i] : offs[i] + step_rows] = x[i] + 1000 * i
        covered[offs[i] : offs[i] + step_rows] = True
    # only rows covered by some step are defined
    return [Case("P4 dyn-offset DMA", "P4", args, got[covered],
                 want[covered])]


def dyn_write_offsets(nstep: int, step_rows: int, in_order: bool,
                      seed: int) -> np.ndarray:
    """``nstep`` P4 offsets from 0, each the one before plus 0 to
    ``step_rows + 1`` rows: repeated offsets, overlaps and rows that no
    step covers; shuffled unless ``in_order``."""
    r = np.random.default_rng(seed)
    offs = np.concatenate(
        [[0], np.cumsum(r.integers(0, step_rows + 2, nstep - 1))])
    if not in_order:
        r.shuffle(offs)
    return offs.astype(np.int32)


PROBE_FUNCTIONS = (probe_rolls, probe_flat_shift, probe_interleave,
                   probe_dyn_dma)
#: (nstep, L, in order) of P4's edge shapes, each of DYN_WRITE_EDGE_ROWS-
#: row steps at :func:`dyn_write_offsets`: one step, three, 256 (the
#: 64 MiB shape's count) and one more than a block stages in shared
#: memory; widths off the kernel's 16-byte path (1, 127) and on it
#: (4, 128); offsets in order and shuffled
DYN_WRITE_EDGES = tuple(
    (n, L, in_order)
    for n in (1, 3, 256, probes.DYN_WRITE_STAGED_STEPS + 1)
    for L in (1, 4, 127, 128) for in_order in (True, False))
DYN_WRITE_EDGE_ROWS = 3


def run_all(device, run: Run = probes.call, functions=PROBE_FUNCTIONS):
    """Every probe of the module; prints the report lines and returns the
    cases."""
    cases = [c for fn in functions for c in fn(device, run)]
    for c in cases:
        report(c.name, c.got, c.want)
    return cases


def main(argv=None, functions=PROBE_FUNCTIONS, prog=__name__) -> int:
    ap = argparse.ArgumentParser(prog=f"python -m {prog}")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu (plain versions)"
    print(f"device: {name}")
    cases = run_all(device, functions=functions)
    return 0 if all(np.array_equal(c.got, c.want) and c.got.shape ==
                    c.want.shape for c in cases) else 1


if __name__ == "__main__":
    sys.exit(main())
