"""Hopper probes P9-P12 (kernel library K6 in ``csrc/probes.cu``).

Counterpart of ``tools/pallas_probe3.py``, with its inputs (sizes taken
as arguments, defaulting to the probe's own), its report lines and its
numpy ``want``s:

  P9   the minor-dim interleave (R, L) x 2 -> (R, 2L): one 8-byte store
       per int32 pair
  P10  ``pltpu.repeat(x, 2, axis=1)``, which computes a tile-concat on the
       TPU and in interpret mode: ``[a | a]`` along the lanes
  P11  lane reversal
  P12  the P9 interleave on u16 (carried as int16): one 4-byte store per
       pair

    python -m tpu_vpcc_torch.tools.hopper_probe3 [--device cuda|cpu]
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..ops import probes
from .hopper_probe import Case, Run, _t, main as _main, to_numpy


def probe_inputs(R: int = 8, L: int = 512):
    """The probe's ``a`` and ``b``, (R, L) int32."""
    a = (np.arange(R * L, dtype=np.int32) % 50001).reshape(R, L)
    b = ((np.arange(R * L, dtype=np.int32) * 3 + 7) % 50001).reshape(R, L)
    return a, b


def _interleaved(a, b):
    out = np.empty((a.shape[0], 2 * a.shape[1]), a.dtype)
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def probe_interleave(device, run: Run = probes.call, R: int = 8,
                     L: int = 512) -> List[Case]:
    a, b = probe_inputs(R, L)
    args = (_t(a, device), _t(b, device))
    return [Case("P9 minor-dim interleave reshape", "P9", args,
                 to_numpy(run("P9", *args)), _interleaved(a, b))]


def probe_repeat(device, run: Run = probes.call, R: int = 8,
                 L: int = 512) -> List[Case]:
    a, _ = probe_inputs(R, L)
    args = (_t(a, device),)
    return [Case("P10 pltpu.repeat tile-concat", "P10", args,
                 to_numpy(run("P10", *args)), np.concatenate([a, a], axis=1))]


def probe_rev(device, run: Run = probes.call, R: int = 8,
              L: int = 512) -> List[Case]:
    a, _ = probe_inputs(R, L)
    args = (_t(a, device),)
    return [Case("P11 lax.rev lanes", "P11", args,
                 to_numpy(run("P11", *args)), a[:, ::-1])]


def probe_interleave16(device, run: Run = probes.call, R: int = 8,
                       L: int = 512) -> List[Case]:
    a, b = probe_inputs(R, L)
    a16 = (a % 60000).astype(np.uint16)
    b16 = (b % 60000).astype(np.uint16)
    args = (_t(a16, device), _t(b16, device))
    return [Case("P12 u16 interleave reshape", "P12", args,
                 to_numpy(run("P12", *args)), _interleaved(a16, b16))]


PROBE_FUNCTIONS = (probe_interleave, probe_repeat, probe_rev,
                   probe_interleave16)
#: (R, L) shapes off the kernels' fast path for P10 and P11: widths that
#: are no multiple of four int32 (the scalar path), a single row, and row
#: counts that are no multiple of a block's row tile
EDGE_SHAPES = ((8, 1), (8, 3), (8, 5), (8, 511), (8, 513), (1, 512),
               (1, 5), (37, 512), (1031, 5), (37, 4))


def main(argv=None) -> int:
    return _main(argv, PROBE_FUNCTIONS, __name__)


if __name__ == "__main__":
    sys.exit(main())
