"""Hopper probes P5-P8 (kernel library K5 in ``csrc/probes.cu``).

Counterpart of ``tools/pallas_probe2.py``, with its inputs (sizes taken
as arguments, defaulting to the probe's own), its report lines and its
numpy ``want``s:

  P5  u32 -> u16 pairs in little-endian order, and the round trip: on the
      card a reinterpretation (a copy of 16-byte vectors, four a
      thread, in one launch). ``pltpu.bitcast``
      split rows instead of lanes and failed the probe's requested
      (R, 1024) shape; the Hopper kernel computes the probe's ``want``.
  P6  the flat shift-down on u16 (carried as int16), at 1,024 lanes
  P7  a lane roll by a shift read from device memory at run time
  P8  the probe's shift compaction of u16 streams (2,048 pixels, 4,096
      slots, three streams): each valid slot moved down by its own
      shift, in one pass through shared memory where the probe ran a
      13-stage log-shift network. Mosaic could not lower the probe
      (``bitcast 1D``); the Hopper kernel computes the probe's ``want``.

    python -m tpu_vpcc_torch.tools.hopper_probe2 [--device cuda|cpu]
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np
import torch

from ..ops import probes
from .hopper_probe import Case, Run, _t, main as _main, to_numpy


def probe_bitcast(device, run: Run = probes.call, R: int = 4,
                  L: int = 512) -> List[Case]:
    lo = np.arange(R * L, dtype=np.uint32).reshape(R, L) % 60000
    hi = (np.arange(R * L, dtype=np.uint32).reshape(R, L) * 7 + 3) % 60000
    combo = lo | (hi << 16)
    want = np.empty((R, 2 * L), np.uint16)
    want[:, 0::2] = lo.astype(np.uint16)
    want[:, 1::2] = hi.astype(np.uint16)
    args = (_t(combo, device), torch.int16)
    split = run("P5", *args)
    back_args = (split, torch.int32)
    back = to_numpy(run("P5", *back_args)).view(np.uint32)
    return [
        Case("P5 bitcast u32->u16 interleave order", "P5", args,
             to_numpy(split), want),
        Case("P5 bitcast roundtrip", "P5", back_args, back, combo),
    ]


def probe_wide_u16(device, run: Run = probes.call, R: int = 8,
                   L: int = 1024, ks=(1, 5, 1023, 1024, 4096)) -> List[Case]:
    x = (np.arange(R * L, dtype=np.uint32) % 61000).astype(
        np.uint16).reshape(R, L)
    xt = _t(x, device)
    flat = x.reshape(-1)
    cases = []
    for k in ks:
        args = (xt, k)
        got = to_numpy(run("P6", *args)).reshape(-1)[: flat.size - k]
        cases.append(Case(f"P6 u16 flat shift {k} @ lanes={L}", "P6", args,
                          got, flat[k:]))
    return cases


def probe_dynamic_roll(device, run: Run = probes.call, R: int = 4,
                       L: int = 256, shift: int = 7) -> List[Case]:
    x = np.arange(R * L, dtype=np.int32).reshape(R, L)
    args = (_t(x, device), _t(np.array([shift], np.int32), device))
    return [Case("P7 dynamic lane roll", "P7", args,
                 to_numpy(run("P7", *args)), np.roll(x, shift, axis=1))]


def mini_compact_inputs(R: int = 4, L: int = 512, n_seg: int = 1,
                        seed: int = 0):
    """P8's inputs for ``n_seg`` segments of R x L pixels each (segment
    rows stacked), made as the probe makes its one: per pixel a D0 and a
    D1 word and validity, the shifts ``sh = pos - dest`` of the valid
    slots computed on the host, and the words split into the lo/hi u16
    streams. Returns ``(alo, ahi, shc, want)``: three (n_seg * R, L) u32
    arrays and, per segment, the valid words in emission order."""
    P = R * L
    r = np.random.default_rng(seed)
    v0 = r.random((n_seg, P)) < 0.6
    v1 = r.random((n_seg, P)) < 0.5
    w0d0 = r.integers(0, 1 << 30, (n_seg, P), dtype=np.uint32)
    w0d1 = r.integers(0, 1 << 30, (n_seg, P), dtype=np.uint32)
    s01 = v0.astype(np.int64) + v1
    dest0 = np.cumsum(s01, axis=1) - s01
    dest1 = dest0 + v0
    pos0 = 2 * np.arange(P)
    pos1 = pos0 + 1
    sh0 = np.where(v0, pos0 - dest0, 0).astype(np.uint32)
    sh1 = np.where(v1, pos1 - dest1, 0).astype(np.uint32)
    alo = (w0d0 & 0xFFFF) | ((w0d1 & 0xFFFF) << 16)
    ahi = (w0d0 >> 16) | (w0d1 & 0xFFFF0000)
    shc = sh0 | (sh1 << 16)
    inter = np.empty((n_seg, 2 * P), np.uint32)
    inter[:, 0::2] = w0d0
    inter[:, 1::2] = w0d1
    vv = np.empty((n_seg, 2 * P), bool)
    vv[:, 0::2] = v0
    vv[:, 1::2] = v1
    want = [inter[s][vv[s]] for s in range(n_seg)]
    shape = (n_seg * R, L)
    return alo.reshape(shape), ahi.reshape(shape), shc.reshape(shape), want


def probe_mini_compact(device, run: Run = probes.call, R: int = 4,
                       L: int = 512, n_seg: int = 1) -> List[Case]:
    """The probe's one segment, or ``n_seg`` independent segments of R x
    L pixels (one block each on the card); every segment's prefix is
    compared."""
    alo, ahi, shc, want = mini_compact_inputs(R, L, n_seg)
    args = tuple(_t(a, device) for a in (alo, ahi, shc)) + (R * L,)
    got = to_numpy(run("P8", *args)).view(np.uint32).reshape(n_seg, -1)
    return [Case("P8 mini shift-compact (prefix)", "P8", args,
                 np.concatenate([g[: w.size] for g, w in zip(got, want)]),
                 np.concatenate(want))]


PROBE_FUNCTIONS = (probe_bitcast, probe_wide_u16, probe_dynamic_roll,
                   probe_mini_compact)
#: (seg_words, n_seg) of P8's edge shapes, each segment one row of
#: seg_words pixels: word counts that are no multiple of four (the
#: kernel's scalar path: 1, 3, 2,047) and that are (4, and 2,048, a full
#: 4,096-slot segment), in one, three and 133 segments (one block each,
#: more blocks than the card's 132 SMs)
MINI_COMPACT_EDGES = tuple((w, n) for w in (1, 3, 4, 2047, 2048)
                           for n in (1, 3, 133))
#: the streaming multiprocessors of an H100 SXM, which P5's largest edge
#: shape fills with one wave of blocks (on another card, another shape)
H100_SMS = 132
#: P5's resident blocks on an SM: 2,048 threads in blocks of 256
REINTERPRET_BLOCKS_PER_SM = 2048 // probes.REINTERPRET_BLOCK_THREADS
#: the u32 words of one P5 block (256 threads of four 16-byte vectors:
#: 16 KB, ``ops/probes.py``)
_REINTERPRET_BLOCK_WORDS = (probes.REINTERPRET_BLOCK_THREADS
                            * probes.REINTERPRET_VECTORS * 4)
#: (R, L) int32 of P5's edge shapes, each one row: no 16-byte vector (4
#: and 12 B), one vector and a word (20 B), one block less one vector,
#: one block, one block and a word, and one wave of resident blocks on
#: every SM and three words more; :func:`probe_bitcast` runs each in both
#: directions
REINTERPRET_EDGES = tuple(
    (1, w) for w in (1, 3, 5, _REINTERPRET_BLOCK_WORDS - 4,
                     _REINTERPRET_BLOCK_WORDS, _REINTERPRET_BLOCK_WORDS + 1,
                     H100_SMS * REINTERPRET_BLOCKS_PER_SM
                     * _REINTERPRET_BLOCK_WORDS + 3))


def main(argv=None) -> int:
    return _main(argv, PROBE_FUNCTIONS, __name__)


if __name__ == "__main__":
    sys.exit(main())
