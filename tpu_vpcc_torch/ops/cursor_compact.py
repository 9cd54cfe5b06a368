"""The cursor compaction experiment's kernel (K3).

Counterpart of ``_cursor_kernel``/``run_pallas_cursor`` in
``tools/compaction_experiment.py``: the floor of a single-pass compaction
with a carried cursor. The F frames' wide words ``w0, w1, w2`` and
``valid`` are flattened to N = F * S elements, cut into chunks of
:data:`CH` = 8192, and chunk i, with valid count ``n_i``, cursor
``cursor_i = sum_{j<i} n_j`` and window ``win_i = cursor_i // CH``, copies
its CH uncompacted elements of each word to output elements ``[win_i * CH,
win_i * CH + CH)``, in chunk order, so that a later chunk overwrites an
earlier one. The single count is ``sum n_i``. Every window from 0 to
``win_last`` is written; elements past ``(win_last + 1) * CH`` are
unspecified (:func:`covered_elements`).

Carriers as K1F's: the words are int32 tensors holding the u32 bit
patterns, ``valid`` is bool. On a CPU tensor :func:`cursor_compact` runs
the plain PyTorch version; on a CUDA tensor it launches the hand-written
kernel (``csrc/cursor_compact.cu``: one pass, the cursor carried across
blocks by decoupled look-back, only each window's last writer copies) or
raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

#: elements per chunk (the reference's ROWS * LANES = 8 * 1024)
CH = 8192

#: K3 launches made by :func:`cursor_compact` in this process
launches = 0
_launch_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    global launches
    with _launch_lock:
        launches = 0


def _count_launch() -> None:
    global launches
    with _launch_lock:
        launches += 1


def _windows(valid):
    """Per chunk: valid count ``n``, cursor and window, int64."""
    nc = valid.numel() // CH
    n = valid.reshape(nc, CH).sum(dim=1, dtype=torch.int64)
    cursor = torch.cumsum(n, dim=0) - n
    return n, cursor, cursor // CH


def covered_elements(valid) -> int:
    """How many leading (flat) output elements the cursor pass defines:
    windows 0 through the last chunk's window."""
    return (int(_windows(valid)[2][-1]) + 1) * CH


def cursor_compact_reference(w0, w1, w2, valid):
    """The plain PyTorch version, on the tensors' device: per-chunk counts,
    an exclusive cumsum for the cursors, and one indexed copy of each
    window's last writer (windows never decrease, so the last chunk of a
    window is what the sequential grid leaves there)."""
    N = valid.numel()
    nc = N // CH
    n, cursor, win = _windows(valid)
    last = torch.ones(nc, dtype=torch.bool, device=valid.device)
    last[:-1] = win[1:] != win[:-1]
    outs = []
    for w in (w0, w1, w2):
        out = torch.empty_like(w)
        out.reshape(nc, CH)[win[last]] = w.reshape(nc, CH)[last]
        outs.append(out)
    count = (cursor[-1:] + n[-1:]).to(torch.int32)
    return (*outs, count)


def _check(w0, w1, w2, valid):
    if valid.dtype != torch.bool:
        raise TypeError(f"valid: dtype {valid.dtype}, want torch.bool")
    N = valid.numel()
    if N == 0 or N % CH:
        raise ValueError(f"N = F * S = {N} must be a positive multiple of "
                         f"the chunk {CH}")
    if N > 2 ** 31 - 1:
        raise ValueError(f"N = {N} does not fit the int32 count")
    for k, t in enumerate((w0, w1, w2)):
        if t.dtype != torch.int32:
            raise TypeError(f"w{k}: dtype {t.dtype}, want torch.int32")
        if t.shape != valid.shape:
            raise ValueError(f"w{k}: shape {tuple(t.shape)} != valid's")
        if t.device != valid.device:
            raise ValueError(f"w{k} lies on {t.device}, valid on {valid.device}")


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("cursor_compact")
        lib.cursor_compact_chunk.restype = ctypes.c_int
        lib.cursor_compact_chunk.argtypes = []
        lib.cursor_compact.restype = ctypes.c_int
        lib.cursor_compact.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int64, ctypes.c_void_p]
        )
        if lib.cursor_compact_chunk() != CH:
            raise RuntimeError("csrc/cursor_compact.cu disagrees on the chunk")
        _lib = lib
    return _lib


def _cursor_compact_cuda(w0, w1, w2, valid):
    ins = (w0, w1, w2, valid)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ins):
        raise ValueError("K3 takes contiguous, 16-byte aligned tensors")
    lib = _load()
    N = valid.numel()
    dev = valid.device
    outs = [torch.empty_like(w) for w in (w0, w1, w2)]
    count = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(N // CH + 1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cursor_compact(
            valid.data_ptr(), *(t.data_ptr() for t in (w0, w1, w2)),
            *(o.data_ptr() for o in outs), count.data_ptr(),
            scratch.data_ptr(), N, stream,
        )
    if rc != 0:
        raise RuntimeError(f"cursor_compact kernel launch failed: CUDA error {rc}")
    _count_launch()
    return (*outs, count)


def cursor_compact(w0, w1, w2, valid):
    """The cursor pass over the flattened words (see the module note).

    Returns ``(out0, out1, out2, count)``: each output shaped like its
    word, defined on the covered windows, and ``count`` a (1,) int32."""
    _check(w0, w1, w2, valid)
    if valid.device.type == "cpu":
        return cursor_compact_reference(w0, w1, w2, valid)
    if valid.device.type != "cuda":
        raise NotImplementedError(f"no K3 kernel for device {valid.device}")
    return _cursor_compact_cuda(w0, w1, w2, valid)
