"""Sort-free compaction: kernels K1 (narrow words) and K1F (wide words).

:func:`shift_compact_ops` (K1) is the counterpart of
``tpu_vpcc.ops.shift_compact.shift_compact_ops``. The narrow words
arrive in PATCH memory order, ``[D0 half | D1 half]`` along the
slot axis, each half in the frame's patch-raster pixel order. Every
valid slot moves to its emission rank: pixel ``p``'s D0 slot to
``dest0[p]`` and its D1 slot to ``dest0[p] + v0[p]``, where ``dest0`` is
the exclusive prefix sum of ``v0 + v1`` over the frame's pixels.

:func:`shift_compact_full` (K1F) is the counterpart of
``tpu_vpcc.ops.shift_compact.shift_compact_full_order``: the wide
path's three words arrive in emission order already, so each valid slot
moves to ``dest``, the exclusive prefix sum of the validity over the
frame's flat slot order.

Carriers: ``w0``, ``wc`` and the wide words are ``int32`` tensors
holding the u32 bit patterns, ``zs`` an ``int16`` tensor holding the
u16 bit patterns, and ``valid`` a ``bool`` tensor. The compaction only
moves bits.

On a CPU tensor both wrappers run their plain PyTorch versions; on a
CUDA tensor they launch the hand-written kernels
(``csrc/shift_compact.cu``: one ticketed look-back pass per call, after
a memset of the call's scratch) or raise. The kernels take any ``F`` and
``S`` (even ``S`` for K1); a stream that is not 16-byte aligned takes
the kernel's scalar loads.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

#: K1 launches made by :func:`shift_compact_ops` in this process
launches = 0
#: K1F launches made by :func:`shift_compact_full` in this process
full_launches = 0
_launch_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    """Set both launch counters to 0."""
    global launches, full_launches
    with _launch_lock:
        launches = 0
        full_launches = 0


def _count_launch() -> None:
    global launches
    with _launch_lock:
        launches += 1


def _count_full_launch() -> None:
    global full_launches
    with _launch_lock:
        full_launches += 1


def shift_compact_ops_reference(w0, zs, wc, valid):
    """The plain PyTorch version, on the tensors' device: a prefix sum of
    the per-pixel validity and two scatters per operand."""
    F, S = valid.shape
    half = S // 2
    v0 = valid[:, :half]
    v1 = valid[:, half:]
    s01 = v0.to(torch.int32) + v1.to(torch.int32)
    incl = torch.cumsum(s01, dim=1, dtype=torch.int32)
    dest0 = incl - s01
    counts = (
        incl[:, -1].contiguous() if half
        else torch.zeros(F, dtype=torch.int32, device=valid.device)
    )
    base = torch.arange(F, device=valid.device)[:, None] * S
    d0 = (base + dest0)[v0]
    d1 = (base + dest0 + v0.to(torch.int32))[v1]
    outs = []
    for op in [w0] + ([] if zs is None else [zs]) + [wc]:
        out = torch.empty_like(op)
        flat = out.view(-1)
        flat[d0] = op[:, :half][v0]
        flat[d1] = op[:, half:][v1]
        outs.append(out)
    return outs, counts


def _check(w0, zs, wc, valid):
    if valid.dim() != 2 or valid.shape[1] % 2:
        raise ValueError(f"valid must be (F, even S), got {tuple(valid.shape)}")
    want = [(w0, torch.int32, "w0"), (wc, torch.int32, "wc"),
            (valid, torch.bool, "valid")]
    if zs is not None:
        want.append((zs, torch.int16, "zs"))
    for t, dtype, name in want:
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
        if t.shape != valid.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != valid's")
        if t.device != valid.device:
            raise ValueError(f"{name} lies on {t.device}, valid on {valid.device}")


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("shift_compact")
        lib.shift_compact_tile_pixels.restype = ctypes.c_int
        lib.shift_compact_tile_pixels.argtypes = []
        lib.shift_compact_scratch_words.restype = ctypes.c_int64
        lib.shift_compact_scratch_words.argtypes = [ctypes.c_int64] * 2
        for fn in (lib.shift_compact_narrow, lib.shift_compact_full):
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 2
                           + [ctypes.c_void_p])
        _lib = lib
    return _lib


def tile_items() -> int:
    """The kernels' tile (K1: pixels, K1F: slots), as the library reports
    it."""
    return _load().shift_compact_tile_pixels()


def edge_extents(tile: int) -> dict:
    """Per-frame item extents (K1: pixels per half, K1F: slots) at the
    edges of kernels with tiles of ``tile`` items, by name: one tile, one
    tile plus one item, three tiles with the last partial, more than 32
    tiles (the look-back passes a warp's window of status words), and an
    extent that is not a multiple of the 16-byte validity vector (the
    kernels' scalar loads)."""
    return {
        "one tile": tile,
        "one tile + 1": tile + 1,
        "3 tiles, last partial": 2 * tile + 768,
        "33 tiles + 256": 33 * tile + 256,
        "3 tiles + 3, ragged": 2 * tile + 771,
    }


def _scratch(lib, F, items, dev):
    """The call's scratch: a status word per tile and the ticket (the C
    function zeroes it on the stream)."""
    n = lib.shift_compact_scratch_words(F, items)
    return torch.empty(n, dtype=torch.int64, device=dev)


def _shift_compact_cuda(w0, zs, wc, valid):
    for t in (w0, zs, wc, valid):
        if t is not None and not t.is_contiguous():
            raise ValueError("K1 takes contiguous (F, S) tensors")
    lib = _load()
    F, S = valid.shape
    dev = valid.device
    outs = [torch.empty_like(w0)] + (
        [] if zs is None else [torch.empty_like(zs)]
    ) + [torch.empty_like(wc)]
    counts = torch.empty(F, dtype=torch.int32, device=dev)
    scratch = _scratch(lib, F, S // 2, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.shift_compact_narrow(
            valid.data_ptr(), w0.data_ptr(),
            None if zs is None else zs.data_ptr(), wc.data_ptr(),
            outs[0].data_ptr(), None if zs is None else outs[1].data_ptr(),
            outs[-1].data_ptr(), counts.data_ptr(), scratch.data_ptr(),
            F, S, stream,
        )
    if rc != 0:
        raise RuntimeError(f"shift_compact kernel launch failed: CUDA error {rc}")
    _count_launch()
    return outs, counts


def shift_compact_ops(w0, zs, wc, valid):
    """Compact the narrow words to their emission prefix.

    Returns ``([w0c, (zsc,) wcc], counts)``: each output ``(F, S)`` with
    the frame's compacted prefix in emission order and an unspecified
    tail, and ``counts`` ``(F,)`` int32."""
    _check(w0, zs, wc, valid)
    if valid.device.type == "cpu":
        return shift_compact_ops_reference(w0, zs, wc, valid)
    if valid.device.type != "cuda":
        raise NotImplementedError(f"no K1 kernel for device {valid.device}")
    return _shift_compact_cuda(w0, zs, wc, valid)


# ---------------------------------------------------------------------------
# K1F: the wide path's full-order compaction
# ---------------------------------------------------------------------------


def shift_compact_full_reference(ops, valid):
    """The plain PyTorch version of K1F, on the tensors' device: a
    prefix sum of the validity and one scatter per operand."""
    F, S = valid.shape
    v = valid.to(torch.int32)
    incl = torch.cumsum(v, dim=1, dtype=torch.int32)
    counts = (
        incl[:, -1].contiguous() if S
        else torch.zeros(F, dtype=torch.int32, device=valid.device)
    )
    base = torch.arange(F, device=valid.device)[:, None] * S
    dest = (base + incl - v)[valid]
    outs = []
    for op in ops:
        out = torch.empty_like(op)
        out.view(-1)[dest] = op[valid]
        outs.append(out)
    return outs, counts


def _check_full(ops, valid):
    if valid.dim() != 2:
        raise ValueError(f"valid must be (F, S), got {tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid: dtype {valid.dtype}, want torch.bool")
    if len(ops) != 3:
        raise ValueError(f"K1F takes three operands, got {len(ops)}")
    for k, t in enumerate(ops):
        if t.dtype != torch.int32:
            raise TypeError(f"operand {k}: dtype {t.dtype}, want torch.int32")
        if t.shape != valid.shape:
            raise ValueError(f"operand {k}: shape {tuple(t.shape)} != valid's")
        if t.device != valid.device:
            raise ValueError(
                f"operand {k} lies on {t.device}, valid on {valid.device}"
            )


def _shift_compact_full_cuda(ops, valid):
    for t in (*ops, valid):
        if not t.is_contiguous():
            raise ValueError("K1F takes contiguous (F, S) tensors")
    lib = _load()
    F, S = valid.shape
    dev = valid.device
    outs = [torch.empty_like(o) for o in ops]
    counts = torch.empty(F, dtype=torch.int32, device=dev)
    scratch = _scratch(lib, F, S, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.shift_compact_full(
            valid.data_ptr(), *(o.data_ptr() for o in ops),
            *(o.data_ptr() for o in outs), counts.data_ptr(),
            scratch.data_ptr(), F, S, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"shift_compact_full kernel launch failed: CUDA error {rc}"
        )
    _count_full_launch()
    return outs, counts


def shift_compact_full(ops, valid):
    """Compact three (F, S) int32 operands whose memory order is the
    emission order (the wide words ``w0, w1, w2``).

    Returns ``([o0, o1, o2], counts)``: each output ``(F, S)`` with the
    frame's compacted prefix and an unspecified tail, and ``counts``
    ``(F,)`` int32."""
    ops = list(ops)
    _check_full(ops, valid)
    if valid.device.type == "cpu":
        return shift_compact_full_reference(ops, valid)
    if valid.device.type != "cuda":
        raise NotImplementedError(f"no K1F kernel for device {valid.device}")
    return _shift_compact_full_cuda(ops, valid)
