"""The Mosaic probes P1-P12 as Hopper kernels (K4-K6), with their plain
PyTorch versions.

Counterparts of the Pallas kernels of ``tools/pallas_probe.py`` (P1-P4),
``tools/pallas_probe2.py`` (P5-P8) and ``tools/pallas_probe3.py``
(P9-P12); the probe scripts themselves are ported as
``tpu_vpcc_torch.tools.hopper_probe*``. Each probe is one data movement:

  P1   roll of an (R, L) int32 array by a static shift (``torch.roll``)
  P2   flat shift-down: element p takes element (p + k) mod n, int32
  P3   element interleave of two int32 arrays: out[2i] = a[i],
       out[2i + 1] = b[i]
  P4   overlapping writes of (rows, L) steps at row offsets read from a
       device array, in step order (the last step wins), each step's
       rows plus the probe's 1000 * step marker, zeros where no step
       writes. The kernel finds each output row's last step from the
       offsets staged in shared memory and writes every row once, in
       16-byte vectors; the wrapper range-checks the offsets (one
       ``torch.aminmax``, one copy to the host)
  P5   int32 -> its little-endian int16 pairs, and back: on the card a
       copy of every byte in one launch, each thread REINTERPRET_VECTORS
       16-byte streaming loads and then their stores
  P6   P2 on u16 carried as int16
  P7   P1 with the shift read from a device tensor at run time
  P8   the shift compaction of ``tools/pallas_probe2.py`` on u16
       streams: every slot keeps its value (lo | hi << 16), then each
       slot with shift s > 0 moves it to slot - s. The kernel does that
       in one pass a segment through shared memory, with 16-byte loads
       and stores, in place of the TPU's log-shift network. Shifts stay
       inside a segment and no two moving slots share a destination (the
       compaction shifts of ``hopper_probe2.mini_compact_inputs``)
  P9   P3 (the reference's minor-dim reshape)
  P10  tile-concat: ``torch.cat([a, a], 1)``, what ``pltpu.repeat(x, 2,
       axis=1)`` computes
  P11  lane reversal
  P12  P3 on u16 carried as int16

Call a probe with :func:`call` (on a CPU tensor the plain version; on a
CUDA tensor the kernel in ``csrc/probes.cu``, counted in
:data:`launches`, or an error), or its plain version with :func:`plain`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

PROBES = tuple(f"P{i}" for i in range(1, 13))
#: P4's steps whose offsets a block of the kernel stages in shared memory
#: (``kOffsCap`` in ``csrc/probes.cu``); it reads more from device memory
DYN_WRITE_STAGED_STEPS = 4096
#: P5's 16-byte vectors a thread moves (``kCopyVectors`` in
#: ``csrc/probes.cu``), in blocks of REINTERPRET_BLOCK_THREADS threads
REINTERPRET_VECTORS = 4
REINTERPRET_BLOCK_THREADS = 256
#: the probe libraries of the kernel table, by the probes each holds
LIBRARIES = {
    "hopper_probe": ("P1", "P2", "P3", "P4"),
    "hopper_probe2": ("P5", "P6", "P7", "P8"),
    "hopper_probe3": ("P9", "P10", "P11", "P12"),
}
#: kernel launches per probe made by :func:`call` in this process
launches = dict.fromkeys(PROBES, 0)
_launch_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    with _launch_lock:
        for p in PROBES:
            launches[p] = 0


def _count_launch(probe: str) -> None:
    with _launch_lock:
        launches[probe] += 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _roll_plain(x, shift, axis):
    return torch.roll(x, shift, axis)


def _flat_shift_plain(x, k):
    flat = x.reshape(-1)
    k %= flat.numel()
    return torch.cat([flat[k:], flat[:k]]).reshape(x.shape)


def _interleave_plain(a, b):
    return torch.stack([a, b], dim=-1).reshape(a.shape[0], 2 * a.shape[1])


def _dyn_write_plain(x, offs, out_rows):
    out = torch.zeros((out_rows, x.shape[2]), dtype=x.dtype, device=x.device)
    for i, o in enumerate(offs.tolist()):
        out[o : o + x.shape[1]] = x[i] + 1000 * i
    return out


def _reinterpret_plain(x, dtype):
    return x.view(dtype).clone()


def _roll_dynamic_plain(x, shift):
    return torch.roll(x, int(shift.reshape(-1)[0]), 1)


def _mini_compact_plain(alo, ahi, shc, seg_words):
    """Every stream slot keeps its value, then each slot with a shift
    moves it down by that shift, by boolean-mask selection of the moving
    slots. The prefix up to each segment's valid count is its compacted
    stream. Shifts stay inside a segment, so ``seg_words`` only shapes
    the kernel's blocks."""
    def u16(t):
        return t.view(torch.int16).reshape(-1).to(torch.int64) & 0xFFFF

    values = u16(alo) | (u16(ahi) << 16)
    s = u16(shc)
    slot = torch.arange(values.numel(), device=values.device)
    out = values.clone()
    moving = s > 0
    out[(slot - s)[moving]] = values[moving]
    out = ((out ^ 0x80000000) - 0x80000000).to(torch.int32)
    return out.reshape(alo.shape[0], 2 * alo.shape[1])


def _tile_concat_plain(a):
    return torch.cat([a, a], dim=1)


def _reverse_lanes_plain(a):
    return torch.flip(a, dims=(1,))


_PLAIN = {
    "P1": _roll_plain,
    "P2": _flat_shift_plain,
    "P3": _interleave_plain,
    "P4": _dyn_write_plain,
    "P5": _reinterpret_plain,
    "P6": _flat_shift_plain,
    "P7": _roll_dynamic_plain,
    "P8": _mini_compact_plain,
    "P9": _interleave_plain,
    "P10": _tile_concat_plain,
    "P11": _reverse_lanes_plain,
    "P12": _interleave_plain,
}


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("probes")
        P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for name, args in {
            "probe_roll": [P, P, I64, I, I, I, P, P],
            "probe_flat_shift": [P, P, I64, I64, I, P],
            "probe_interleave": [P, P, P, I64, I, P],
            "probe_dyn_write": [P, P, P, I, I, I, I64, P],
            "probe_reinterpret": [P, P, I64, P],
            "probe_mini_compact": [P, P, P, P, I64, I, P],
            "probe_tile_concat": [P, P, I64, I64, P],
            "probe_reverse_lanes": [P, P, I64, I64, P],
        }.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def _launch(probe, entry, dev, *args):
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{probe} kernel ({entry}) launch failed: "
                           f"CUDA error {rc}")
    _count_launch(probe)


def _need(t, dtype, name, dims=2):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if t.dim() != dims or not t.is_contiguous() or t.numel() == 0:
        raise ValueError(f"{name}: want a contiguous, non-empty {dims}-D "
                         f"tensor, got {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")


def _roll_cuda(probe, x, shift, axis=1):
    _need(x, torch.int32, "x")
    out = torch.empty_like(x)
    dyn = None
    if probe == "P7":
        if shift.device != x.device or shift.dtype != torch.int32:
            raise ValueError("P7 reads its shift from an int32 tensor on "
                             "the card")
        dyn, shift = shift.data_ptr(), 0
    _launch(probe, "probe_roll", x.device, x.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], axis, int(shift), dyn)
    return out


def _flat_shift_cuda(probe, x, k):
    dtype = torch.int32 if probe == "P2" else torch.int16
    _need(x, dtype, "x")
    out = torch.empty_like(x)
    n = x.numel()
    _launch(probe, "probe_flat_shift", x.device, x.data_ptr(), out.data_ptr(),
            n, k % n, x.element_size())
    return out


def _interleave_cuda(probe, a, b):
    dtype = torch.int16 if probe == "P12" else torch.int32
    _need(a, dtype, "a")
    _need(b, dtype, "b")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b must have one shape and one device")
    out = torch.empty((a.shape[0], 2 * a.shape[1]), dtype=dtype,
                      device=a.device)
    _launch(probe, "probe_interleave", a.device, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), a.numel(), a.element_size())
    return out


def _dyn_write_cuda(probe, x, offs, out_rows):
    _need(x, torch.int32, "x", dims=3)
    if offs.dtype != torch.int32 or offs.shape != (x.shape[0],) \
            or offs.device != x.device:
        raise ValueError("offs: want (nstep,) int32 beside x")
    span = torch.empty(2, dtype=torch.int32, device=x.device)
    torch.aminmax(offs, dim=0, keepdim=True, out=(span[:1], span[1:]))
    lo, hi = span.tolist()
    if lo < 0 or hi + x.shape[1] > out_rows:
        raise ValueError(f"offsets {lo}..{hi} leave the {out_rows} rows")
    out = torch.empty((out_rows, x.shape[2]), dtype=torch.int32,
                      device=x.device)
    _launch(probe, "probe_dyn_write", x.device, x.data_ptr(),
            offs.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
            x.shape[2], out_rows)
    return out


def _reinterpret_cuda(probe, x, dtype):
    """int32 (R, L) -> int16 (R, 2L), or int16 (R, 2L) -> int32 (R, L)."""
    split = dtype == torch.int16
    _need(x, torch.int32 if split else torch.int16, "x")
    if not split and x.shape[1] % 2:
        raise ValueError(f"{tuple(x.shape)} int16 does not join into int32")
    cols = 2 * x.shape[1] if split else x.shape[1] // 2
    out = torch.empty((x.shape[0], cols), dtype=dtype, device=x.device)
    _launch(probe, "probe_reinterpret", x.device, x.data_ptr(),
            out.data_ptr(), x.numel() * x.element_size())
    return out


def _mini_compact_cuda(probe, alo, ahi, shc, seg_words):
    for t, name in ((alo, "alo"), (ahi, "ahi"), (shc, "shc")):
        _need(t, torch.int32, name)
        if t.shape != alo.shape or t.device != alo.device:
            raise ValueError(f"{name}: shape or device differs from alo's")
    if alo.numel() % seg_words:
        raise ValueError(f"{alo.numel()} words are no whole number of "
                         f"{seg_words}-word segments")
    out = torch.empty((alo.shape[0], 2 * alo.shape[1]), dtype=torch.int32,
                      device=alo.device)
    _launch(probe, "probe_mini_compact", alo.device, alo.data_ptr(),
            ahi.data_ptr(), shc.data_ptr(), out.data_ptr(),
            alo.numel() // seg_words, seg_words)
    return out


def _tile_concat_cuda(probe, a):
    _need(a, torch.int32, "a")
    out = torch.empty((a.shape[0], 2 * a.shape[1]), dtype=torch.int32,
                      device=a.device)
    _launch(probe, "probe_tile_concat", a.device, a.data_ptr(),
            out.data_ptr(), a.shape[0], a.shape[1])
    return out


def _reverse_lanes_cuda(probe, a):
    _need(a, torch.int32, "a")
    out = torch.empty_like(a)
    _launch(probe, "probe_reverse_lanes", a.device, a.data_ptr(),
            out.data_ptr(), a.shape[0], a.shape[1])
    return out


_CUDA = {
    "P1": _roll_cuda,
    "P2": _flat_shift_cuda,
    "P3": _interleave_cuda,
    "P4": _dyn_write_cuda,
    "P5": _reinterpret_cuda,
    "P6": _flat_shift_cuda,
    "P7": _roll_cuda,
    "P8": _mini_compact_cuda,
    "P9": _interleave_cuda,
    "P10": _tile_concat_cuda,
    "P11": _reverse_lanes_cuda,
    "P12": _interleave_cuda,
}


def plain(probe: str, *args):
    """The plain PyTorch version of ``probe`` on its arguments. P5 takes
    the target dtype after its tensor: ``torch.int16`` splits int32 words
    into their little-endian halves, ``torch.int32`` joins them."""
    return _PLAIN[probe](*args)


def call(probe: str, *args):
    """``probe`` on its arguments: the plain version for tensors on the
    CPU, the kernel for tensors on a CUDA card (or an error)."""
    if probe not in _PLAIN:
        raise ValueError(f"unknown probe {probe!r}")
    dev = args[0].device
    if dev.type == "cpu":
        return plain(probe, *args)
    if dev.type != "cuda":
        raise NotImplementedError(f"no {probe} kernel for device {dev}")
    return _CUDA[probe](probe, *args)
