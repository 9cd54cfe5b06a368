"""The wide words stage (kernel K2W), with the cat-row gather fused in.

Counterpart of ``tpu_vpcc.ops.pallas_kernels._payload_kernel`` together
with its wrapper's per-pixel interleave (``tiles_to_payload_pallas``),
extended to everything the wide branch of
``tpu_vpcc.ops.tiled._grids_to_words`` computes before smoothing:
``drop_map0`` (trailing-layer passes), one map, relative D1 and the
inverse 45-degree rotation when ``cfg.additional_planes`` is set.

From the staged ``fields`` (F, G, N_GROUP_FIELDS) int32 and the packed,
host-oriented ``cat`` (F, nb, 3*res*res) int32 it returns ``(w0, w1,
w2, valid)``, each (F, S) with S = G * 2 * res², in emission order:
group-major, patch raster inside the group, the two maps interleaved
per pixel. ``w0 = x | y << 16``, ``w1 = z | cy << 16`` and ``w2 = cu |
cv << 16`` are int32 tensors holding the u32 bit patterns; ``valid`` is
bool.

On a CPU tensor :func:`wide_words` runs the plain PyTorch version
(:func:`wide_words_reference`: the row gather plus a transcription of
the reference's wide branch); on a CUDA tensor it launches the
hand-written kernel (``csrc/wide_words.cu``), which reads each group's
cat row itself so the gathered tiles are never written out, or raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..atlas import groups as G
from . import _build
from .reconstruct import apply_inverse_rot45
from .tiled import _gather_tiles, _slot_geometry, _wrap32

#: K2W launches made by :func:`wide_words` in this process
launches = 0
_launch_lock = threading.Lock()
_lib = None

# the field columns the kernel reads, in the order of csrc/wide_words.cu's
# FieldIdx
_FIELD_IDX = (
    G.G_VALID, G.G_D1, G.G_MODE, G.G_T00, G.G_LODX, G.G_B00, G.G_LODY,
    G.G_NORMAL, G.G_TANGENT, G.G_BITANGENT, G.G_BLOCKID, G.G_PLANE,
)


def reset_launches() -> None:
    global launches
    with _launch_lock:
        launches = 0


def _count_launch() -> None:
    global launches
    with _launch_lock:
        launches += 1


def wide_words_reference(fields, cat, cfg):
    """The plain PyTorch version, on the tensors' device: the cat-row
    gather, then the wide branch of ``tiled._grids_to_words`` without
    smoothing."""
    F, Gc = fields.shape[0], fields.shape[1]
    S = Gc * cfg.slots_per_block
    t_a, t_b, t_c = _gather_tiles(fields, cat, cfg)
    col, tangent, bitangent, n0, n1, valid0, valid1 = _slot_geometry(
        fields, t_a, cfg
    )

    def assemble(n):
        return [
            torch.where(col(G.G_NORMAL) == c, n, 0)
            + torch.where(col(G.G_TANGENT) == c, tangent, 0)
            + torch.where(col(G.G_BITANGENT) == c, bitangent, 0)
            for c in range(3)
        ]

    p0 = assemble(n0)
    p1 = assemble(n1)
    if cfg.additional_planes:
        plane = col(G.G_PLANE)
        p0 = apply_inverse_rot45(*p0, plane, cfg.geometry_bitdepth_3d)
        p1 = apply_inverse_rot45(*p1, plane, cfg.geometry_bitdepth_3d)

    M10 = 0x3FF

    def channels(t):
        return t & M10, (t >> 10) & M10, (t >> 20) & M10

    cy0, cu0, cv0 = channels(t_b)
    cy1, cu1, cv1 = channels(t_c)

    def interleave(a, b):
        return torch.stack([a, b], dim=-1).reshape(F, S)

    def pack(a0, a1, b0, b1):
        lo = interleave(a0, a1).to(torch.int64)
        hi = interleave(b0, b1).to(torch.int64)
        return _wrap32(lo | (hi << 16))

    w0 = pack(p0[0], p1[0], p0[1], p1[1])
    w1 = pack(p0[2], p1[2], cy0, cy1)
    w2 = pack(cu0, cu1, cv0, cv1)
    return w0, w1, w2, interleave(valid0, valid1)


def _check(fields, cat, cfg):
    if fields.dim() != 3 or fields.shape[2] != G.N_GROUP_FIELDS:
        raise ValueError(f"fields must be (F, G, {G.N_GROUP_FIELDS}), got "
                         f"{tuple(fields.shape)}")
    T2 = cfg.occupancy_resolution * cfg.occupancy_resolution
    if cat.dim() != 3 or cat.shape[0] != fields.shape[0] \
            or cat.shape[2] != 3 * T2:
        raise ValueError(f"cat must be (F, nb, {3 * T2}), got "
                         f"{tuple(cat.shape)}")
    for t, name in ((fields, "fields"), (cat, "cat")):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {t.dtype}, want torch.int32")
    if fields.device != cat.device:
        raise ValueError(f"fields lie on {fields.device}, cat on {cat.device}")
    if not cfg.host_oriented:
        raise ValueError("the port stages host-oriented cats only")


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("wide_words")
        lib.wide_words.restype = ctypes.c_int
        lib.wide_words.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
             ctypes.c_int]
            + [ctypes.c_int64] * 3
            + [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 5
        )
        _lib = lib
    return _lib


def _wide_words_cuda(fields, cat, cfg):
    if not (fields.is_contiguous() and cat.is_contiguous()):
        raise ValueError("K2W takes contiguous fields and cat")
    lib = _load()
    F, Gc, nf = fields.shape
    S = Gc * cfg.slots_per_block
    dev = fields.device
    w0, w1, w2 = (
        torch.empty((F, S), dtype=torch.int32, device=dev) for _ in range(3)
    )
    valid = torch.empty((F, S), dtype=torch.bool, device=dev)
    idx = (ctypes.c_int * len(_FIELD_IDX))(*_FIELD_IDX)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wide_words(
            fields.data_ptr(), cat.data_ptr(), idx, nf, F, Gc, cat.shape[1],
            cfg.occupancy_resolution, cfg.geo_shift, int(cfg.absolute_d1),
            int(cfg.map_count > 1), int(cfg.drop_map0),
            int(cfg.additional_planes), cfg.geometry_bitdepth_3d,
            w0.data_ptr(), w1.data_ptr(), w2.data_ptr(), valid.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"wide_words kernel launch failed: CUDA error {rc}")
    _count_launch()
    return w0, w1, w2, valid


def wide_words(fields, cat, cfg):
    """The wide words of a staged dispatch: ``(w0, w1, w2, valid)``,
    each (F, G * 2 * res²), in emission order (see the module note)."""
    _check(fields, cat, cfg)
    if fields.device.type == "cpu":
        return wide_words_reference(fields, cat, cfg)
    if fields.device.type != "cuda":
        raise NotImplementedError(f"no K2W kernel for device {fields.device}")
    return _wide_words_cuda(fields, cat, cfg)
