"""The device pack (kernel K5): block-tiled sample planes to the cat.

Counterpart of what ``tpu_vpcc`` runs as fused XLA wherever its host
pack is off (its default on every backend but the TPU), in
``tpu_vpcc/ops/tiled.py``:

  - ``_pack_u32_planes`` (:1006): the dense upsample and bit-pack of
    occupancy, geometry and both maps' colour into three u32 planes;
  - the row-wise concat of ``_pretiled_gather_megarow`` (:1127) into one
    ``(F, nb, 3*res*res)`` cat;
  - the orientation fix of ``_tiles_to_words`` (:257-274), which
    transposes SWAP-family tiles after the gather. Here it is folded into
    the pack, so the cat comes out byte for byte as
    ``tpu_vpcc.ops.tiled.pack_planes_host(..., swap=swap_mask_host(...))``
    writes it: every tile in patch raster order (``cfg.host_oriented``).

Inputs, on one device, as ``ops.tiled.planes_to_device`` carries them:
``occ`` (F, nb, res/prec, res/prec) uint8; ``geo0``, ``geo1`` (F, nb,
res, res), ``ay`` (F, M, nb, res, res) and ``au``, ``av`` (F, M, nb,
res>>cs, res>>cs), u16 samples as int16 bit patterns; ``swap`` (F, nb)
uint8, the blocks written transposed. Output: the cat, int32 holding the
u32 bit patterns.

On a CPU tensor :func:`pack_cat` runs the plain PyTorch version
(:func:`pack_cat_plain`); on a CUDA tensor it launches the hand-written
kernel (``csrc/pack_planes.cu``) or raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .tiled import _wrap32

#: the shapes the pack is held at, against the reference's packs on the
#: CPU (``tests/test_torch_pack.py``) and against its plain version on
#: the card (``chip_smoke.py`` phase 2c): ``(map_count, chroma_shift,
#: res, prec, F, swap density)``
CHECK_GRID = tuple(
    (mc, cs, res, prec, F, density)
    for mc in (1, 2)
    for cs in (0, 1)
    for res, prec in ((16, 4), (16, 1), (8, 2), (16, 16), (32, 4))
    for F in (1, 3)
    for density in (0.0, 0.3, 1.0)
)

#: K5 launches made by :func:`pack_cat` in this process
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


def pack_cat_plain(occ, geo0, geo1, ay, au, av, swap, cfg):
    """The plain PyTorch version, on the tensors' device: the three
    planes in int64, nearest upsample by ``repeat_interleave``, the
    flagged blocks transposed, the cat wrapped to int32."""
    res = cfg.occupancy_resolution
    F, nb = occ.shape[0], occ.shape[1]
    two = cfg.map_count > 1

    def u16(t):
        return t.to(torch.int64) & 0xFFFF

    def up(t, f):
        if f == 1:
            return t
        return t.repeat_interleave(f, dim=-2).repeat_interleave(f, dim=-1)

    occ_bit = (up(occ, cfg.occupancy_precision) > 0).to(torch.int64)
    d0 = u16(geo0)
    d1 = u16(geo1) if two else d0
    plane_a = d0 | (d1 << 10) | (occ_bit << 20)
    cup = 1 << cfg.chroma_shift

    def color(m):
        return (u16(ay[:, m]) | (up(u16(au[:, m]), cup) << 10)
                | (up(u16(av[:, m]), cup) << 20))

    plane_b = color(0)
    plane_c = color(1) if two else plane_b
    planes = torch.stack([plane_a, plane_b, plane_c], dim=2)
    flip = (swap != 0)[:, :, None, None, None]
    planes = torch.where(flip, planes.transpose(-1, -2), planes)
    return _wrap32(planes.reshape(F, nb, 3 * res * res))


def _check(occ, geo0, geo1, ay, au, av, swap, cfg):
    res = cfg.occupancy_resolution
    prec = cfg.occupancy_precision
    cs = cfg.chroma_shift
    if res < 1 or prec < 1 or res % prec or cs not in (0, 1) \
            or res % (1 << cs):
        raise ValueError(f"K5 takes no block edge {res} with occupancy "
                         f"precision {prec} and chroma shift {cs}")
    if occ.dim() != 4:
        raise ValueError(f"occ must be (F, nb, t, t), got {tuple(occ.shape)}")
    F, nb = occ.shape[0], occ.shape[1]
    M = ay.shape[1] if ay.dim() == 5 else 0
    if M not in (1, 2) or cfg.map_count > M:
        raise ValueError(f"ay must be (F, M, nb, {res}, {res}) with M in "
                         f"1..2 and at least {cfg.map_count} maps, got "
                         f"{tuple(ay.shape)}")
    want = {
        "occ": (occ, (F, nb, res // prec, res // prec), torch.uint8),
        "geo0": (geo0, (F, nb, res, res), torch.int16),
        "geo1": (geo1, (F, nb, res, res), torch.int16),
        "ay": (ay, (F, M, nb, res, res), torch.int16),
        "au": (au, (F, M, nb, res >> cs, res >> cs), torch.int16),
        "av": (av, (F, M, nb, res >> cs, res >> cs), torch.int16),
        "swap": (swap, (F, nb), torch.uint8),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
        if t.device != occ.device:
            raise ValueError(f"{name} lies on {t.device}, occ on "
                             f"{occ.device}")


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("pack_planes")
        lib.pack_planes.restype = ctypes.c_int
        lib.pack_planes.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_int64] * 2
            + [ctypes.c_int] * 5
            + [ctypes.c_void_p] * 2
        )
        _lib = lib
    return _lib


def _pack_cat_cuda(occ, geo0, geo1, ay, au, av, swap, cfg):
    tensors = (occ, geo0, geo1, ay, au, av, swap)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K5 takes contiguous planes")
    lib = _load()
    res = cfg.occupancy_resolution
    F, nb = occ.shape[0], occ.shape[1]
    dev = occ.device
    cat = torch.empty((F, nb, 3 * res * res), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pack_planes(
            *(t.data_ptr() for t in tensors), F, nb, ay.shape[1], res,
            cfg.occupancy_precision, cfg.chroma_shift,
            int(cfg.map_count > 1), cat.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"pack_planes kernel launch failed: CUDA error {rc}")
    _count_launch()
    return cat


def pack_cat(occ, geo0, geo1, ay, au, av, swap, cfg):
    """The cat ``(F, nb, 3*res*res)`` int32 of the block-tiled planes,
    the flagged blocks transposed (see the module note)."""
    _check(occ, geo0, geo1, ay, au, av, swap, cfg)
    if occ.device.type == "cpu":
        return pack_cat_plain(occ, geo0, geo1, ay, au, av, swap, cfg)
    if occ.device.type != "cuda":
        raise NotImplementedError(f"no K5 kernel for device {occ.device}")
    return _pack_cat_cuda(occ, geo0, geo1, ay, au, av, swap, cfg)
