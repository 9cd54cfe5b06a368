"""Grid smoothing of the wide path: geometry and colour.

Counterparts of ``tpu_vpcc.ops.smoothing.smooth_batch`` and
``smooth_colors_batch`` (the wide path's (F, S) slot tensors) and of
``smooth_flat`` and ``smooth_colors_flat`` (the gather fallback's slots,
flattened over the frames with an explicit frame index). Those are XLA
scatters in the JAX package, not Pallas kernels. Each pass is split
where the reference's ``scatter`` ends: the cell statistics
(:func:`geometry_stats`, :func:`color_stats`: six int32 grids of
``F * grid_width³`` flat cells, each frame's grid folded into the cell
axis) and the apply step (:func:`geometry_apply`, :func:`color_apply`:
neighbourhood, centroids, move). The grids of a frame's slot shards
combine exactly (:func:`combine_stats`, the mesh's counterpart of the
reference's ``psum``/``pmin``/``pmax`` over 'space').

On a CPU tensor each half runs its plain PyTorch version
(:func:`_stats_plain`, :func:`geometry_apply_plain`,
:func:`color_apply_plain`): ``index_add_`` and ``scatter_reduce_``
(``amin``/``amax``) over the flat cells, then a transcription of the
reference's ``_smooth_core`` and ``_smooth_color_core`` line for line,
in int32 (``//`` floors, as in numpy and JAX); cell indices are int64.
On a CUDA tensor it launches the hand-written kernels of
``csrc/grid_smooth.cu`` (one launch initialises the grids, one fills
them, one applies them: three a pass in place of some 250 PyTorch
operations) or raises. Integer scatters add exactly in any order, so
both give the same bytes whatever the device's atomics do; the plain
versions are the oracle the kernels are held to.

The two configurations are copied from ``tpu_vpcc.ops.smoothing``; its
numpy oracle is copied into :mod:`.smoothing_np`.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import _build


@dataclass(frozen=True)
class SmoothingConfig:
    """Static grid-smoothing parameters (from the GeometrySmoothing SEI:
    ``grid_size_minus_2 + 2`` and ``threshold``; ``reader.rs:1452-1505``)."""

    grid_size: int = 8
    threshold: int = 64  # squared-distance threshold
    geometry_bitdepth_3d: int = 10

    @property
    def grid_width(self) -> int:
        return -(-(1 << self.geometry_bitdepth_3d) // self.grid_size)


@dataclass(frozen=True)
class AttrSmoothingConfig:
    """Static attribute-smoothing parameters (from the AttributeSmoothing
    SEI, method 1): cells of ``grid_size``³, and two gates — replace a
    candidate's color with the neighborhood blend only when the local
    luma spread is at most ``threshold_variation`` (the region is
    homogeneous) AND the point's luma deviates from the blend by at least
    ``threshold_difference`` (the point is an outlier there)."""

    grid_size: int = 8
    threshold_variation: int = 10
    threshold_difference: int = 10
    geometry_bitdepth_3d: int = 10

    @property
    def grid_width(self) -> int:
        return -(-(1 << self.geometry_bitdepth_3d) // self.grid_size)


_BIG = np.int32(1 << 30)
BIG = int(_BIG)

#: kernel launches made by the smoothing kernels in this process: a pass
#: is three (the grids' initialisation and the statistics, then the apply)
launches = 0
_launch_lock = threading.Lock()
_thread = threading.local()
_lib = None


def reset_launches() -> None:
    global launches
    with _launch_lock:
        launches = 0


def _count_launches(n: int, passes: int = 0) -> None:
    """Adds ``n`` launches to :data:`launches` and ``passes`` (the apply
    launches, each of which ends a pass on one slot set) to the calling
    thread's :func:`thread_passes`."""
    global launches
    with _launch_lock:
        launches += n
    _thread.passes = thread_passes() + passes


def thread_passes() -> int:
    """The smoothing passes the calling thread has run on the kernels:
    one a launch of ``smooth_apply_kernel``, that is a pass on one slot
    set (one shard of a dispatch). Never reset; read it before and
    after."""
    return getattr(_thread, "passes", 0)


def uses_kernels(t) -> bool:
    """Whether smoothing on ``t``'s device runs the hand-written kernels
    (a CUDA tensor) or the plain PyTorch versions (a CPU tensor)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(f"no smoothing kernels for device {t.device}")


def _axis_neighborhood(coord, gs: int, gw: int):
    """Lower neighbour cell and hi-cell trilinear weight along one axis
    (the reference's ``_axis_neighborhood``)."""
    c = coord // gs
    local = coord - c * gs
    s = c + torch.where(local < gs // 2, -1, 0).to(torch.int32)
    w_hi = (coord - (s * gs + gs // 2)) * 2 + 1
    in_range = (s >= 0) & (s + 1 < gw)
    return s, w_hi, in_range


def _cells(xs, ys, zs, frame, gs: int, gw: int):
    """Each slot's cell id over all frames' grids, int64. The id within the
    frame is clipped to the frame's own cells before the base is added,
    as the per-frame oracle clips it: a point on the grid's far edge
    (a coordinate of ``gs * gw``) stays in its own frame's last cell
    and never lands in the next frame's grid."""
    n_cells = gw * gw * gw
    base = frame * n_cells
    local = (
        (zs // gs).to(torch.int64) * (gw * gw)
        + (ys // gs).to(torch.int64) * gw
        + (xs // gs).to(torch.int64)
    )
    return base + local.clamp(0, n_cells - 1)


def _scatter(cid, v, a, b, c, p, n_total: int):
    """Per-cell (count, sum a, sum b, sum c, min p, max p) over the valid
    slots, int32."""
    dev = cid.device

    def add(x):
        return torch.zeros(n_total, dtype=torch.int32, device=dev).index_add_(
            0, cid, x
        )

    min_p = torch.full((n_total,), BIG, dtype=torch.int32, device=dev)
    min_p.scatter_reduce_(0, cid, torch.where(v > 0, p, BIG), "amin")
    max_p = torch.full((n_total,), -BIG, dtype=torch.int32, device=dev)
    max_p.scatter_reduce_(0, cid, torch.where(v > 0, p, -BIG), "amax")
    return add(v), add(a * v), add(b * v), add(c * v), min_p, max_p


def _neighbourhood(xs, ys, zs, base, gs: int, gw: int):
    """The eight neighbour cells of each slot with their trilinear
    weights: ``(in_range, [(nid, w_corner), ...])`` in the reference's
    (dz, dy, dx) order; ``nid`` int64."""
    sx, wx_hi, okx = _axis_neighborhood(xs, gs, gw)
    sy, wy_hi, oky = _axis_neighborhood(ys, gs, gw)
    sz, wz_hi, okz = _axis_neighborhood(zs, gs, gw)
    in_range = okx & oky & okz
    sx = sx.clamp(0, gw - 2).to(torch.int64)
    sy = sy.clamp(0, gw - 2).to(torch.int64)
    sz = sz.clamp(0, gw - 2).to(torch.int64)
    corners = []
    for dz in (0, 1):
        wz = wz_hi if dz else 2 * gs - wz_hi
        for dy in (0, 1):
            wy = wy_hi if dy else 2 * gs - wy_hi
            for dx in (0, 1):
                wx = wx_hi if dx else 2 * gs - wx_hi
                nid = base + (sz + dz) * (gw * gw) + (sy + dy) * gw + (sx + dx)
                corners.append((nid, wx * wy * wz))
    return in_range, corners


def _round_div(num, den):
    return (num + den // 2) // den


def _stats_plain(xs, ys, zs, a, b, c, valid, pid, frame, n_frames: int,
                 cfg):
    """The six cell grids of ``cfg``'s grid over the valid slots (cells
    from ``xs, ys, zs``, sums of the payload ``a, b, c``), in plain
    PyTorch on the tensors' device."""
    gs, gw = cfg.grid_size, cfg.grid_width
    cid = _cells(xs, ys, zs, frame, gs, gw)
    return _scatter(cid, valid.to(torch.int32), a, b, c, pid,
                    n_frames * gw * gw * gw)


def _stats(xs, ys, zs, a, b, c, valid, pid, frame, n_frames: int, cfg):
    """:func:`_stats_plain`'s grids, by the kernels on a CUDA tensor."""
    args = (xs, ys, zs, a, b, c, valid, pid, frame, n_frames, cfg)
    if uses_kernels(xs):
        return _stats_cuda(*args)
    return _stats_plain(*args)


def geometry_stats(xs, ys, zs, valid, pid, frame, n_frames: int,
                   cfg: SmoothingConfig):
    """The cell statistics of geometry smoothing, the first half of the
    reference's ``_smooth_core`` (up to its ``scatter``): ``(count, sum
    x, sum y, sum z, min pid, max pid)``, each an int32 grid of
    ``n_frames * grid_width³`` cells. Flat int32 ``xs, ys, zs, pid``,
    bool ``valid``, int64 ``frame``. Grids of slot subsets of the same
    frames combine exactly (:func:`combine_stats`)."""
    return _stats(xs, ys, zs, xs, ys, zs, valid, pid, frame, n_frames, cfg)


def geometry_apply(stats, xs, ys, zs, valid, pid, frame,
                   cfg: SmoothingConfig):
    """The second half of ``tpu_vpcc.ops.smoothing._smooth_core``: each
    slot's neighbourhood in the grids ``stats`` (:func:`geometry_stats`
    of the whole frames), the centroids and the move. Returns the flat
    int32 smoothed ``xs, ys, zs``: :func:`geometry_apply_plain`'s, by the
    kernel on a CUDA tensor."""
    if uses_kernels(xs):
        return _apply_cuda(stats, xs, ys, zs, xs, ys, zs, valid, pid, frame,
                           cfg, color=False)
    return geometry_apply_plain(stats, xs, ys, zs, valid, pid, frame, cfg)


def geometry_apply_plain(stats, xs, ys, zs, valid, pid, frame,
                         cfg: SmoothingConfig):
    """:func:`geometry_apply` in plain PyTorch on the tensors' device."""
    gs, gw = cfg.grid_size, cfg.grid_width
    counts, sum_x, sum_y, sum_z, min_p, max_p = stats
    # per-cell rounded centroid (count-0 cells unused)
    cnt_safe = counts.clamp(min=1)
    cen_x = _round_div(sum_x, cnt_safe)
    cen_y = _round_div(sum_y, cnt_safe)
    cen_z = _round_div(sum_z, cnt_safe)

    base = frame * (gw * gw * gw)
    in_range, corners = _neighbourhood(xs, ys, zs, base, gs, gw)
    V_x = torch.zeros_like(xs)
    V_y = torch.zeros_like(xs)
    V_z = torch.zeros_like(xs)
    W = torch.zeros_like(xs)
    other = torch.zeros_like(xs, dtype=torch.bool)
    for nid, w_corner in corners:
        has = counts[nid] > 0
        w = w_corner * has.to(torch.int32)
        V_x = V_x + w * cen_x[nid]
        V_y = V_y + w * cen_y[nid]
        V_z = V_z + w * cen_z[nid]
        W = W + w
        other = other | (has & ((min_p[nid] != pid) | (max_p[nid] != pid)))

    W_safe = W.clamp(min=1)
    c_x = _round_div(V_x, W_safe)
    c_y = _round_div(V_y, W_safe)
    c_z = _round_div(V_z, W_safe)
    dist2 = (xs - c_x) ** 2 + (ys - c_y) ** 2 + (zs - c_z) ** 2
    move = valid & in_range & other & (W > 0) & (dist2 >= cfg.threshold)
    return (
        torch.where(move, c_x, xs),
        torch.where(move, c_y, ys),
        torch.where(move, c_z, zs),
    )


def color_stats(xs, ys, zs, cy, cu, cv, valid, pid, frame, n_frames: int,
                cfg: AttrSmoothingConfig):
    """The cell statistics of colour smoothing (geometry cells, colour
    sums): the first half of the reference's ``_smooth_color_core``, as
    :func:`geometry_stats` is of ``_smooth_core``."""
    return _stats(xs, ys, zs, cy, cu, cv, valid, pid, frame, n_frames, cfg)


def color_apply(stats, xs, ys, zs, cy, cu, cv, valid, pid, frame,
                cfg: AttrSmoothingConfig):
    """The second half of ``tpu_vpcc.ops.smoothing._smooth_color_core``
    on the grids ``stats`` (:func:`color_stats`). Returns the flat int32
    ``cy, cu, cv``: :func:`color_apply_plain`'s, by the kernel on a CUDA
    tensor."""
    if uses_kernels(xs):
        return _apply_cuda(stats, xs, ys, zs, cy, cu, cv, valid, pid, frame,
                           cfg, color=True)
    return color_apply_plain(stats, xs, ys, zs, cy, cu, cv, valid, pid,
                             frame, cfg)


def color_apply_plain(stats, xs, ys, zs, cy, cu, cv, valid, pid, frame,
                      cfg: AttrSmoothingConfig):
    """:func:`color_apply` in plain PyTorch on the tensors' device."""
    gs, gw = cfg.grid_size, cfg.grid_width
    counts, sum_y, sum_u, sum_v, min_p, max_p = stats
    cnt_safe = counts.clamp(min=1)
    cen_y = _round_div(sum_y, cnt_safe)
    cen_u = _round_div(sum_u, cnt_safe)
    cen_v = _round_div(sum_v, cnt_safe)

    base = frame * (gw * gw * gw)
    in_range, corners = _neighbourhood(xs, ys, zs, base, gs, gw)
    V_y = torch.zeros_like(xs)
    V_u = torch.zeros_like(xs)
    V_v = torch.zeros_like(xs)
    W = torch.zeros_like(xs)
    other = torch.zeros_like(xs, dtype=torch.bool)
    y_min = torch.full_like(xs, BIG)
    y_max = torch.full_like(xs, -BIG)
    for nid, w_corner in corners:
        has = counts[nid] > 0
        w = w_corner * has.to(torch.int32)
        cy_n = cen_y[nid]
        V_y = V_y + w * cy_n
        V_u = V_u + w * cen_u[nid]
        V_v = V_v + w * cen_v[nid]
        W = W + w
        other = other | (has & ((min_p[nid] != pid) | (max_p[nid] != pid)))
        y_min = torch.minimum(y_min, torch.where(has, cy_n, BIG))
        y_max = torch.maximum(y_max, torch.where(has, cy_n, -BIG))

    W_safe = W.clamp(min=1)
    b_y = _round_div(V_y, W_safe)
    b_u = _round_div(V_u, W_safe)
    b_v = _round_div(V_v, W_safe)
    spread = y_max - y_min
    dev = (cy - b_y).abs()
    move = (
        valid
        & in_range
        & other
        & (W > 0)
        & (spread <= cfg.threshold_variation)
        & (dev >= cfg.threshold_difference)
    )
    return (
        torch.where(move, b_y, cy),
        torch.where(move, b_u, cu),
        torch.where(move, b_v, cv),
    )


def _check_slots(**named):
    """The slot count of flat slot arrays that the kernels take: one
    length, one device, contiguous, ``valid`` bool, ``frame`` int64 and
    the rest int32. Raises before any launch on anything else."""
    n = dev = None
    for name, t in named.items():
        want = {"valid": torch.bool, "frame": torch.int64}.get(name,
                                                               torch.int32)
        if t.dtype != want:
            raise TypeError(f"{name}: dtype {t.dtype}, want {want}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be flat and contiguous, got "
                             f"shape {tuple(t.shape)}, strides "
                             f"{t.stride()}")
        if n is None:
            n, dev = t.numel(), t.device
        elif t.numel() != n:
            raise ValueError(f"{name} has {t.numel()} slots, xs {n}")
        elif t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, xs on {dev}")
    return n


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("grid_smooth")
        lib.smooth_stats.restype = ctypes.c_int
        lib.smooth_stats.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 2
            + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        )
        lib.smooth_apply.restype = ctypes.c_int
        lib.smooth_apply.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 15 + [ctypes.c_int64] * 2
            + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        )
        _lib = lib
    return _lib


def _stats_cuda(xs, ys, zs, a, b, c, valid, pid, frame, n_frames: int,
                cfg):
    """The six grids by ``smooth_stats_kernel`` (after one launch of
    ``smooth_init_kernel``): rows of one (6, n_frames * grid_width³)
    int32 tensor, byte-equal to :func:`_stats_plain`'s."""
    n = _check_slots(xs=xs, ys=ys, zs=zs, a=a, b=b, c=c, valid=valid,
                     pid=pid, frame=frame)
    if n_frames < 1:
        raise ValueError(f"n_frames must be at least 1, got {n_frames}")
    gs, gw = cfg.grid_size, cfg.grid_width
    lib = _load()
    dev = xs.device
    grids = torch.empty((6, n_frames * gw ** 3), dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.smooth_stats(
            *(t.data_ptr() for t in (xs, ys, zs, a, b, c, valid, pid,
                                     frame)),
            n, n_frames, gs, gw, grids.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"smooth_stats kernel launch failed: CUDA error "
                           f"{rc}")
    _count_launches(2)
    return tuple(grids.unbind(0))


def _apply_cuda(stats, xs, ys, zs, a, b, c, valid, pid, frame, cfg,
                color: bool):
    """``smooth_apply_kernel``: the smoothed payload ``a, b, c`` (the
    positions for geometry, ``cy, cu, cv`` for colour) on the grids
    ``stats``, byte-equal to :func:`geometry_apply_plain`'s or
    :func:`color_apply_plain`'s."""
    n = _check_slots(xs=xs, ys=ys, zs=zs, a=a, b=b, c=c, valid=valid,
                     pid=pid, frame=frame)
    gs, gw = cfg.grid_size, cfg.grid_width
    if len(stats) != 6:
        raise ValueError(f"stats must be six grids, got {len(stats)}")
    cells = stats[0].numel()
    for k, t in enumerate(stats):
        if t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous() or t.numel() != cells \
                or t.device != xs.device:
            raise ValueError(f"stats[{k}] must be a flat contiguous int32 "
                             f"grid of {cells} cells on {xs.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if cells == 0 or cells % gw ** 3:
        raise ValueError(f"grids of {cells} cells hold no whole number of "
                         f"{gw}³ frame grids")
    if color:
        thr_a, thr_b = cfg.threshold_variation, cfg.threshold_difference
    else:
        thr_a, thr_b = cfg.threshold, 0
    lib = _load()
    dev = xs.device
    out = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.smooth_apply(
            int(color), *(t.data_ptr() for t in stats),
            *(t.data_ptr() for t in (xs, ys, zs, a, b, c, valid, pid,
                                     frame)),
            n, cells // gw ** 3, gs, gw, thr_a, thr_b,
            *(t.data_ptr() for t in out), stream,
        )
    if rc != 0:
        raise RuntimeError(f"smooth_apply kernel launch failed: CUDA error "
                           f"{rc}")
    _count_launches(1, passes=1)
    return tuple(out)


def combine_stats(stats_list, devices):
    """The cell statistics of several slot subsets of the same frames
    (one per shard) combined into those of the whole frames: the
    counterpart of the reference's ``psum``/``pmin``/``pmax`` over the
    mesh's 'space' axis. Counts and sums add, ``min_p`` takes the
    minimum and ``max_p`` the maximum, on ``devices[0]``. Integer sums,
    minima and maxima are exact in any order, so the result is the
    unsharded statistics' bytes. Returns one copy per entry of
    ``devices`` (shard order), made once per distinct device: shards on
    one device share it."""
    home = torch.device(devices[0])
    acc = [t.to(home) for t in stats_list[0]]
    for stats in stats_list[1:]:
        part = [t.to(home) for t in stats]
        acc = [a + p for a, p in zip(acc[:4], part[:4])] + [
            torch.minimum(acc[4], part[4]),
            torch.maximum(acc[5], part[5]),
        ]
    copies = {}
    for d in devices:
        d = torch.device(d)
        if d not in copies:
            copies[d] = acc if d == home else [t.to(d) for t in acc]
    return [copies[torch.device(d)] for d in devices]


def _flat_frames(xs):
    F, S = xs.shape
    frame = torch.arange(F, dtype=torch.int64, device=xs.device)
    return frame[:, None].expand(F, S).reshape(-1)


def _flat(t, dtype):
    """``t`` flat and contiguous in ``dtype``, as the kernels take it (a
    flattened broadcast, such as one frame's index over its slots, is a
    strided view until copied)."""
    return t.reshape(-1).to(dtype).contiguous()


def _i32(t):
    return _flat(t, torch.int32)


def smooth_flat(xs, ys, zs, valid, pid, frame, n_frames: int,
                cfg: SmoothingConfig):
    """Geometry smoothing over flat slot tensors: ``frame`` is each
    slot's frame index (one grid per frame, ``n_frames`` of them).
    ``xs, ys, zs, pid`` integer, ``valid`` bool; returns the flat int32
    smoothed ``xs, ys, zs``. The reference's ``_smooth_core``:
    :func:`geometry_apply` of :func:`geometry_stats`."""
    args = (_i32(xs), _i32(ys), _i32(zs), _flat(valid, torch.bool),
            _i32(pid), _flat(frame, torch.int64))
    return geometry_apply(geometry_stats(*args, n_frames, cfg), *args, cfg)


def smooth_colors_flat(xs, ys, zs, cy, cu, cv, valid, pid, frame,
                       n_frames: int, cfg: AttrSmoothingConfig):
    """Colour smoothing over flat slot tensors on the positions' grid,
    one grid per frame (see :func:`smooth_flat`); returns the flat int32
    ``cy, cu, cv``: :func:`color_apply` of :func:`color_stats`."""
    args = (_i32(xs), _i32(ys), _i32(zs), _i32(cy), _i32(cu), _i32(cv),
            _flat(valid, torch.bool), _i32(pid), _flat(frame, torch.int64))
    return color_apply(color_stats(*args, n_frames, cfg), *args, cfg)


def smooth_batch(xs, ys, zs, valid, pid, cfg: SmoothingConfig):
    """Geometry smoothing over (F, S) slot tensors, one grid per frame.
    ``xs, ys, zs, pid`` integer, ``valid`` bool; returns the (F, S)
    int32 smoothed ``xs, ys, zs``."""
    F, S = xs.shape
    out = smooth_flat(xs, ys, zs, valid, pid, _flat_frames(xs), F, cfg)
    return tuple(a.reshape(F, S) for a in out)


def smooth_colors_batch(xs, ys, zs, cy, cu, cv, valid, pid,
                        cfg: AttrSmoothingConfig):
    """Colour smoothing over (F, S) slot tensors on the positions' grid,
    one grid per frame; returns the (F, S) int32 ``cy, cu, cv``."""
    F, S = xs.shape
    out = smooth_colors_flat(xs, ys, zs, cy, cu, cv, valid, pid,
                             _flat_frames(xs), F, cfg)
    return tuple(a.reshape(F, S) for a in out)
