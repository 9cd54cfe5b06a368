"""Grid smoothing of the wide path: geometry and colour.

Counterparts of ``tpu_vpcc.ops.smoothing.smooth_batch`` and
``smooth_colors_batch`` (the wide path's (F, S) slot tensors) and of
``smooth_flat`` and ``smooth_colors_flat`` (the gather fallback's slots,
flattened over the frames with an explicit frame index). Those are XLA
scatters in the JAX package, not Pallas kernels, so here they stay plain
PyTorch on the tensors' device:
``index_add_`` and ``scatter_reduce_`` (``amin``/``amax``) over
``F * grid_width³`` flat cells, each frame's grid folded into the cell
axis. :func:`_smooth_core` and :func:`_smooth_color_core` transcribe the
reference's integer specification line for line, in int32 (``//``
floors, as in numpy and JAX); cell indices are int64. Integer scatters
add exactly in any order, so the result does not depend on the
device's atomics.

The two configurations are copied from ``tpu_vpcc.ops.smoothing``; its
numpy oracle is copied into :mod:`.smoothing_np`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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


def _axis_neighborhood(coord, gs: int, gw: int):
    """Lower neighbour cell and hi-cell trilinear weight along one axis
    (the reference's ``_axis_neighborhood``)."""
    c = coord // gs
    local = coord - c * gs
    s = c + torch.where(local < gs // 2, -1, 0).to(torch.int32)
    w_hi = (coord - (s * gs + gs // 2)) * 2 + 1
    in_range = (s >= 0) & (s + 1 < gw)
    return s, w_hi, in_range


def _cells(xs, ys, zs, frame, n_frames: int, gs: int, gw: int):
    """Each slot's frame cell base and clipped cell id, int64."""
    n_cells = gw * gw * gw
    base = frame * n_cells
    cid = (
        base
        + (zs // gs).to(torch.int64) * (gw * gw)
        + (ys // gs).to(torch.int64) * gw
        + (xs // gs).to(torch.int64)
    )
    return base, cid.clamp(0, n_frames * n_cells - 1)


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


def _smooth_core(xs, ys, zs, valid, pid, frame, n_frames: int,
                 cfg: SmoothingConfig):
    """``tpu_vpcc.ops.smoothing._smooth_core`` on flat int32 tensors;
    ``frame`` (int64) maps each slot to its frame's grid."""
    gs, gw = cfg.grid_size, cfg.grid_width
    v = valid.to(torch.int32)
    base, cid = _cells(xs, ys, zs, frame, n_frames, gs, gw)
    counts, sum_x, sum_y, sum_z, min_p, max_p = _scatter(
        cid, v, xs, ys, zs, pid, n_frames * gw * gw * gw
    )
    # per-cell rounded centroid (count-0 cells unused)
    cnt_safe = counts.clamp(min=1)
    cen_x = _round_div(sum_x, cnt_safe)
    cen_y = _round_div(sum_y, cnt_safe)
    cen_z = _round_div(sum_z, cnt_safe)

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
    move = (v > 0) & in_range & other & (W > 0) & (dist2 >= cfg.threshold)
    return (
        torch.where(move, c_x, xs),
        torch.where(move, c_y, ys),
        torch.where(move, c_z, zs),
    )


def _smooth_color_core(xs, ys, zs, cy, cu, cv, valid, pid, frame,
                       n_frames: int, cfg: AttrSmoothingConfig):
    """``tpu_vpcc.ops.smoothing._smooth_color_core`` on flat int32
    tensors (geometry cells, colour payload)."""
    gs, gw = cfg.grid_size, cfg.grid_width
    v = valid.to(torch.int32)
    base, cid = _cells(xs, ys, zs, frame, n_frames, gs, gw)
    counts, sum_y, sum_u, sum_v, min_p, max_p = _scatter(
        cid, v, cy, cu, cv, pid, n_frames * gw * gw * gw
    )
    cnt_safe = counts.clamp(min=1)
    cen_y = _round_div(sum_y, cnt_safe)
    cen_u = _round_div(sum_u, cnt_safe)
    cen_v = _round_div(sum_v, cnt_safe)

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
        (v > 0)
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


def _flat_frames(xs):
    F, S = xs.shape
    frame = torch.arange(F, dtype=torch.int64, device=xs.device)
    return frame[:, None].expand(F, S).reshape(-1)


def _i32(t):
    return t.reshape(-1).to(torch.int32)


def smooth_flat(xs, ys, zs, valid, pid, frame, n_frames: int,
                cfg: SmoothingConfig):
    """Geometry smoothing over flat slot tensors: ``frame`` is each
    slot's frame index (one grid per frame, ``n_frames`` of them).
    ``xs, ys, zs, pid`` integer, ``valid`` bool; returns the flat int32
    smoothed ``xs, ys, zs``."""
    return _smooth_core(
        _i32(xs), _i32(ys), _i32(zs), valid.reshape(-1), _i32(pid),
        frame.reshape(-1).to(torch.int64), n_frames, cfg,
    )


def smooth_colors_flat(xs, ys, zs, cy, cu, cv, valid, pid, frame,
                       n_frames: int, cfg: AttrSmoothingConfig):
    """Colour smoothing over flat slot tensors on the positions' grid,
    one grid per frame (see :func:`smooth_flat`); returns the flat int32
    ``cy, cu, cv``."""
    return _smooth_color_core(
        _i32(xs), _i32(ys), _i32(zs), _i32(cy), _i32(cu), _i32(cv),
        valid.reshape(-1), _i32(pid), frame.reshape(-1).to(torch.int64),
        n_frames, cfg,
    )


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
