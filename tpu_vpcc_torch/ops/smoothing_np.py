"""The numpy oracle of grid smoothing, geometry and colour.

Copied from ``tpu_vpcc.ops.smoothing`` (its numpy half): the shared
integer algorithm of :func:`_smooth_core` and :func:`_smooth_color_core`
run with numpy, :func:`smooth_slots_np` and :func:`smooth_colors_np` on
one frame's flat arrays. The oracle decode path applies them; the
device path's PyTorch transcription is :mod:`.smoothing`. Also copied
from there: :func:`smooth_slots_f64` and :func:`smooth_colors_f64`, the
TMC2-faithful f64 comparison oracles, which no decode path runs.
"""

from __future__ import annotations

import numpy as np

from .smoothing import _BIG, AttrSmoothingConfig, SmoothingConfig


def _axis_neighborhood(np_, coord, gs: int, gw: int):
    """Lower neighbor cell index and hi-cell trilinear weight for one
    axis. Weights are odd integers in [1, 2*gs-1]; lo weight is their
    complement to 2*gs (linear interpolation between cell centers)."""
    c = coord // gs
    local = coord - c * gs
    s = c + np_.where(local < gs // 2, -1, 0)
    w_hi = (coord - (s * gs + gs // 2)) * 2 + 1
    in_range = (s >= 0) & (s + 1 < gw)
    return s, w_hi, in_range


def _smooth_core(np_, xs, ys, zs, valid, pid, frame, n_frames,
                 cfg: SmoothingConfig, make_scatter):
    """Shared integer algorithm. ``np_`` is numpy or jax.numpy;
    ``frame`` maps each slot to its frame (one grid per frame);
    ``make_scatter(cid, ...)`` performs (add, min, max) accumulation
    into ``n_frames * grid_width³`` flat cells."""
    gs, gw = cfg.grid_size, cfg.grid_width
    n_cells = gw * gw * gw

    xs = xs.astype(np_.int32)
    ys = ys.astype(np_.int32)
    zs = zs.astype(np_.int32)
    pid = pid.astype(np_.int32)
    v = valid.astype(np_.int32)

    base = frame * n_cells
    cid = base + (zs // gs) * (gw * gw) + (ys // gs) * gw + (xs // gs)
    cid = np_.clip(cid, 0, n_frames * n_cells - 1)

    counts, sum_x, sum_y, sum_z, min_p, max_p = make_scatter(
        cid, v, xs, ys, zs, pid, n_frames * n_cells
    )

    # per-cell rounded centroid (int; count 0 cells unused)
    cnt_safe = np_.maximum(counts, 1)
    cen_x = (sum_x + cnt_safe // 2) // cnt_safe
    cen_y = (sum_y + cnt_safe // 2) // cnt_safe
    cen_z = (sum_z + cnt_safe // 2) // cnt_safe

    sx, wx_hi, okx = _axis_neighborhood(np_, xs, gs, gw)
    sy, wy_hi, oky = _axis_neighborhood(np_, ys, gs, gw)
    sz, wz_hi, okz = _axis_neighborhood(np_, zs, gs, gw)
    in_range = okx & oky & okz
    sx = np_.clip(sx, 0, gw - 2)
    sy = np_.clip(sy, 0, gw - 2)
    sz = np_.clip(sz, 0, gw - 2)

    V_x = np_.zeros_like(xs)
    V_y = np_.zeros_like(xs)
    V_z = np_.zeros_like(xs)
    W = np_.zeros_like(xs)
    other = np_.zeros_like(xs, dtype=bool)
    for dz in (0, 1):
        wz = wz_hi if dz else 2 * gs - wz_hi
        for dy in (0, 1):
            wy = wy_hi if dy else 2 * gs - wy_hi
            for dx in (0, 1):
                wx = wx_hi if dx else 2 * gs - wx_hi
                nid = base + (sz + dz) * (gw * gw) + (sy + dy) * gw + (sx + dx)
                c_cnt = counts[nid]
                has = c_cnt > 0
                w = wx * wy * wz * has.astype(np_.int32)
                V_x = V_x + w * cen_x[nid]
                V_y = V_y + w * cen_y[nid]
                V_z = V_z + w * cen_z[nid]
                W = W + w
                other = other | (
                    has & ((min_p[nid] != pid) | (max_p[nid] != pid))
                )

    W_safe = np_.maximum(W, 1)
    c_x = (V_x + W_safe // 2) // W_safe
    c_y = (V_y + W_safe // 2) // W_safe
    c_z = (V_z + W_safe // 2) // W_safe

    dist2 = (xs - c_x) ** 2 + (ys - c_y) ** 2 + (zs - c_z) ** 2
    move = (v > 0) & in_range & other & (W > 0) & (dist2 >= cfg.threshold)

    out_x = np_.where(move, c_x, xs)
    out_y = np_.where(move, c_y, ys)
    out_z = np_.where(move, c_z, zs)
    return out_x, out_y, out_z


def smooth_slots_np(xs, ys, zs, valid, pid, cfg: SmoothingConfig):
    """NumPy twin (single frame, flat arrays) — the oracle."""

    def scatter(cid, v, x, y, z, p, n_total):
        counts = np.zeros(n_total, np.int32)
        np.add.at(counts, cid, v)
        sums = []
        for a in (x, y, z):
            s = np.zeros(n_total, np.int32)
            np.add.at(s, cid, a.astype(np.int32) * v)
            sums.append(s)
        min_p = np.full(n_total, _BIG, np.int32)
        np.minimum.at(min_p, cid, np.where(v > 0, p, _BIG))
        max_p = np.full(n_total, -_BIG, np.int32)
        np.maximum.at(max_p, cid, np.where(v > 0, p, -_BIG))
        return counts, sums[0], sums[1], sums[2], min_p, max_p

    xs = np.asarray(xs, np.int32)
    frame = np.zeros_like(xs)
    return _smooth_core(
        np, xs, np.asarray(ys, np.int32), np.asarray(zs, np.int32),
        np.asarray(valid), np.asarray(pid, np.int32), frame, 1, cfg, scatter,
    )


def _smooth_color_core(np_, xs, ys, zs, cy, cu, cv, valid, pid, frame,
                       n_frames, cfg: AttrSmoothingConfig, make_scatter):
    """Shared integer color-smoothing algorithm (geometry cells, color
    payload). Same rounding/weight spec as :func:`_smooth_core`."""
    gs, gw = cfg.grid_size, cfg.grid_width
    n_cells = gw * gw * gw

    xs = xs.astype(np_.int32)
    ys = ys.astype(np_.int32)
    zs = zs.astype(np_.int32)
    cy = cy.astype(np_.int32)
    cu = cu.astype(np_.int32)
    cv = cv.astype(np_.int32)
    pid = pid.astype(np_.int32)
    v = valid.astype(np_.int32)

    base = frame * n_cells
    cid = base + (zs // gs) * (gw * gw) + (ys // gs) * gw + (xs // gs)
    cid = np_.clip(cid, 0, n_frames * n_cells - 1)

    counts, sum_y, sum_u, sum_v, min_p, max_p = make_scatter(
        cid, v, cy, cu, cv, pid, n_frames * n_cells
    )
    cnt_safe = np_.maximum(counts, 1)
    cen_y = (sum_y + cnt_safe // 2) // cnt_safe
    cen_u = (sum_u + cnt_safe // 2) // cnt_safe
    cen_v = (sum_v + cnt_safe // 2) // cnt_safe

    sx, wx_hi, okx = _axis_neighborhood(np_, xs, gs, gw)
    sy, wy_hi, oky = _axis_neighborhood(np_, ys, gs, gw)
    sz, wz_hi, okz = _axis_neighborhood(np_, zs, gs, gw)
    in_range = okx & oky & okz
    sx = np_.clip(sx, 0, gw - 2)
    sy = np_.clip(sy, 0, gw - 2)
    sz = np_.clip(sz, 0, gw - 2)

    V_y = np_.zeros_like(xs)
    V_u = np_.zeros_like(xs)
    V_v = np_.zeros_like(xs)
    W = np_.zeros_like(xs)
    other = np_.zeros_like(xs, dtype=bool)
    y_min = np_.full_like(xs, _BIG)
    y_max = np_.full_like(xs, -_BIG)
    for dz in (0, 1):
        wz = wz_hi if dz else 2 * gs - wz_hi
        for dy in (0, 1):
            wy = wy_hi if dy else 2 * gs - wy_hi
            for dx in (0, 1):
                wx = wx_hi if dx else 2 * gs - wx_hi
                nid = base + (sz + dz) * (gw * gw) + (sy + dy) * gw + (sx + dx)
                has = counts[nid] > 0
                w = wx * wy * wz * has.astype(np_.int32)
                V_y = V_y + w * cen_y[nid]
                V_u = V_u + w * cen_u[nid]
                V_v = V_v + w * cen_v[nid]
                W = W + w
                other = other | (
                    has & ((min_p[nid] != pid) | (max_p[nid] != pid))
                )
                y_min = np_.minimum(y_min, np_.where(has, cen_y[nid], _BIG))
                y_max = np_.maximum(y_max, np_.where(has, cen_y[nid], -_BIG))

    W_safe = np_.maximum(W, 1)
    b_y = (V_y + W_safe // 2) // W_safe
    b_u = (V_u + W_safe // 2) // W_safe
    b_v = (V_v + W_safe // 2) // W_safe

    spread = y_max - y_min
    dev = np_.abs(cy - b_y)
    move = (
        (v > 0)
        & in_range
        & other
        & (W > 0)
        & (spread <= cfg.threshold_variation)
        & (dev >= cfg.threshold_difference)
    )
    out_y = np_.where(move, b_y, cy)
    out_u = np_.where(move, b_u, cu)
    out_v = np_.where(move, b_v, cv)
    return out_y, out_u, out_v


def smooth_colors_np(xs, ys, zs, cy, cu, cv, valid, pid,
                     cfg: AttrSmoothingConfig):
    """NumPy twin (single frame, flat arrays) — the oracle."""

    def scatter(cid, v, a, b, c, p, n_total):
        counts = np.zeros(n_total, np.int32)
        np.add.at(counts, cid, v)
        sums = []
        for arr in (a, b, c):
            s = np.zeros(n_total, np.int32)
            np.add.at(s, cid, arr.astype(np.int32) * v)
            sums.append(s)
        min_p = np.full(n_total, _BIG, np.int32)
        np.minimum.at(min_p, cid, np.where(v > 0, p, _BIG))
        max_p = np.full(n_total, -_BIG, np.int32)
        np.maximum.at(max_p, cid, np.where(v > 0, p, -_BIG))
        return counts, sums[0], sums[1], sums[2], min_p, max_p

    z = np.zeros_like(np.asarray(xs, np.int32))
    return _smooth_color_core(
        np, np.asarray(xs, np.int32), np.asarray(ys, np.int32),
        np.asarray(zs, np.int32), np.asarray(cy, np.int32),
        np.asarray(cu, np.int32), np.asarray(cv, np.int32),
        np.asarray(valid), np.asarray(pid, np.int32), z, 1, cfg, scatter,
    )


def smooth_slots_f64(xs, ys, zs, valid, pid, cfg: SmoothingConfig):
    """TMC2-v18-faithful f64 smoothing oracle (single frame, flat arrays).

    Same cell decomposition, neighborhood, integer trilinear weights, and
    other-cluster gate as the int32 spec, but with TMC2's floating-point
    arithmetic: per-cell centroids are f64 averages (``sum / count``), the
    trilinear blend divides in f64, the squared-distance test runs in
    f64, and the moved point is rounded half-up to the integer lattice.
    This is the comparison target used to quantify how far the
    framework's pure-int32 spec (:func:`smooth_slots_np`) diverges from
    TMC2's ``smoothPointCloudGrid`` semantics — the reference itself
    panics before smoothing (``src/decoder.rs:291-293``),
    so there is no bitstream-parity constraint; divergence bounds are
    recorded in PERFORMANCE.md. Not used on the production path.
    """
    gs, gw = cfg.grid_size, cfg.grid_width
    n_cells = gw * gw * gw

    xs = np.asarray(xs, np.int64)
    ys = np.asarray(ys, np.int64)
    zs = np.asarray(zs, np.int64)
    pid = np.asarray(pid, np.int32)
    v = np.asarray(valid).astype(bool)

    cid = (zs // gs) * (gw * gw) + (ys // gs) * gw + (xs // gs)
    cid = np.clip(cid, 0, n_cells - 1)

    counts = np.zeros(n_cells, np.int64)
    np.add.at(counts, cid, v.astype(np.int64))
    cen = np.zeros((n_cells, 3), np.float64)
    for k, a in enumerate((xs, ys, zs)):
        s = np.zeros(n_cells, np.int64)
        np.add.at(s, cid, np.where(v, a, 0))
        cen[:, k] = s / np.maximum(counts, 1)  # f64 average (TMC2 center)
    min_p = np.full(n_cells, _BIG, np.int32)
    np.minimum.at(min_p, cid, np.where(v, pid, _BIG))
    max_p = np.full(n_cells, -_BIG, np.int32)
    np.maximum.at(max_p, cid, np.where(v, pid, -_BIG))

    sx, wx_hi, okx = _axis_neighborhood(np, xs, gs, gw)
    sy, wy_hi, oky = _axis_neighborhood(np, ys, gs, gw)
    sz, wz_hi, okz = _axis_neighborhood(np, zs, gs, gw)
    in_range = okx & oky & okz
    sx = np.clip(sx, 0, gw - 2)
    sy = np.clip(sy, 0, gw - 2)
    sz = np.clip(sz, 0, gw - 2)

    V = np.zeros((xs.shape[0], 3), np.float64)
    W = np.zeros(xs.shape[0], np.float64)
    other = np.zeros(xs.shape[0], bool)
    for dz in (0, 1):
        wz = wz_hi if dz else 2 * gs - wz_hi
        for dy in (0, 1):
            wy = wy_hi if dy else 2 * gs - wy_hi
            for dx in (0, 1):
                wx = wx_hi if dx else 2 * gs - wx_hi
                nid = (sz + dz) * (gw * gw) + (sy + dy) * gw + (sx + dx)
                has = counts[nid] > 0
                w = (wx * wy * wz).astype(np.float64) * has
                V += w[:, None] * cen[nid]
                W += w
                other |= has & ((min_p[nid] != pid) | (max_p[nid] != pid))

    W_safe = np.maximum(W, 1.0)
    c = V / W_safe[:, None]
    cur = np.stack([xs, ys, zs], axis=1).astype(np.float64)
    dist2 = ((cur - c) ** 2).sum(axis=1)
    move = v & in_range & other & (W > 0) & (dist2 >= cfg.threshold)

    out = np.where(move[:, None], np.floor(c + 0.5), cur)
    return out[:, 0].astype(np.int32), out[:, 1].astype(np.int32), out[:, 2].astype(np.int32)


def smooth_colors_f64(xs, ys, zs, cy, cu, cv, valid, pid,
                      cfg: AttrSmoothingConfig):
    """TMC2-style f64 color-smoothing oracle (single frame, flat arrays).

    Float analog of :func:`smooth_colors_np`: f64 per-cell luma/chroma
    centroids, f64 trilinear blend, f64 gates (luma spread of occupied
    neighbor cells ≤ threshold_variation AND |luma − blend| ≥
    threshold_difference), blended color rounded half-up. Comparison
    target only; divergence vs the int32 spec recorded in PERFORMANCE.md.
    """
    gs, gw = cfg.grid_size, cfg.grid_width
    n_cells = gw * gw * gw

    xs = np.asarray(xs, np.int64)
    ys = np.asarray(ys, np.int64)
    zs = np.asarray(zs, np.int64)
    cols = np.stack([np.asarray(cy, np.int64), np.asarray(cu, np.int64),
                     np.asarray(cv, np.int64)], axis=1)
    pid = np.asarray(pid, np.int32)
    v = np.asarray(valid).astype(bool)

    cid = (zs // gs) * (gw * gw) + (ys // gs) * gw + (xs // gs)
    cid = np.clip(cid, 0, n_cells - 1)

    counts = np.zeros(n_cells, np.int64)
    np.add.at(counts, cid, v.astype(np.int64))
    cen = np.zeros((n_cells, 3), np.float64)
    for k in range(3):
        s = np.zeros(n_cells, np.int64)
        np.add.at(s, cid, np.where(v, cols[:, k], 0))
        cen[:, k] = s / np.maximum(counts, 1)
    min_p = np.full(n_cells, _BIG, np.int32)
    np.minimum.at(min_p, cid, np.where(v, pid, _BIG))
    max_p = np.full(n_cells, -_BIG, np.int32)
    np.maximum.at(max_p, cid, np.where(v, pid, -_BIG))

    sx, wx_hi, okx = _axis_neighborhood(np, xs, gs, gw)
    sy, wy_hi, oky = _axis_neighborhood(np, ys, gs, gw)
    sz, wz_hi, okz = _axis_neighborhood(np, zs, gs, gw)
    in_range = okx & oky & okz
    sx = np.clip(sx, 0, gw - 2)
    sy = np.clip(sy, 0, gw - 2)
    sz = np.clip(sz, 0, gw - 2)

    V = np.zeros((xs.shape[0], 3), np.float64)
    W = np.zeros(xs.shape[0], np.float64)
    other = np.zeros(xs.shape[0], bool)
    y_min = np.full(xs.shape[0], np.inf)
    y_max = np.full(xs.shape[0], -np.inf)
    for dz in (0, 1):
        wz = wz_hi if dz else 2 * gs - wz_hi
        for dy in (0, 1):
            wy = wy_hi if dy else 2 * gs - wy_hi
            for dx in (0, 1):
                wx = wx_hi if dx else 2 * gs - wx_hi
                nid = (sz + dz) * (gw * gw) + (sy + dy) * gw + (sx + dx)
                has = counts[nid] > 0
                w = (wx * wy * wz).astype(np.float64) * has
                V += w[:, None] * cen[nid]
                W += w
                other |= has & ((min_p[nid] != pid) | (max_p[nid] != pid))
                y_min = np.minimum(y_min, np.where(has, cen[nid, 0], np.inf))
                y_max = np.maximum(y_max, np.where(has, cen[nid, 0], -np.inf))

    W_safe = np.maximum(W, 1.0)
    b = V / W_safe[:, None]
    spread = np.where(np.isfinite(y_max - y_min), y_max - y_min, 0.0)
    dev = np.abs(cols[:, 0].astype(np.float64) - b[:, 0])
    move = (
        v & in_range & other & (W > 0)
        & (spread <= cfg.threshold_variation)
        & (dev >= cfg.threshold_difference)
    )
    out = np.where(move[:, None], np.floor(b + 0.5), cols.astype(np.float64))
    return (out[:, 0].astype(np.int32), out[:, 1].astype(np.int32),
            out[:, 2].astype(np.int32))
