"""Plain PyTorch reference of the rec0 point-cloud reconstruction.

Written from the reference decoder's semantics (tmc2-rs
``src/codec.rs``: ``generate_block_to_patch``, ``generate_point_cloud``,
``color_point_cloud``, the YUV->RGB conversion) and the grid smoothing
filters, whole-frame and vectorised, in plain ``torch`` operations. It
takes the benchmark's plain arrays (:class:`vpcc_bench.gen.FramePlain`
fields) and nothing the program derived, and imports nothing of the
program.

Scope: axis-aligned views, DEFAULT and SWAP orientations, absolute D1,
one or two maps, 4:2:0 or 4:4:4 YUV attributes, no raw, EOM or PLR
patches: what the benchmark's configurations state.

Per frame, in emission order: patches ascending; a patch's blocks in its
own raster (v0, then u0); only blocks whose owner is the patch (the last
patch with an occupied pixel there); a block's pixels in patch raster
(v1, then u1); an occupied pixel gives its D0 point, then its D1 point
unless equal. Colours sample map m's attribute planes at the pixel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..gen import (P_BITANGENT, P_D1, P_MODE, P_NORMAL, P_ORIENT, P_SU0,
                   P_SV0, P_TANGENT, P_U0, P_U1, P_V0, P_V1, SWAP)

#: BT.709 10-bit YUV -> 8-bit RGB (``src/codec.rs:661-687``)
R_V, G_U, G_V, B_U = 1.57480, 0.18733, 0.46813, 1.85563

BIG = 1 << 30


def frame_points(patches, occ, geo, attr, occupancy_resolution: int,
                 occupancy_precision: int, geo_shift: int, device):
    """One frame's points before smoothing. Returns ``(pos, col16,
    pid)``: (N, 3) int64 positions, (N, 3) int64 YUV samples and (N,)
    int64 patch index, in emission order, on ``device``."""
    res, prec = occupancy_resolution, occupancy_precision
    H, W = geo[0].shape
    maps = len(geo)
    pt = torch.as_tensor(patches, dtype=torch.int64, device=device)
    occ_t = torch.as_tensor(occ, device=device).to(torch.int64)
    geo_t = [torch.as_tensor(g, device=device).to(torch.int64) for g in geo]

    # every pixel of every patch's block footprint, in emission order
    su0, sv0 = pt[:, P_SU0], pt[:, P_SV0]
    n_pix = su0 * sv0 * res * res
    pidx = torch.repeat_interleave(torch.arange(len(pt), device=device),
                                   n_pix)
    start = torch.cumsum(n_pix, 0) - n_pix
    k = torch.arange(int(n_pix.sum()), device=device) - start[pidx]
    row = su0[pidx] * res * res
    v0, rem = k // row, k % row
    u0, r2 = rem // (res * res), rem % (res * res)
    v1, u1 = r2 // res, r2 % res
    u = u0 * res + u1
    v = v0 * res + v1
    swap = pt[pidx, P_ORIENT] == SWAP
    ox, oy = pt[pidx, P_U0] * res, pt[pidx, P_V0] * res
    x = torch.where(swap, v, u) + ox
    y = torch.where(swap, u, v) + oy

    occupied = occ_t[y // prec, x // prec] != 0
    # block owner: the last patch with an occupied pixel in the block
    block = (y // res) * (W // res) + (x // res)
    owner = torch.zeros((H // res) * (W // res), dtype=torch.int64,
                        device=device)
    owner.scatter_reduce_(0, block[occupied], pidx[occupied] + 1, "amax")
    keep = occupied & (owner[block] == pidx + 1)
    pidx, u, v, x, y = pidx[keep], u[keep], v[keep], x[keep], y[keep]

    p = pt[pidx]

    def point(depth):
        d1 = p[:, P_D1]
        n = torch.where(p[:, P_MODE] == 0, depth + d1,
                        torch.maximum(d1, depth) - depth) & 0xFFFF
        t = (u + p[:, P_U1]) & 0xFFFF
        b = (v + p[:, P_V1]) & 0xFFFF
        out = torch.empty((len(pidx), 3), dtype=torch.int64, device=device)
        rows = torch.arange(len(pidx), device=device)
        out[rows, p[:, P_NORMAL]] = n
        out[rows, p[:, P_TANGENT]] = t
        out[rows, p[:, P_BITANGENT]] = b
        return out

    pts = [point(geo_t[m][y, x] >> geo_shift) for m in range(maps)]

    def colour(m):
        ay, au, av = (torch.as_tensor(a, device=device).to(torch.int64)
                      for a in attr[m])
        cs = 0 if au.shape == ay.shape else 1
        return torch.stack([ay[y, x], au[y >> cs, x >> cs],
                            av[y >> cs, x >> cs]], dim=1)

    cols = [colour(m) for m in range(maps)]
    if maps == 1:
        return pts[0], cols[0], pidx
    # D0 then D1 per pixel; D1 dropped where it equals D0
    emit = torch.stack([torch.ones_like(pidx, dtype=torch.bool),
                        (pts[1] != pts[0]).any(dim=1)], dim=1).reshape(-1)
    pos = torch.stack(pts, dim=1).reshape(-1, 3)[emit]
    col = torch.stack(cols, dim=1).reshape(-1, 3)[emit]
    pid = pidx.repeat_interleave(2)[emit]
    return pos, col, pid


def _neighbourhood(coord, gs: int, gw: int):
    c = coord // gs
    local = coord - c * gs
    s = c - (local < gs // 2).to(coord.dtype)
    w_hi = (coord - (s * gs + gs // 2)) * 2 + 1
    ok = (s >= 0) & (s + 1 < gw)
    return s.clamp(0, gw - 2), w_hi, ok


def _cells(pos, pid, vals, gs: int, gw: int):
    """Per grid cell: point count, sums of ``vals`` columns, smallest and
    largest patch index."""
    n_cells = gw ** 3
    cid = ((pos[:, 2] // gs) * gw * gw + (pos[:, 1] // gs) * gw
           + pos[:, 0] // gs).clamp(0, n_cells - 1)
    dev = pos.device
    count = torch.zeros(n_cells, dtype=torch.int64, device=dev)
    count.index_add_(0, cid, torch.ones_like(cid))
    sums = torch.zeros((n_cells, vals.shape[1]), dtype=torch.int64,
                       device=dev)
    sums.index_add_(0, cid, vals)
    lo = torch.full((n_cells,), BIG, dtype=torch.int64, device=dev)
    lo.scatter_reduce_(0, cid, pid, "amin")
    hi = torch.full((n_cells,), -BIG, dtype=torch.int64, device=dev)
    hi.scatter_reduce_(0, cid, pid, "amax")
    safe = count.clamp(min=1)
    centroid = (sums + (safe // 2)[:, None]) // safe[:, None]
    return count, centroid, lo, hi


def _blend(pos, pid, count, centroid, lo, hi, gs: int, gw: int):
    """Trilinear blend of the eight neighbour cells' centroids with
    integer weights, the 'another patch is near' gate, and the luma
    range of the occupied neighbours (column 0 of the centroids)."""
    (sx, wx, okx), (sy, wy, oky), (sz, wz, okz) = (
        _neighbourhood(pos[:, a], gs, gw) for a in range(3))
    n = len(pos)
    dev = pos.device
    acc = torch.zeros((n, centroid.shape[1]), dtype=torch.int64, device=dev)
    wsum = torch.zeros(n, dtype=torch.int64, device=dev)
    other = torch.zeros(n, dtype=torch.bool, device=dev)
    c0_lo = torch.full((n,), BIG, dtype=torch.int64, device=dev)
    c0_hi = torch.full((n,), -BIG, dtype=torch.int64, device=dev)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                nid = (sz + dz) * gw * gw + (sy + dy) * gw + (sx + dx)
                has = count[nid] > 0
                w = ((wx if dx else 2 * gs - wx) * (wy if dy else 2 * gs - wy)
                     * (wz if dz else 2 * gs - wz)) * has
                acc += w[:, None] * centroid[nid]
                wsum += w
                other |= has & ((lo[nid] != pid) | (hi[nid] != pid))
                c0 = centroid[nid, 0]
                c0_lo = torch.minimum(c0_lo, torch.where(has, c0, BIG))
                c0_hi = torch.maximum(c0_hi, torch.where(has, c0, -BIG))
    safe = wsum.clamp(min=1)
    blended = (acc + (safe // 2)[:, None]) // safe[:, None]
    ok = okx & oky & okz & other & (wsum > 0)
    return blended, ok, c0_hi - c0_lo


def smooth_geometry(pos, pid, grid_size: int, threshold: int,
                    bitdepth: int = 10):
    """Grid geometry smoothing: a point moves to the blend of its
    neighbour cells' centroids where another patch is near and the
    squared distance is at least ``threshold``."""
    gs = grid_size
    gw = -(-(1 << bitdepth) // gs)
    count, cen, lo, hi = _cells(pos, pid, pos, gs, gw)
    c, ok, _ = _blend(pos, pid, count, cen, lo, hi, gs, gw)
    move = ok & (((pos - c) ** 2).sum(dim=1) >= threshold)
    return torch.where(move[:, None], c, pos)


def smooth_colour(pos, col16, pid, grid_size: int, threshold_variation: int,
                  threshold_difference: int, bitdepth: int = 10):
    """Grid colour smoothing on the (smoothed) positions' cells: a
    colour takes the blend of its neighbour cells' mean colours where
    another patch is near, the neighbours' mean lumas span at most
    ``threshold_variation`` and its luma is at least
    ``threshold_difference`` from the blend's."""
    gs = grid_size
    gw = -(-(1 << bitdepth) // gs)
    count, cen, lo, hi = _cells(pos, pid, col16, gs, gw)
    b, ok, spread = _blend(pos, pid, count, cen, lo, hi, gs, gw)
    move = (ok & (spread <= threshold_variation)
            & ((col16[:, 0] - b[:, 0]).abs() >= threshold_difference))
    return torch.where(move[:, None], b, col16)


def yuv10_to_rgb8(col16, dtype=torch.float64):
    """BT.709 10-bit YUV to 8-bit RGB: each term in ``dtype`` with the
    reference's expression shapes, ``floor(c / 1023 * 255)`` clamped to
    0..255. Division by a full tensor, so that no kernel turns it into a
    multiplication by the reciprocal."""
    y, u, v = (col16[:, i].to(dtype) for i in range(3))
    off = 512.0
    r = y + R_V * (v - off)
    g = y - G_U * (u - off) - (G_V * (v - off))
    b = y + B_U * (u - off)
    scale = torch.full_like(y, 1023.0)
    out = [torch.floor(c / scale * 255.0).clamp(0.0, 255.0) for c in (r, g, b)]
    return torch.stack(out, dim=1).to(torch.uint8)


def reconstruct_frame(patches, occ, geo, attr, config: dict, device,
                      colour_dtype=torch.float64):
    """One frame as the decoder must emit it: ``(positions, colours)``,
    (N, 3) uint16 and (N, 3) uint8 host arrays, in emission order.
    ``config`` names the deployment's sizes and smoothing; the colour
    conversion runs in ``colour_dtype`` (float64 is the stated one)."""
    pos, col, pid = frame_points(
        patches, occ, geo, attr, config["occupancy_resolution"],
        config["occupancy_precision"], config["geo_shift"], device)
    bits = config["geometry_bitdepth_3d"]
    gsm: Optional[dict] = config.get("geo_smoothing")
    asm: Optional[dict] = config.get("attr_smoothing")
    if gsm and len(pos):
        pos = smooth_geometry(pos, pid, gsm["grid_size"], gsm["threshold"],
                              bits)
    if asm and len(pos):
        col = smooth_colour(pos, col, pid, asm["grid_size"],
                            asm["threshold_variation"],
                            asm["threshold_difference"], bits)
    rgb = yuv10_to_rgb8(col, colour_dtype)
    return (pos.to(torch.int32).cpu().numpy().astype("uint16"),
            rgb.cpu().numpy())
