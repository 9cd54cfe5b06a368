"""Spatially sharded reconstruction: frames over 'data', slots over
'space'.

Counterpart of ``tpu_vpcc.parallel.spatial``. The slot axis of a frame
is cut into contiguous shards over the mesh's 'space' axis: the group
table's rows for the tiled paths (``fields[:, d*g_loc:(d+1)*g_loc]``),
the slot range ``[d*s_loc, (d+1)*s_loc)`` for the gather drivers. Block
ownership is resolved on the host, so shards compute independently;
shard order is slot order is the reference emission order, and a
frame's points are its shards' compacted prefixes one after another
(:func:`stitch_spatial`, or the pipeline's sharded fetch).

Each data row's frames go to the row's devices once per distinct device
(the host-packed cat, the device pack's planes, which K5 packs into the
cat once on each such device, or the raster planes); each shard then
runs the port's kernels on its device: K1 on the narrow path, K2W,
smoothing and K1F on the wide path, the gather slot math and K1F on the
gather drivers. All shards are launched before any count is read back,
so shards on distinct cards overlap. The reference's ``psum`` over
'space' of the counts becomes their sum on the host (``totals``), and
its smoothing collectives ``ops.smoothing.combine_stats``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.reconstruct import FrameConfig, reconstruct_slot_range
from .mesh import Mesh


def _frames_per_row(mesh: Mesh, n_frames: int) -> int:
    """Frames per data row."""
    data = mesh.shape["data"]
    if n_frames % data:
        raise ValueError(
            f"{n_frames} frames do not divide by the 'data' axis {data}")
    return n_frames // data


def _group_shard(mesh: Mesh, fields) -> int:
    """Groups per 'space' shard."""
    n_space = mesh.shape["space"]
    g_tot = fields.shape[1]
    g_loc = g_tot // n_space
    if g_loc * n_space != g_tot:
        raise ValueError("the group axis must divide by the space axis")
    return g_loc


def _read_counts(counts_rows):
    """Every shard's per-frame counts, read back after every shard was
    launched: ``counts (F, n_space)`` and ``totals (F, 1)``, int32."""
    counts = np.concatenate([
        np.stack([c.cpu().numpy() for c in row], axis=1)
        for row in counts_rows
    ]).astype(np.int32)
    return counts, counts.sum(axis=1, keepdims=True, dtype=np.int32)


def _stage_rows(mesh: Mesh, f_all, put_cat):
    """Per data row, per shard: ``(fields, cat)`` tensors on the shard's
    device, from a tiled dispatch's staging (``f_all`` a CPU tensor and
    ``put_cat``, see ``ops.tiled.host_cat_stager``). The cat of the row's
    frames is put once on each distinct device of the row (where K5
    packs it under the device pack); that device's shards share it, each
    with its own group rows."""
    f_row = _frames_per_row(mesh, f_all.shape[0])
    g_loc = _group_shard(mesh, f_all)
    rows = []
    for r in range(mesh.shape["data"]):
        frames = slice(r * f_row, (r + 1) * f_row)
        cats = {}
        row = []
        for d, dev in enumerate(mesh.devices[r]):
            if dev not in cats:
                cats[dev] = put_cat(frames, dev)
            groups = f_all[frames, d * g_loc:(d + 1) * g_loc].contiguous()
            row.append((groups.to(dev), cats[dev]))
        rows.append(row)
    return rows


def reconstruct_gof_spatial(
    mesh: Mesh,
    fields,   # (F, G, N_GROUP_FIELDS)
    occ,      # (F, H/prec, W/prec)
    geo0,     # (F, H, W)
    geo1,     # (F, H, W)
    attr_y,   # (F, M, H, W)
    attr_u,   # (F, M, H/2, W/2)
    attr_v,   # (F, M, H/2, W/2)
    cfg: FrameConfig,
):
    """2D-sharded GOF reconstruction on the gather drivers: frames over
    'data', slots over 'space'. Shard ``d`` of each frame runs
    ``reconstruct_slot_range(d*s_loc, s_loc, ...)`` (slot math, then
    K1F) on its device, over the row's raster planes, which cross once
    to each distinct device of the row. Like the reference, a check of
    the sharded drivers, not a production path: the pipeline's mesh
    dispatch runs the tiled paths and sends gather frames unsharded.

    Host arrays in (the gather dispatch's raster layout). F must divide
    by the 'data' axis size and the table's G groups by the 'space' axis
    size (the slot extent ``S = G * 2 res²`` comes from the table, so a
    bucketed table shards too; ``cfg.s_cap`` for a full one). Returns
    host arrays ``(positions (F, S, 3) u16, colors16 (F, S, 3) u16,
    counts (F, n_space), totals (F, 1))``: frame f's shard d rows are
    ``[d*s_loc, d*s_loc + counts[f, d])`` with ``s_loc = S // n_space``
    (the rest is unspecified), and ``totals`` the sum over the shards."""
    from ..ops.tiled import gather_inputs_to_device
    from ..runtime.pipeline import _u16_host

    arrays = [np.asarray(a) for a in
              (fields, occ, geo0, geo1, attr_y, attr_u, attr_v)]
    n_space = mesh.shape["space"]
    F = arrays[0].shape[0]
    f_row = _frames_per_row(mesh, F)
    g_loc = _group_shard(mesh, arrays[0])
    s_loc = g_loc * cfg.slots_per_block
    launched = []  # per row, per shard, per frame: (pos, col, count)
    for r in range(mesh.shape["data"]):
        frames = slice(r * f_row, (r + 1) * f_row)
        planes = {}
        row = []
        for d, dev in enumerate(mesh.devices[r]):
            if dev not in planes:
                planes[dev] = gather_inputs_to_device(
                    *(a[frames] for a in arrays), dev)
            row.append([
                reconstruct_slot_range(
                    d * s_loc, s_loc, *(t[k] for t in planes[dev]), cfg)
                for k in range(f_row)
            ])
        launched.append(row)
    positions = np.zeros((F, n_space * s_loc, 3), np.uint16)
    colors16 = np.zeros_like(positions)
    counts_rows = []
    for r, row in enumerate(launched):
        for d, shard in enumerate(row):
            for k, (pos, col, _) in enumerate(shard):
                rows = slice(d * s_loc, (d + 1) * s_loc)
                positions[r * f_row + k, rows] = _u16_host(pos)
                colors16[r * f_row + k, rows] = _u16_host(col)
        counts_rows.append([torch.stack([c for _, _, c in shard])
                            for shard in row])
    counts, totals = _read_counts(counts_rows)
    return positions, colors16, counts, totals


def reconstruct_gof_spatial_pretiled(mesh: Mesh, fields, put_cat,
                                     cfg: FrameConfig):
    """2D-sharded reconstruction on the wide path (smoothing, 45-degree
    views): frames over 'data', the group axis of the field table over
    'space' in contiguous chunks (shard order == emission order).

    Each shard runs K2W on its groups against the row's whole cat; with
    smoothing, every shard's cell statistics are combined across the
    row's shards (``ops.smoothing.combine_stats``, the reference's
    ``psum``/``pmin``/``pmax`` over 'space') before any shard applies
    them, so each shard smooths against whole-frame statistics; then K1F
    on every shard. Takes a tiled dispatch's staging, ``fields`` a CPU
    tensor and ``put_cat(frames, device)`` (``ops.tiled.host_cat_stager``
    or ``device_pack_stager``); F must divide by 'data' and the group
    axis by 'space'. Returns
    ``(ops, counts (F, n_space), totals (F, 1))``: ``ops[r][d]`` shard
    d's compacted wide words of data row r's frames, each (F/data,
    s_loc) on the shard's device (``s_loc = G * 2 res² / n_space``),
    frame f's shard d prefix ``counts[f, d]`` long. The reference
    returns unpacked positions and colours here; the port's wide
    dispatch returns the words, unpacked by the fetch
    (``runtime.pipeline._fetch_sharded_packed``, layout "wide")."""
    from ..ops.smoothing import combine_stats
    from ..ops.tiled import reconstruct_batch_pretiled_shards

    ops, counts_rows = [], []
    for r, shards in enumerate(_stage_rows(mesh, fields, put_cat)):
        devs = list(mesh.devices[r])
        out = reconstruct_batch_pretiled_shards(
            shards, cfg, combine=lambda stats: combine_stats(stats, devs)
        )
        ops.append([o for o, _ in out])
        counts_rows.append([c for _, c in out])
    return (ops, *_read_counts(counts_rows))


def reconstruct_gof_spatial_pretiled_packed(mesh: Mesh, fields, put_cat,
                                            cfg: FrameConfig):
    """The narrow twin of :func:`reconstruct_gof_spatial_pretiled` (the
    caller gates on ``ops.tiled.narrow_emit_ok``, the same predicate as
    the unsharded dispatch): each shard runs the gather, the narrow words
    and K1 on its groups, at its own slot extent, so each valid slot
    moves to its rank among the shard's slots. Returns ``(ops, counts (F,
    n_space), totals (F, 1))`` as :func:`reconstruct_gof_spatial_pretiled`
    does, each ``ops[r][d]`` the shard's K1 operands (2 under pack30,
    else 3)."""
    from ..ops.tiled import narrow_emit_ok, reconstruct_batch_pretiled_packed

    if not narrow_emit_ok(cfg):
        raise ValueError("packed sharded dispatch requires the narrow path")
    launched = [
        [reconstruct_batch_pretiled_packed(f, c, cfg) for f, c in shards]
        for shards in _stage_rows(mesh, fields, put_cat)
    ]
    return ([[o for o, _ in row] for row in launched],
            *_read_counts([[c for _, c in row] for row in launched]))


def stitch_spatial(
    positions: np.ndarray, colors16: np.ndarray, counts: np.ndarray, s_loc: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host assembly of one frame's sharded output into the global order."""
    parts_p, parts_c = [], []
    for d in range(counts.shape[0]):
        n = int(counts[d])
        parts_p.append(positions[d * s_loc : d * s_loc + n])
        parts_c.append(colors16[d * s_loc : d * s_loc + n])
    return np.concatenate(parts_p), np.concatenate(parts_c)
