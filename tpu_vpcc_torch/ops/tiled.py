"""Tiled whole-frame reconstruction: the narrow main path.

Counterpart of ``tpu_vpcc.ops.tiled`` in its one production staging
mode: host-packed, host-oriented "cat" inputs.

Host half (numpy): the three u32 sample planes are packed per canvas
block and concatenated into one ``(F, nb, 3*res*res)`` cat, with
SWAP-family blocks transposed so every tile is in patch memory order
(:func:`stage_cat_inputs`).

Device half (PyTorch on the tensors' device):

  1. one row gather of each owned group's cat row (:func:`_gather_tiles`);
  2. the narrow words stage (:func:`_tiles_to_words`): depth to 3D from
     the per-group fields, D1 dedup and validity, the axis permutation
     folded into per-group multipliers, and a pass-through colour word;
  3. compaction to emission order (``shift_compact_ops``, kernel K1).

Integer carriers: torch on the CPU has no ``>>``/``<<`` on uint32 or
uint16, so packed words travel as int32 (u32 bit patterns) and ``zs``
as int16 (u16 bit patterns); every right shift is masked afterwards.
"""

from __future__ import annotations

import dataclasses
import functools
import subprocess
from dataclasses import replace

import numpy as np
import torch

from tpu_vpcc.atlas import groups as G
from tpu_vpcc.v3c.syntax import UnsupportedFeature

from .reconstruct import FrameConfig
from .shift_compact import shift_compact_ops


# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------


def tiled_supported(cfg: FrameConfig) -> bool:
    res = cfg.occupancy_resolution
    return (
        res >= 2
        and res % 2 == 0
        and res % cfg.occupancy_precision == 0
        # the u32 packing carries 10-bit sample fields
        and cfg.geo_shift <= 2
    )


def narrow_emit_ok(cfg: FrameConfig) -> bool:
    """The narrow path needs no unpacked coordinates mid-pipeline:
    smoothing and 45-degree views take the wide path."""
    return (
        cfg.smoothing is None
        and cfg.attr_smoothing is None
        and not cfg.additional_planes
    )


def require_narrow(cfg: FrameConfig) -> None:
    if not narrow_emit_ok(cfg):
        raise UnsupportedFeature(
            "smoothing and 45-degree views need the wide path, not yet "
            "ported (ROADMAP queue 1 #7)"
        )


def tile_plane(plane, tile: int):
    """(..., H, W) -> (..., H//tile * W//tile, tile, tile)."""
    *lead, H, W = plane.shape
    bh, bw = H // tile, W // tile
    t = plane.reshape(*lead, bh, tile, bw, tile)
    t = np.moveaxis(t, -3, -2)  # (..., bh, bw, tile, tile)
    return np.ascontiguousarray(t.reshape(*lead, bh * bw, tile, tile))


def untile_plane(tiled, bh: int, bw: int):
    """Inverse of :func:`tile_plane`: (..., bh*bw, t, t) -> (..., bh*t, bw*t)."""
    *lead, nb, t, _ = tiled.shape
    assert nb == bh * bw
    x = tiled.reshape(*lead, bh, bw, t, t)
    x = np.moveaxis(x, -2, -3)  # (..., bh, t, bw, t)
    return np.ascontiguousarray(x.reshape(*lead, bh * t, bw * t))


@functools.lru_cache(maxsize=1)
def native_pack_available() -> bool:
    """Whether the native video bridge (which carries the C pack) loads.
    Probed once per process: a failed build is not retried per call."""
    from tpu_vpcc.video import codec

    try:
        codec._load()
    except (subprocess.CalledProcessError, OSError):
        return False
    return True


def pack_planes_host(occ_t, geo0_t, geo1_t, ay_t, au_t, av_t, cfg,
                     swap=None):
    """The packed cat ``(F, nb, 3*res*res)`` u32:

      [:T2]    plane A: d0 | d1 << 10 | occ_bit << 20
      [T2:2T2] plane B: y0 | u0 << 10 | v0 << 20
      [2T2:]   plane C: y1 | u1 << 10 | v1 << 20  (== B when mc == 1)

    ``swap``: optional (F, nb) mask of blocks written transposed. The C
    twin in the native video bridge runs first; this numpy form is its
    exact host fallback when that library cannot load."""
    if native_pack_available():
        from tpu_vpcc.video.codec import native_pack_planes

        cat = native_pack_planes(
            occ_t, geo0_t, geo1_t, ay_t, au_t, av_t, cfg, swap=swap
        )
        if cat is not None:
            return cat

    mc = cfg.map_count
    T2 = cfg.occupancy_resolution * cfg.occupancy_resolution
    F, nb = occ_t.shape[0], occ_t.shape[1]

    def up(t, f):
        return t if f == 1 else t.repeat(f, axis=-2).repeat(f, axis=-1)

    occ_bit = (up(occ_t, cfg.occupancy_precision) > 0).astype(np.uint32)
    d0 = geo0_t.astype(np.uint32)
    d1 = geo1_t.astype(np.uint32) if mc > 1 else d0
    plane_a = d0 | (d1 << 10) | (occ_bit << 20)

    cup = 1 << cfg.chroma_shift

    def color(m):
        return (
            ay_t[:, m].astype(np.uint32)
            | (up(au_t[:, m], cup).astype(np.uint32) << 10)
            | (up(av_t[:, m], cup).astype(np.uint32) << 20)
        )

    plane_b = color(0)
    plane_c = color(1) if mc > 1 else plane_b
    cat = np.ascontiguousarray(
        np.concatenate(
            [p.reshape(F, nb, T2) for p in (plane_a, plane_b, plane_c)],
            axis=2,
        )
    )
    if swap is not None:
        _transpose_swap_blocks(cat, swap, cfg.occupancy_resolution)
    return cat


def _transpose_swap_blocks(cat, swap, res: int):
    """Transpose the masked blocks of a packed cat in place."""
    T2 = res * res
    for f in range(swap.shape[0]):
        blk = np.nonzero(swap[f])[0]
        if blk.size:
            t = cat[f, blk].reshape(-1, 3, res, res)
            cat[f, blk] = np.ascontiguousarray(t.swapaxes(2, 3)).reshape(
                -1, 3 * T2
            )
    return cat


def swap_mask_host(fields, nb: int):
    """(F, nb) u8 mask of SWAP-family OWNED blocks. Each canvas block is
    owned by at most one patch per frame, and bucket-padding rows
    (G_VALID=0) are excluded, so each flagged block transposes once."""
    fields = np.asarray(fields)
    m = np.zeros((fields.shape[0], nb), np.uint8)
    for f in range(fields.shape[0]):
        sel = (fields[f, :, G.G_SWAP] == 1) & (fields[f, :, G.G_VALID] > 0)
        m[f, fields[f, sel, G.G_BLOCKID]] = 1
    return m


def trim_extent_bits(cat, fields, trims, res: int):
    """Clear the packed occupancy bit (plane A bit 20) of pixels past a
    quantized patch's exact extent, in place, in a host-oriented cat
    (every tile in patch raster order). ``trims``: (F, nb_groups, 2)
    patch-space pixel limits per group (``res`` = untrimmed)."""
    T2 = res * res
    mask_bit = ~np.uint32(1 << 20)
    fields = np.asarray(fields)
    trims = np.asarray(trims)
    for f in range(trims.shape[0]):
        rows = np.nonzero(
            (fields[f, :, G.G_VALID] > 0)
            & ((trims[f, :, 0] < res) | (trims[f, :, 1] < res))
        )[0]
        for g in rows:
            lu, lv = int(trims[f, g, 0]), int(trims[f, g, 1])
            m = np.zeros((res, res), dtype=bool)  # (vp, up) patch order
            m[:, lu:] = True
            m[lv:, :] = True
            b = int(fields[f, g, G.G_BLOCKID])
            cat[f, b, :T2][m.ravel()] &= mask_bit
    return cat


def stage_cat_inputs(fields, occ_t, geo0_t, geo1_t, ay_t, au_t, av_t, cfg,
                     trims=None):
    """Host staging for the dispatch: pack the tiled planes into the cat
    with SWAP-family blocks transposed, and clear trimmed pixels.
    Returns ``((fields, cat), cfg)`` with ``cfg.host_oriented`` set."""
    swap = swap_mask_host(fields, occ_t.shape[1])
    cfg = replace(cfg, host_oriented=True)
    cat = pack_planes_host(
        occ_t, geo0_t, geo1_t, ay_t, au_t, av_t, cfg, swap=swap
    )
    if trims is not None:
        trim_extent_bits(cat, fields, trims, cfg.occupancy_resolution)
    return (fields, cat), cfg


def to_device(fields, cat, device):
    """Host staging arrays -> device tensors (cat as int32 bit patterns)."""
    fields = np.ascontiguousarray(fields, dtype=np.int32)
    cat = np.ascontiguousarray(cat, dtype=np.uint32).view(np.int32)
    return (
        torch.from_numpy(fields).to(device),
        torch.from_numpy(cat).to(device),
    )


def inputs_from_reference(cfg_ref, arrays, device="cpu"):
    """Carry the JAX package's staged dispatch across: its
    ``FrameConfig`` and cat-mode ``DeviceInputs.arrays`` = ``(fields,
    cat, None x5)`` become this port's ``FrameConfig`` and device
    tensors. Fields are read by name; the reference's TPU compaction
    policy fields have no counterpart and are dropped."""
    if getattr(cfg_ref, "cell_groups", False) or getattr(
        cfg_ref, "raw_gather", False
    ):
        raise UnsupportedFeature("cell tables and raw gathers are not ported")
    if any(a is not None for a in arrays[2:]):
        raise ValueError("expected cat-mode arrays (fields, cat, None x5)")
    cfg = FrameConfig(**{
        f.name: getattr(cfg_ref, f.name)
        for f in dataclasses.fields(FrameConfig)
    })
    fields, cat = to_device(np.asarray(arrays[0]), np.asarray(arrays[1]),
                            device)
    return cfg, fields, cat


# ---------------------------------------------------------------------------
# device half
# ---------------------------------------------------------------------------


def _gather_tiles(fields, cat, cfg):
    """One row gather of each group's cat row: (t_a, t_b, t_c), each
    (F*G, res*res) int32 in patch memory order."""
    F, Gc = fields.shape[0], fields.shape[1]
    nb = cat.shape[1]
    T2 = cfg.occupancy_resolution * cfg.occupancy_resolution
    frame = torch.arange(F, device=cat.device)[:, None] * nb
    row = (frame + fields[:, :, G.G_BLOCKID]).reshape(-1)
    rows = cat.reshape(F * nb, 3 * T2)[row]
    return rows[:, :T2], rows[:, T2 : 2 * T2], rows[:, 2 * T2 :]


def _wrap32(x):
    """int64 -> int32 holding the low 32 bits (the u32 bit pattern)."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _wrap16(x):
    """int64 -> int16 holding the low 16 bits (the u16 bit pattern)."""
    return (((x & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)


def _tiles_to_words(fields, t_a, t_b, t_c, cfg):
    """The narrow words stage on patch-order tiles. Returns ``(w0, zs,
    wc, valid)``, each (F, S) in ``[D0 half | D1 half]`` order: ``w0``
    int32 (x|y<<10|z<<20 under pack30, else x|y<<16), ``zs`` int16 or
    None (pack30), ``wc`` int32 (y|u<<10|v<<20), ``valid`` bool."""
    res = cfg.occupancy_resolution
    T2 = res * res
    F, Gc = fields.shape[0], fields.shape[1]
    FG = F * Gc
    half = Gc * T2
    ff = fields.reshape(FG, G.N_GROUP_FIELDS)

    def col(idx):
        return ff[:, idx : idx + 1]

    M10 = 0x3FF
    d0 = (t_a & M10) >> cfg.geo_shift
    d1 = ((t_a >> 10) & M10) >> cfg.geo_shift
    occ_bit = (t_a >> 20) & 1

    flat = torch.arange(T2, dtype=torch.int32, device=t_a.device)
    v1 = flat // res
    u1 = flat - v1 * res

    d1_patch = col(G.G_D1)
    mode = col(G.G_MODE)

    def normal_coord(depth):
        return torch.where(
            mode == 0, depth + d1_patch, torch.maximum(d1_patch, depth) - depth
        )

    tangent = (col(G.G_T00) + col(G.G_LODX) * u1) & 0xFFFF
    bitangent = (col(G.G_B00) + col(G.G_LODY) * v1) & 0xFFFF
    n0 = normal_coord(d0) & 0xFFFF
    if cfg.absolute_d1:
        n1 = normal_coord(d1) & 0xFFFF
    else:
        n1 = torch.where(mode == 0, n0 + d1, n0 - d1) & 0xFFFF

    occ_on = (col(G.G_VALID) > 0) & (occ_bit > 0)
    valid0 = occ_on if not cfg.drop_map0 else torch.zeros_like(occ_on)
    if cfg.map_count > 1:
        valid1 = occ_on & (n1 != n0)
    else:
        valid1 = torch.zeros_like(occ_on)

    def emit_concat(a, b):
        return torch.cat([a.reshape(F, half), b.reshape(F, half)], dim=1)

    # the axis permutation folds into the pack: each of (n, t, b) lands
    # in its slot by a per-group multiplier (disjoint bit fields)
    def is_axis(field, k):
        return (col(field) == k).to(torch.int64)

    if cfg.pack30:
        def mul(field):
            return (
                is_axis(field, 0)
                + (is_axis(field, 1) << 10)
                + (is_axis(field, 2) << 20)
            )

        mn, mt, mb = mul(G.G_NORMAL), mul(G.G_TANGENT), mul(G.G_BITANGENT)
        zn = zt = zb = None
    else:
        def mul(field):
            return (
                is_axis(field, 0) + (is_axis(field, 1) << 16),
                is_axis(field, 2),
            )

        (mn, zn), (mt, zt), (mb, zb) = (
            mul(G.G_NORMAL), mul(G.G_TANGENT), mul(G.G_BITANGENT)
        )
    tan = tangent.to(torch.int64)
    bit = bitangent.to(torch.int64)

    def w0_of(n):
        return _wrap32(n.to(torch.int64) * mn + tan * mt + bit * mb)

    w0 = emit_concat(w0_of(n0), w0_of(n1))
    zs = None
    if not cfg.pack30:
        def zs_of(n):
            return _wrap16(n.to(torch.int64) * zn + tan * zt + bit * zb)

        zs = emit_concat(zs_of(n0), zs_of(n1))
    # planes B/C already are the per-map colour words
    wc = emit_concat(t_b, t_c)
    valid = emit_concat(valid0, valid1)
    return w0, zs, wc, valid


def reconstruct_batch_pretiled_packed(fields, cat, cfg):
    """The narrow device dispatch on staged cat inputs: gather, words
    and compaction. ``fields`` (F, G, N_GROUP_FIELDS) int32 and ``cat``
    (F, nb, 3*res*res) int32 on one device. Returns ``(ops, counts)``:
    ``ops`` the compacted operands (2 under pack30, else 3), each (F, S)
    with the frame's prefix in emission order; ``counts`` (F,) int32."""
    require_narrow(cfg)
    if not cfg.host_oriented:
        raise ValueError("the port stages host-oriented cats only")
    t_a, t_b, t_c = _gather_tiles(fields, cat, cfg)
    w0, zs, wc, valid = _tiles_to_words(fields, t_a, t_b, t_c, cfg)
    return shift_compact_ops(w0, zs, wc, valid)


def _m10_triplet(w):
    """(F, n, 3) int32 from the three 10-bit fields of an int32 word."""
    return torch.stack([(w >> s) & 0x3FF for s in (0, 10, 20)], dim=-1)


def _unpack_ops_points(ops):
    """(positions, colors16), each (F, n, 3) int32, from compacted
    operands: 2 = the pack30 layout, 3 = the split zs layout."""
    if len(ops) == 2:
        return _m10_triplet(ops[0]), _m10_triplet(ops[1])
    s0, sz, sc = ops
    positions = torch.stack(
        [s0 & 0xFFFF, (s0 >> 16) & 0xFFFF, sz.to(torch.int32) & 0xFFFF],
        dim=-1,
    )
    return positions, _m10_triplet(sc)
