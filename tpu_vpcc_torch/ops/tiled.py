"""Tiled whole-frame reconstruction: the narrow and the wide path.

Counterpart of ``tpu_vpcc.ops.tiled`` in its two stagings of the cat,
the ``(F, nb, 3*res*res)`` concat of the three u32 sample planes packed
per canvas block. Frames these paths cannot take (:func:`tiled_supported`,
rotated orientations, samples wider than 10 bits) go to the gather
fallback, ``reconstruct.reconstruct_batch``, whose raster inputs cross to
the device by :func:`gather_inputs_to_device` and whose words unpack here
with the "gather" layout.

The two stagings (``runtime.pipeline._gof_device_inputs`` picks one):

  - the device pack, as the reference's default off the TPU: the host
    stacks the block-tiled planes and builds the swap mask
    (:func:`stage_plane_inputs`); they cross to the device and kernel K5
    (``pack.pack_cat``) packs the cat there (:func:`device_pack_stager`);
  - the host pack, only for quantized patch extents, whose trims exist
    only as a bit mask in a host cat: numpy (or the native bridge's C
    pack) packs the cat on the host (:func:`stage_cat_inputs`), and it
    crosses whole (:func:`host_cat_stager`). The port has no knob that
    selects it for other frames.

Both fold the orientation fix into the pack: SWAP-family blocks are
written transposed, so every tile is in patch memory order and
``cfg.host_oriented`` is set either way. The port never reads
``TPU_VPCC_HOSTORIENT``: the reference's other mode, a cat in canvas
order fixed after the gather, has no counterpart.

Device half (PyTorch on the tensors' device), the narrow path
(:func:`reconstruct_batch_pretiled_packed`, when :func:`narrow_emit_ok`):

  1. one row gather of each owned group's cat row (:func:`_gather_tiles`);
  2. the narrow words stage (:func:`_tiles_to_words`): depth to 3D from
     the per-group fields, D1 dedup and validity, the axis permutation
     folded into per-group multipliers, and a pass-through colour word;
  3. compaction to emission order (``shift_compact_ops``, kernel K1).

The wide path (:func:`reconstruct_batch_pretiled`: geometry or colour
smoothing, 45-degree views):

  1. gather and wide words in one kernel (``payload.wide_words``, K2W):
     assembled x, y, z (inverse 45-degree rotation applied), the two
     maps interleaved per pixel, packed into three u32 words;
  2. optional geometry smoothing, then colour smoothing on the smoothed
     positions (``smoothing``), on the words unpacked and repacked;
  3. full-order compaction (``shift_compact_full``, K1F).

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

from ..atlas import groups as G
from ..v3c.syntax import UnsupportedFeature
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
    smoothing and 45-degree views take the wide path. (The reference's
    predicate also bounds the sort key's index bits; K1 has no key.)"""
    return (
        cfg.smoothing is None
        and cfg.attr_smoothing is None
        and not cfg.additional_planes
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
    from ..video import codec

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
        from ..video.codec import native_pack_planes

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


def stage_plane_inputs(fields, occ_t, geo0_t, geo1_t, ay_t, au_t, av_t, cfg):
    """Host staging for the device pack: the block-tiled planes as they
    are and the (F, nb) swap mask of SWAP-family owned blocks, no pack.
    Returns ``((fields, occ, geo0, geo1, ay, au, av, swap), cfg)`` with
    ``cfg.host_oriented`` set: K5 writes the flagged blocks transposed."""
    swap = swap_mask_host(fields, occ_t.shape[1])
    cfg = replace(cfg, host_oriented=True)
    return (fields, occ_t, geo0_t, geo1_t, ay_t, au_t, av_t, swap), cfg


def _check_blockid(fields, nb: int, what: str) -> None:
    """Every group's ``G_BLOCKID`` must name one of ``nb`` blocks: the
    CUDA kernels read rows by it unchecked."""
    blk = fields[..., G.G_BLOCKID]
    if blk.size and (blk.min() < 0 or blk.max() >= nb):
        raise ValueError(
            f"G_BLOCKID outside the {what}'s {nb} blocks "
            f"({blk.min()}..{blk.max()})"
        )


def host_tensors(fields, cat):
    """Host staging arrays -> CPU tensors sharing their memory where the
    arrays are contiguous (cat as int32 bit patterns). Every group's
    ``G_BLOCKID`` must name a cat row."""
    fields = np.ascontiguousarray(fields, dtype=np.int32)
    cat = np.ascontiguousarray(cat, dtype=np.uint32).view(np.int32)
    _check_blockid(fields, cat.shape[1], "cat")
    return torch.from_numpy(fields), torch.from_numpy(cat)


def plane_tensors(fields, occ, geo0, geo1, ay, au, av, swap):
    """The device pack's staging arrays -> CPU tensors sharing their
    memory where the arrays are contiguous: the gather's dtypes
    (:func:`gather_inputs_to_device`) and ``swap`` uint8. Every group's
    ``G_BLOCKID`` must name one of the planes' blocks."""
    _check_blockid(np.asarray(fields), occ.shape[1], "planes")
    return (
        *gather_inputs_to_device(fields, occ, geo0, geo1, ay, au, av, "cpu"),
        torch.from_numpy(np.ascontiguousarray(swap, dtype=np.uint8)),
    )


def planes_to_device(fields, occ, geo0, geo1, ay, au, av, swap, device):
    """The device pack's H2D: its staging arrays -> tensors on
    ``device`` (:func:`plane_tensors`)."""
    return tuple(t.to(device) for t in plane_tensors(
        fields, occ, geo0, geo1, ay, au, av, swap))


def host_cat_stager(fields, cat):
    """The host pack's staging arrays -> ``(fields, put_cat)``: ``fields``
    a CPU tensor, ``put_cat(frames, device)`` the cat of ``frames`` (an
    index of the frame axis) crossing to ``device``."""
    fields, cat = host_tensors(fields, cat)
    return fields, lambda frames, device: cat[frames].to(device)


def device_pack_stager(fields, occ, geo0, geo1, ay, au, av, swap, cfg):
    """The device pack's staging arrays -> ``(fields, put_cat)`` as
    :func:`host_cat_stager` gives them: ``put_cat(frames, device)``
    sends the planes and swap mask of ``frames`` to ``device``, where K5
    packs their cat (``pack.pack_cat``)."""
    from .pack import pack_cat

    fields, *planes = plane_tensors(fields, occ, geo0, geo1, ay, au, av,
                                    swap)
    return fields, lambda frames, device: pack_cat(
        *(t[frames].to(device) for t in planes), cfg)


def device_pack_inputs(fields, occ, geo0, geo1, ay, au, av, swap, device,
                       cfg):
    """The device pack's staging arrays -> ``(fields, cat)`` on
    ``device``: the planes cross, then K5 packs the cat there
    (:func:`device_pack_stager`)."""
    fields, put_cat = device_pack_stager(fields, occ, geo0, geo1, ay, au,
                                         av, swap, cfg)
    return fields.to(device), put_cat(slice(None), device)


def swap_mask_device(fields, nb: int):
    """:func:`swap_mask_host` on the device: (F, nb) uint8 from the
    fields tensor, one scatter (a padding row, G_VALID 0, adds no 1)."""
    F = fields.shape[0]
    sel = ((fields[:, :, G.G_SWAP] == 1)
           & (fields[:, :, G.G_VALID] > 0)).to(torch.int32)
    frame = torch.arange(F, device=fields.device)[:, None] * nb
    idx = (frame + fields[:, :, G.G_BLOCKID]).reshape(-1)
    mask = torch.zeros(F * nb, dtype=torch.int32, device=fields.device)
    mask.scatter_reduce_(0, idx, sel.reshape(-1), "amax")
    return mask.to(torch.uint8).reshape(F, nb)


def to_device(fields, cat, device):
    """Host staging arrays -> device tensors (:func:`host_tensors`)."""
    fields, cat = host_tensors(fields, cat)
    return fields.to(device), cat.to(device)


def gather_inputs_to_device(fields, occ, geo0, geo1, ay, au, av, device):
    """The gather dispatch's staged raster arrays -> device tensors:
    ``fields`` int32, ``occ`` uint8, and the five u16 sample planes as
    int16 bit patterns (torch's uint16 lacks the CPU ops the slot math
    needs; ``reconstruct.gather_words`` widens each gathered sample with
    ``& 0xFFFF``)."""

    def put(a, dtype, view=None):
        a = np.ascontiguousarray(a, dtype=dtype)
        return torch.from_numpy(a if view is None else a.view(view)).to(device)

    return (
        put(fields, np.int32),
        put(occ, np.uint8),
        *(put(a, np.uint16, np.int16) for a in (geo0, geo1, ay, au, av)),
    )


def inputs_from_reference(cfg_ref, arrays, device="cpu"):
    """Carry the JAX package's staged dispatch across: its
    ``FrameConfig`` and ``DeviceInputs.arrays`` become this port's
    ``FrameConfig`` and device tensors. Cat-mode arrays ``(fields, cat,
    None x5)`` give ``(cfg, fields, cat)``. Seven arrays ``(fields, occ,
    geo0, geo1, ay, au, av)`` are read by their layout: block-tiled ones
    (``geo0`` of shape (F, nb, t, t), the reference's default off the
    TPU) are packed on ``device`` as the port's device pack packs them
    (swap mask, :func:`device_pack_inputs`) and give ``(cfg, fields,
    cat)`` with ``cfg.host_oriented`` set; the gather dispatch's raster
    ones (``geo0`` (F, H, W)) give ``(cfg, *seven tensors)``
    (:func:`gather_inputs_to_device`). Fields are read by name; the
    reference's TPU compaction policy fields have no counterpart and are
    dropped."""
    if getattr(cfg_ref, "cell_groups", False) or getattr(
        cfg_ref, "raw_gather", False
    ):
        raise UnsupportedFeature("cell tables and raw gathers are not ported")
    cfg = FrameConfig(**{
        f.name: getattr(cfg_ref, f.name)
        for f in dataclasses.fields(FrameConfig)
    })
    if len(arrays) == 7 and all(a is not None for a in arrays):
        arrays = [np.asarray(a) for a in arrays]
        if arrays[2].ndim == 4:  # block-tiled planes
            staged, cfg = stage_plane_inputs(*arrays, cfg)
            return (cfg, *device_pack_inputs(*staged, device, cfg))
        return (cfg, *gather_inputs_to_device(*arrays, device))
    if any(a is not None for a in arrays[2:]):
        raise ValueError("expected cat-mode arrays (fields, cat, None x5) "
                         "or seven raw arrays")
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


def _slot_geometry(fields, t_a, cfg):
    """Per-slot geometry shared by the narrow and wide words stages, on
    plane-A tiles (F*G, res*res) in patch memory order. Returns ``(col,
    tangent, bitangent, n0, n1, valid0, valid1)``: ``col(idx)`` the
    (F*G, 1) column of a group field, then (F*G, res*res) int32
    coordinates (16-bit masked) and bool validity per map."""
    res = cfg.occupancy_resolution
    T2 = res * res
    ff = fields.reshape(-1, G.N_GROUP_FIELDS)

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
    return col, tangent, bitangent, n0, n1, valid0, valid1


def _tiles_to_words(fields, t_a, t_b, t_c, cfg):
    """The narrow words stage on patch-order tiles. Returns ``(w0, zs,
    wc, valid)``, each (F, S) in ``[D0 half | D1 half]`` order: ``w0``
    int32 (x|y<<10|z<<20 under pack30, else x|y<<16), ``zs`` int16 or
    None (pack30), ``wc`` int32 (y|u<<10|v<<20), ``valid`` bool."""
    res = cfg.occupancy_resolution
    F, Gc = fields.shape[0], fields.shape[1]
    half = Gc * res * res
    col, tangent, bitangent, n0, n1, valid0, valid1 = _slot_geometry(
        fields, t_a, cfg
    )

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
    if not narrow_emit_ok(cfg):
        # the pipeline routes on narrow_emit_ok: reaching here is a bug
        raise ValueError("narrow dispatch asked for a wide-path config")
    if not cfg.host_oriented:
        raise ValueError("the port stages host-oriented cats only")
    t_a, t_b, t_c = _gather_tiles(fields, cat, cfg)
    w0, zs, wc, valid = _tiles_to_words(fields, t_a, t_b, t_c, cfg)
    return shift_compact_ops(w0, zs, wc, valid)


def reconstruct_planes_packed(fields, occ, geo0, geo1, ay, au, av, cfg):
    """The narrow dispatch on raw block-tiled planes already on the
    device, as ``tpu_vpcc``'s ``_flat_pretiled_impl(..., _packed_out=True)``
    takes them: the swap mask from the fields (:func:`swap_mask_device`),
    K5 (``pack.pack_cat``), then :func:`reconstruct_batch_pretiled_packed`.
    Tensors as :func:`planes_to_device` gives them, without the mask."""
    from .pack import pack_cat

    cfg = replace(cfg, host_oriented=True)
    swap = swap_mask_device(fields, occ.shape[1])
    cat = pack_cat(occ, geo0, geo1, ay, au, av, swap, cfg)
    return reconstruct_batch_pretiled_packed(fields, cat, cfg)


def _lo16(w):
    return w & 0xFFFF


def _hi16(w):
    return (w >> 16) & 0xFFFF


def _pack16(a, b):
    """int32 ``a | b << 16`` (u32 bit pattern) of two 16-bit values."""
    return _wrap32(a.to(torch.int64) | (b.to(torch.int64) << 16))


def smooth_words_shards(shards, cfg, combine=None):
    """Geometry smoothing, then colour smoothing on the smoothed
    positions (as ``tpu_vpcc.ops.tiled._grids_to_words`` orders them),
    on the wide words of one or more slot shards of the same frames.
    ``shards``: a list of ``(fields, w0, w1, w2, valid)``, each shard's
    (F, S_shard) words on its own device with its own (F, G_shard)
    group rows. x, y, z, cy, cu, cv are unpacked, smoothed and
    repacked: lossless for every valid slot (16-bit components, 10-bit
    colours). The cluster id of a slot is its group's ``G_PATCH``.
    Each pass takes every shard's cell statistics, then ``combine``
    (``smoothing.combine_stats`` over the shards' devices, so every
    shard smooths against whole-frame statistics; the identity for one
    shard), then applies them shard by shard. Returns one ``(w0, w1,
    w2)`` per shard."""
    from .smoothing import (
        color_apply,
        color_stats,
        geometry_apply,
        geometry_stats,
    )

    if combine is None:
        if len(shards) != 1:
            raise ValueError("several shards need a combine of their stats")
        combine = lambda stats: stats  # noqa: E731
    cols, args, shapes = [], [], []  # per shard
    for fields, w0, w1, w2, valid in shards:
        F, S = valid.shape
        pid = fields[:, :, G.G_PATCH].repeat_interleave(
            S // fields.shape[1], dim=1)
        frame = torch.arange(F, dtype=torch.int64, device=valid.device)
        cols.append([t.reshape(-1) for t in (
            _lo16(w0), _hi16(w0), _lo16(w1), _hi16(w1), _lo16(w2), _hi16(w2)
        )])  # x, y, z, cy, cu, cv
        args.append((valid.reshape(-1), pid.reshape(-1),
                     frame[:, None].expand(F, S).reshape(-1)))
        shapes.append((F, S))
    if cfg.smoothing is not None:
        stats = combine([
            geometry_stats(*c[:3], *a, F, cfg.smoothing)
            for c, a, (F, _) in zip(cols, args, shapes)
        ])
        for c, a, st in zip(cols, args, stats):
            c[:3] = geometry_apply(st, *c[:3], *a, cfg.smoothing)
    if cfg.attr_smoothing is not None:
        stats = combine([
            color_stats(*c, *a, F, cfg.attr_smoothing)
            for c, a, (F, _) in zip(cols, args, shapes)
        ])
        for c, a, st in zip(cols, args, stats):
            c[3:] = color_apply(st, *c, *a, cfg.attr_smoothing)
    out = []
    for c, shape in zip(cols, shapes):
        x, y, z, cy, cu, cv = (t.reshape(shape) for t in c)
        out.append((_pack16(x, y), _pack16(z, cy), _pack16(cu, cv)))
    return out


def smooth_words(fields, w0, w1, w2, valid, cfg):
    """:func:`smooth_words_shards` on one shard: the unsharded wide
    path's smoothing of ``(w0, w1, w2)``."""
    return smooth_words_shards([(fields, w0, w1, w2, valid)], cfg)[0]


def reconstruct_batch_pretiled_shards(shards, cfg, combine=None):
    """The wide device dispatch on one or more group shards of the same
    frames: K2W (gather and wide words) on every shard, the smoothing
    passes (cell statistics of every shard, ``combine``, apply; see
    :func:`smooth_words_shards`), then K1F on every shard. ``shards``: a
    list of ``(fields, cat)`` on their devices, each shard's fields a
    contiguous range of the group axis and its cat the whole frames'.
    Returns one ``(ops, counts)`` per shard, as
    :func:`reconstruct_batch_pretiled` returns for the whole."""
    from .payload import wide_words
    from .shift_compact import shift_compact_full

    words = [wide_words(fields, cat, cfg) for fields, cat in shards]
    if cfg.smoothing is not None or cfg.attr_smoothing is not None:
        smoothed = smooth_words_shards(
            [(fields, *w) for (fields, _), w in zip(shards, words)],
            cfg, combine,
        )
        words = [(*sw, w[3]) for sw, w in zip(smoothed, words)]
    return [shift_compact_full(w[:3], w[3]) for w in words]


def reconstruct_batch_pretiled(fields, cat, cfg):
    """The wide device dispatch on staged cat inputs: K2W (gather and
    wide words), optional smoothing, K1F. Same inputs as
    :func:`reconstruct_batch_pretiled_packed`. Returns ``(ops, counts)``:
    ``ops`` the compacted ``(w0, w1, w2)``, each (F, S) with the
    frame's prefix in emission order (unpack with
    ``_unpack_ops_points(ops, "wide")``); ``counts`` (F,) int32."""
    return reconstruct_batch_pretiled_shards([(fields, cat)], cfg)[0]


def _m10_triplet(w):
    """(F, n, 3) int32 from the three 10-bit fields of an int32 word."""
    return torch.stack([(w >> s) & 0x3FF for s in (0, 10, 20)], dim=-1)


def _unpack_ops_points(ops, layout: str = "narrow"):
    """(positions, colors16), each (F, n, 3) int32, from compacted
    operands. ``layout`` "narrow": 2 operands = the pack30 layout, 3 =
    the split zs layout; "wide": ``(w0, w1, w2)`` = (x|y<<16, z|cy<<16,
    cu|cv<<16), the counterpart of the reference's ``_unpack_sorted``;
    "gather": the same words from ``reconstruct.reconstruct_batch``,
    whose colours keep all 16 bits. The wide and gather layouts have
    three operands too, so a layout is never inferred."""
    if layout in ("wide", "gather"):
        s0, s1, s2 = ops
        positions = torch.stack([_lo16(s0), _hi16(s0), _lo16(s1)], dim=-1)
        colors16 = torch.stack([_hi16(s1), _lo16(s2), _hi16(s2)], dim=-1)
        if layout == "gather":
            return positions, colors16
        # wide colours are 10-bit samples (the cat packs 10 bits): the
        # mask changes no point, and keeps the unspecified tail past a
        # frame's count inside the colour tables
        return positions, colors16 & 0x3FF
    if layout != "narrow":
        raise ValueError(f"unknown operand layout {layout!r}")
    if len(ops) == 2:
        return _m10_triplet(ops[0]), _m10_triplet(ops[1])
    s0, sz, sc = ops
    positions = torch.stack(
        [_lo16(s0), _hi16(s0), sz.to(torch.int32) & 0xFFFF], dim=-1,
    )
    return positions, _m10_triplet(sc)
