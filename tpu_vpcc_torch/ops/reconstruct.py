"""Static reconstruction geometry of one dispatch, and the gather
fallback.

Counterpart of ``tpu_vpcc.ops.reconstruct``: ``FrameConfig``/
``make_config`` with the fields the three dispatch paths read (the TPU
compaction policy fields are not ported), ``apply_inverse_rot45`` and
``reconstruct_batch``, the dispatch of frames the tiled paths cannot
take (rotated orientations, samples wider than 10 bits, configurations
``tiled.tiled_supported`` rejects).

The gather fallback reads the raster planes at each slot's pixel, as
the reference's ``_flat_batch_impl`` does: plain PyTorch slot math on
the tensors' device (:func:`gather_words`), then the full-order
compaction ``shift_compact_full`` (kernel K1F on a CUDA tensor). The
reference's ``(F*S, N_GROUP_FIELDS)`` row gather of the group table
becomes a broadcast of ``(F, G, 1)`` field columns against the
``res*res*2`` slots of a group, so no per-slot field rows are made.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..atlas import groups as G


@dataclass(frozen=True)
class FrameConfig:
    width: int
    height: int
    occupancy_resolution: int
    occupancy_precision: int
    map_count: int = 2
    absolute_d1: bool = True
    # trailing-layer pass over the map pair (m-1, m): the D0 slots are
    # dedup comparands only, so only the D1 points emit
    drop_map0: bool = False
    geo_shift: int = 2  # depth = sample >> geo_shift
    # attribute chroma subsampling: 1 for 4:2:0, 0 for 4:4:4/RGB
    chroma_shift: int = 1
    # geometry / attribute smoothing configs (None = off): the wide path
    smoothing: object = None
    attr_smoothing: object = None
    # the host transposed SWAP-family blocks in the packed cat, so the
    # gathered tiles arrive in patch memory order
    host_oriented: bool = False
    # some patch projects onto a 45-degree plane (wide path only)
    additional_planes: bool = False
    geometry_bitdepth_3d: int = 10
    # all three coordinates pack into one u32, 10 bits each (the host
    # proved every axis value < 1024: atlas.groups.coords_fit_10bit)
    pack30: bool = False

    @property
    def slots_per_block(self) -> int:
        return self.occupancy_resolution * self.occupancy_resolution * 2

    @property
    def g_cap(self) -> int:
        """Canvas blocks: the group-axis capacity."""
        res = self.occupancy_resolution
        return (self.height // res) * (self.width // res)


def make_config(
    width: int,
    height: int,
    occupancy_resolution: int,
    occupancy_precision: int,
    map_count: int = 2,
    absolute_d1: bool = True,
    geo_shift: int = 2,
    chroma_shift: int = 1,
    smoothing=None,
    attr_smoothing=None,
    pack30: bool = False,
    additional_planes: bool = False,
    geometry_bitdepth_3d: int = 10,
) -> FrameConfig:
    return FrameConfig(
        width=width,
        height=height,
        occupancy_resolution=occupancy_resolution,
        occupancy_precision=occupancy_precision,
        map_count=map_count,
        absolute_d1=absolute_d1,
        geo_shift=geo_shift,
        chroma_shift=chroma_shift,
        smoothing=smoothing,
        attr_smoothing=attr_smoothing,
        pack30=pack30,
        additional_planes=additional_planes,
        geometry_bitdepth_3d=geometry_bitdepth_3d,
    )


def apply_inverse_rot45(px, py, pz, plane, bitdepth: int):
    """Inverse 45-degree rotation, counterpart of
    ``tpu_vpcc.ops.reconstruct.apply_inverse_rot45``.

    ``px/py/pz``: int32 rotated-frame components; ``plane``: int32
    ``axis_of_additional_plane`` broadcastable against them (0 =
    identity). ``>> 1`` on int32 is an arithmetic shift (floor), as in
    the scalar oracle. Returns u16-masked int32 components."""
    shift = (1 << (bitdepth - 1)) - 1

    def pair(rs, rd):
        return (rs - rd + shift) >> 1, (rs + rd - shift) >> 1

    x1, z1 = pair(px, pz)  # plane 1 mixes (x, z)
    z2, y2 = pair(pz, py)  # plane 2 mixes (z, y)
    y3, x3 = pair(py, px)  # plane 3 mixes (y, x)
    nx = torch.where(plane == 1, x1, torch.where(plane == 3, x3, px))
    ny = torch.where(plane == 2, y2, torch.where(plane == 3, y3, py))
    nz = torch.where(plane == 1, z1, torch.where(plane == 2, z2, pz))
    return nx & 0xFFFF, ny & 0xFFFF, nz & 0xFFFF


def _check_gather(fields, occ, geo0, geo1, ay, au, av, cfg: FrameConfig):
    """Refuse inputs whose planes would not cover every clipped pixel
    index: on a CUDA tensor an index past a plane is a device fault."""
    F, H, W = fields.shape[0], cfg.height, cfg.width
    if fields.dim() != 3 or fields.shape[2] != G.N_GROUP_FIELDS \
            or fields.dtype != torch.int32:
        raise ValueError(f"fields must be (F, G, {G.N_GROUP_FIELDS}) int32, "
                         f"got {tuple(fields.shape)} {fields.dtype}")
    M, csh, prec = cfg.map_count, cfg.chroma_shift, cfg.occupancy_precision
    h2, w2 = ((H - 1) >> csh) + 1, ((W - 1) >> csh) + 1
    want = {
        "occ": (occ, torch.uint8, (F, (H - 1) // prec + 1, (W - 1) // prec + 1)),
        "geo0": (geo0, torch.int16, (F, H, W)),
        "geo1": (geo1, torch.int16, (F, H, W)),
        "attr_y": (ay, torch.int16, (F, M, H, W)),
        "attr_u": (au, torch.int16, (F, M, h2, w2)),
        "attr_v": (av, torch.int16, (F, M, h2, w2)),
    }
    for name, (t, dtype, least) in want.items():
        if t.dtype != dtype or t.dim() != len(least) or t.shape[0] != F \
                or any(n < m for n, m in zip(t.shape[1:], least[1:])):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, want "
                             f"{dtype} covering {least}")
        if t.device != fields.device:
            raise ValueError(f"{name} lies on {t.device}, fields on "
                             f"{fields.device}")


def _sample(plane, index):
    """u16 samples (carried as int16 bit patterns) of ``plane`` at flat
    int64 ``index``, widened to int32."""
    return plane.reshape(-1)[index].to(torch.int32) & 0xFFFF


def gather_words(fields, occ, geo0, geo1, ay, au, av, cfg: FrameConfig):
    """The gather fallback's slot math: the counterpart of
    ``tpu_vpcc.ops.reconstruct._flat_batch_impl`` up to its compaction.

    Inputs, each with a leading frame axis, on one device: ``fields``
    (F, G, N_GROUP_FIELDS) int32 (G may be bucketed), ``occ`` (F, H/prec,
    W/prec) uint8, ``geo0``/``geo1`` (F, H, W) and ``ay`` (F, M, H, W),
    ``au``/``av`` (F, M, H >> chroma_shift, W >> chroma_shift), the u16
    planes as int16 bit patterns. Slot ``s`` of a frame is group ``s //
    (2 res²)``, patch pixel ``(u1, v1)`` in raster order, map ``s % 2``.
    Returns ``(w0, w1, w2, valid)``, each (F, G * 2 * res²) in emission
    order: ``w0 = x | y << 16``, ``w1 = z | cy << 16``, ``w2 = cu | cv <<
    16`` as int32 bit patterns (all 16 bits of a sample kept), ``valid``
    bool."""
    from .smoothing import smooth_colors_flat, smooth_flat
    from .tiled import _pack16

    _check_gather(fields, occ, geo0, geo1, ay, au, av, cfg)
    F, Gb = fields.shape[0], fields.shape[1]
    res, spb = cfg.occupancy_resolution, cfg.slots_per_block
    H, W, M = cfg.height, cfg.width, cfg.map_count
    Hp, Wp = occ.shape[1], occ.shape[2]
    H2, W2 = au.shape[2], au.shape[3]
    prec, csh = cfg.occupancy_precision, cfg.chroma_shift
    dev = fields.device

    # slot decomposition within a group (constant divisors)
    r = torch.arange(spb, dtype=torch.int32, device=dev)
    v1 = r // (res * 2)
    r2 = r - v1 * (res * 2)
    u1 = r2 // 2
    i_map = r2 - u1 * 2
    f = torch.arange(F, dtype=torch.int64, device=dev).view(F, 1, 1)

    def col(idx):
        return fields[:, :, idx : idx + 1]  # (F, G, 1), broadcast over slots

    # the group's affine pixel, clipped to the canvas
    xs = (col(G.G_X00) + col(G.G_A) * u1 + col(G.G_B) * v1).clamp(0, W - 1)
    ys = (col(G.G_Y00) + col(G.G_C) * u1 + col(G.G_D) * v1).clamp(0, H - 1)

    occ_at = occ.reshape(-1)[(f * Hp + ys // prec) * Wp + xs // prec]
    valid = (col(G.G_VALID) > 0) & (occ_at > 0)

    pix = (f * H + ys) * W + xs
    d0 = _sample(geo0, pix) >> cfg.geo_shift
    d1 = _sample(geo1, pix) >> cfg.geo_shift

    d1_patch, mode = col(G.G_D1), col(G.G_MODE)

    def normal_coord(depth):
        return torch.where(
            mode == 0, depth + d1_patch, torch.maximum(d1_patch, depth) - depth
        )

    tangent = (col(G.G_T00) + col(G.G_LODX) * u1) & 0xFFFF
    bitangent = (col(G.G_B00) + col(G.G_LODY) * v1) & 0xFFFF
    n0 = normal_coord(d0)
    if cfg.absolute_d1:
        n1 = normal_coord(d1)
    else:
        n1 = torch.where(mode == 0, n0 + d1, n0 - d1)
    n0 = n0 & 0xFFFF
    n1 = n1 & 0xFFFF

    # D1 dedup: a D1 slot emits only with two maps and a distinct normal
    is_d1 = i_map == 1
    if M > 1:
        valid = valid & (~is_d1 | (n1 != n0))
    else:
        valid = valid & ~is_d1
    if cfg.drop_map0:
        # trailing-layer pass: D0 slots are dedup comparands only
        valid = valid & is_d1
    n_sel = torch.where(is_d1, n1, n0)

    # component assembly: one-hot on the axis permutation
    pos = [
        torch.where(col(G.G_NORMAL) == c, n_sel, 0)
        + torch.where(col(G.G_TANGENT) == c, tangent, 0)
        + torch.where(col(G.G_BITANGENT) == c, bitangent, 0)
        for c in range(3)
    ]
    if cfg.additional_planes:
        # before smoothing: the grid smoother sees true coordinates
        pos = list(apply_inverse_rot45(
            *pos, col(G.G_PLANE), cfg.geometry_bitdepth_3d
        ))

    smoothing = cfg.smoothing is not None or cfg.attr_smoothing is not None
    if smoothing:
        frame = f.expand(F, Gb, spb)
        pid = col(G.G_PATCH).expand(F, Gb, spb)
    if cfg.smoothing is not None:
        pos = list(smooth_flat(*pos, valid, pid, frame, F, cfg.smoothing))

    # colours at the unsmoothed pixel, from map clip(i_map, 0, M - 1)
    zf = f * M + i_map.clamp(0, M - 1)
    cy = _sample(ay, (zf * H + ys) * W + xs)
    chroma = (zf * H2 + (ys >> csh)) * W2 + (xs >> csh)
    cu = _sample(au, chroma)
    cv = _sample(av, chroma)
    if cfg.attr_smoothing is not None:
        cy, cu, cv = smooth_colors_flat(
            *pos, cy, cu, cv, valid, pid, frame, F, cfg.attr_smoothing
        )

    S = Gb * spb

    def word(lo, hi):
        # the reference's u16 casts keep the low 16 bits of each value
        return _pack16(lo.reshape(F, S) & 0xFFFF, hi.reshape(F, S) & 0xFFFF)

    return (word(pos[0], pos[1]), word(pos[2], cy), word(cu, cv),
            valid.reshape(F, S))


def reconstruct_batch(fields, occ, geo0, geo1, ay, au, av, cfg: FrameConfig):
    """The gather dispatch: :func:`gather_words`, then the full-order
    compaction (K1F on a CUDA tensor). Same inputs as
    :func:`gather_words`. Returns ``(ops, counts)``: ``ops`` the
    compacted ``(w0, w1, w2)``, each (F, S) with the frame's prefix in
    emission order and an unspecified tail (unpack with
    ``tiled._unpack_ops_points(ops, "gather")``), ``counts`` (F,) int32."""
    from .shift_compact import shift_compact_full

    *words, valid = gather_words(fields, occ, geo0, geo1, ay, au, av, cfg)
    return shift_compact_full(words, valid)
