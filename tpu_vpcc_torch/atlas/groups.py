"""Host-side group-table construction: owned canvas blocks → flat groups.

The device reconstruction (``tpu_vpcc.ops.reconstruct``) operates on
*groups*: one group per (patch, owned canvas block) in the reference
emission order, each owning ``res*res*2`` consecutive slots. This module
derives the block-to-patch ownership map and the per-group field table on
the host.

Correctness note (why ownership is host-computable): the reference sets
``block_to_patch[b] = p+1`` for the *last* patch covering b whose block
has any occupied pixel (``src/codec.rs:217-247``), and a point is only
emitted where its own occupancy sample is non-zero (``src/codec.rs:
393-397``) — which implies the block had occupancy. So computing the
owner as simply "last covering patch" (occupancy-ignored) changes
``block_to_patch`` only on blocks that emit nothing, and the emitted
point set — order included — is bit-identical. This removes the
occupancy-dependent ownership pass from the device hot path entirely.

The identity has ONE precondition: every patch covering a contested
block must sample the same pixel set for it. That holds whenever each
patch's pixel tile IS the canvas block (DEFAULT/SWAP/MROT270, and all
orientations at resolution 1), but the quirk-admitted rotated
orientations at resolution > 1 sample pixels from a *different* canvas
region than the block transform names. For frames where such a patch
overlaps another patch, :func:`build_group_table` falls back to the
reference's exact occupancy-gated ownership (vectorized, host-side,
rare) — see ``_occupancy_gated_owner``.

The per-group affine (G_X00/G_A..G_D) expresses the reference's quirked
orientation transform exactly for ALL orientations the reference itself
decodes (see ``atlas.patches._check_orientation_in_range``): canvas
coords are affine in patch-space (u, v), so per-pixel emission equals
per-block ownership + per-pixel occupancy for every admitted patch.
Orientations whose pixel tiles are not block-aligned under the quirk
simply force the gather kernel via ``tiled_ok=False``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..v3c.syntax import UnsupportedFeature
from .patches import FrameMeta, Patch, PatchOrientation

# group-table field indices
(
    G_VALID,      # 1 for live groups, 0 for padding
    G_X00,        # canvas x at patch-space (u1, v1) = (0, 0)
    G_Y00,
    G_A, G_B, G_C, G_D,  # x = x00 + a*u1 + b*v1 ; y = y00 + c*u1 + d*v1
    G_T00,        # tangent at u1 = 0 (u0*res*lod_x + uv1_u)
    G_LODX,
    G_B00,        # bitangent at v1 = 0
    G_LODY,
    G_D1,
    G_MODE,
    G_NORMAL, G_TANGENT, G_BITANGENT,
    G_BLOCKID,    # canvas tile row index (block tables: by*bw + bx at the
                  # block grid; cell tables: the cell grid equivalent)
    G_SWAP,       # 1 when the pixel tile is transposed vs canvas (SWAP)
    G_PATCH,      # patch index (grid-smoothing cluster id)
    G_EMITBASE,   # frame slot index of this group's patch-space (0,0) D0
                  # slot: block tables group_idx*res*res*2; cell tables
                  # block_rank*res*res*2 + (v1c*res + u1c)*2
    G_PLANE,      # axis_of_additional_plane (0 = none; 1..3 select the
                  # 45-degree inverse rotation — framework extension,
                  # see atlas.patches.inverse_rotate_45)
) = range(21)

N_GROUP_FIELDS = 21


def coords_fit_10bit(
    fields: np.ndarray, n_groups: int, tile: int, geo_shift: int,
    absolute_d1: bool,
) -> bool:
    """True when every coordinate this table can emit is provably
    < 1024, so the device may pack (x, y, z) into one u32 (10 bits
    each; ``cfg.pack30``).

    The three axis values are bounded from the table alone:
    depth <= (2^10 - 1) >> geo_shift (10-bit decoded samples, gated
    upstream by packed10_ok); normal = depth + d1 (mode 0) or
    max(d1, depth) - depth <= max(d1, depth) (mode 1); tangent /
    bitangent are affine in the in-tile patch coordinate with
    host-known origins. Relative-D1 coding (absolute_d1=False) can
    underflow through the u16 wrap and is excluded.
    """
    if not absolute_d1:
        return False
    f = fields[:n_groups]
    if f.shape[0] == 0:
        return True
    # the device masks values & 0xFFFF — a negative table entry (only
    # reachable from corrupt input surviving parse) would WRAP on device
    # while this bound saw a small value, so any negative disqualifies
    if bool((f[:, [G_D1, G_T00, G_B00, G_LODX, G_LODY]] < 0).any()):
        return False
    depth_max = ((1 << 10) - 1) >> geo_shift
    d1 = f[:, G_D1].astype(np.int64)
    n_max = np.where(
        f[:, G_MODE] == 0, d1 + depth_max, np.maximum(d1, depth_max)
    ).max()
    t_max = (f[:, G_T00].astype(np.int64) + f[:, G_LODX] * (tile - 1)).max()
    b_max = (f[:, G_B00].astype(np.int64) + f[:, G_LODY] * (tile - 1)).max()
    return bool(max(n_max, t_max, b_max) < 1024)


def bucket_group_count(
    n_live: int, g_cap: int, multiple_of: int = 1, min_bucket: int = 256
) -> int:
    """Round a live group count up to a quarter-power-of-two bucket.

    The device kernels size their group axis (and therefore the words
    stage and the O(n log^2 n) compaction sort) from ``fields.shape[1]``;
    padding to the full canvas-block capacity makes them pay for dead
    slots (a ~1M-point 1280^2 frame owns ~2.7k of 6400 blocks — the
    reference only ever visits owned blocks, ``src/codec.rs:352-480``).
    Buckets are ``m * 2^e`` with mantissa m in {4,5,6,7} (waste <= 25%)
    so a stream compiles at most a handful of kernel variants; a floor of
    ``min_bucket`` keeps near-empty frames from minting tiny variants.
    ``multiple_of`` (the mesh 'space' axis, when sharded) is applied
    after the bucket rounding; the result is clamped to ``g_cap``.
    """
    n = max(int(n_live), min_bucket, 1)
    if n < g_cap:
        e = max(n.bit_length() - 3, 0)  # so that 4*2^e <= n < 8*2^e
        m = -(-n >> e)  # ceil(n / 2^e), in 4..8
        n = m << e
    if multiple_of > 1:
        n = -(-n // multiple_of) * multiple_of
    return min(n, g_cap)


@dataclass
class GroupTable:
    """Per-frame group fields, padded to the static canvas-block capacity."""

    fields: np.ndarray  # (g_cap, N_GROUP_FIELDS) int32
    n_groups: int
    block_to_patch: np.ndarray  # (bh, bw) int32 — parity/debug
    tiled_ok: bool = True  # all orientations have block-aligned pixel tiles
    # quantized patch extents (FRAMEWORK EXTENSION, patch size
    # quantizer): per-group (lim_u, lim_v) — patch-space pixel limits
    # within the block, in [1, res]; res = untrimmed. HOST-consumed
    # only: the cat staging clears the packed occupancy bit past the
    # limits (ops.tiled.stage_cat_inputs), so the device kernels never
    # see the trim. None when no patch in the frame is quantized.
    trim: np.ndarray = None  # (g_cap, 2) int32 or None


# orientations whose pixel tile equals the canvas block at any resolution
_BLOCK_ALIGNED = frozenset(
    {PatchOrientation.DEFAULT, PatchOrientation.SWAP, PatchOrientation.MROT270}
)


def _occupancy_gated_owner(meta: FrameMeta, per_patch, owner_shape,
                           occ_plane, occ_precision: int):
    """The reference's exact block ownership (``src/codec.rs:205-250``),
    vectorized: owner[b] = last patch in PRECEDENCE order whose OWN
    pixels of patch block b (quirked pixel transform) include a non-zero
    occupancy sample (later patches win; reversed when
    ``meta.patch_precedence``).

    Only used for frames where a non-block-aligned patch overlaps another
    patch — everywhere else the occupancy-ignored owner is provably
    identical (module docstring) and O(blocks) instead of O(pixels)."""
    bh, bw = owner_shape
    owner = np.zeros((bh, bw), dtype=np.int32)
    occ = np.asarray(occ_plane)
    order = (
        range(len(meta.patches) - 1, -1, -1)
        if meta.patch_precedence else range(len(meta.patches))
    )
    for pidx in order:
        patch = meta.patches[pidx]
        u0g, v0g, bx, by = per_patch[pidx]
        res_p = patch.occupancy_resolution
        a, b, cxp, c, d, cyp = patch.orientation_coeffs(res_p)
        # pixel grids for every block of this patch: (sv0, su0, res, res)
        u1 = np.arange(res_p, dtype=np.int64)
        v1 = np.arange(res_p, dtype=np.int64)
        u = u0g[:, :, None, None] * res_p + u1[None, None, None, :]
        v = v0g[:, :, None, None] * res_p + v1[None, None, :, None]
        x = a * u + b * v + cxp + meta.left_top_in_frame[0]
        y = c * u + d * v + cyp + meta.left_top_in_frame[1]
        # in-range guaranteed by _check_orientation_in_range (pixel gate);
        # left_top_in_frame is (0, 0) for the single-tile envelope but is
        # applied for oracle parity (src/codec.rs:233-235)
        nz = occ[y // occ_precision, x // occ_precision].reshape(
            u0g.shape[0], u0g.shape[1], -1
        ).sum(axis=-1)
        has = nz > 0
        owner[by[has], bx[has]] = pidx + 1
    return owner


def build_group_table(
    meta: FrameMeta, g_cap: int = 0, occupancy_resolution: int = 0,
    occ_provider=None, occ_precision: int = 1,
) -> GroupTable:
    """Build the owned-block group table in emission order.

    Emission order: patches ascending, blocks in patch-space (v0, u0)
    raster order (``src/codec.rs:352-480``). Each canvas block is owned by
    at most one patch, so n_groups <= bh*bw (the static capacity).

    ``occupancy_resolution`` fixes the block size explicitly — required
    for legal empty tile layers, whose capacity must still match the
    GOF's other frames (no patches to derive it from).

    ``occ_provider``: zero-arg callable returning the frame's canvas-order
    occupancy plane (downscaled by ``occ_precision``). Invoked ONLY when a
    non-block-aligned patch overlaps another patch, where exact reference
    parity needs the occupancy-gated ownership pass. Without it, such
    frames raise :class:`UnsupportedFeature`.
    """
    if occupancy_resolution > 0:
        res = occupancy_resolution
    elif meta.patches:
        res = meta.patches[0].occupancy_resolution
    else:
        res = 16
    for pidx, p in enumerate(meta.patches):
        if p.occupancy_resolution != res:
            # mixed packing-block sizes would misalign G_BLOCKID and the
            # tile slicing against the per-patch affine origins
            raise ValueError(
                f"patch {pidx} occupancy_resolution "
                f"{p.occupancy_resolution} != table resolution {res}"
            )
    bw = meta.width // res
    bh = meta.height // res
    if g_cap <= 0:
        g_cap = bh * bw

    owner = np.zeros((bh, bw), dtype=np.int32)
    cover_cnt = np.zeros((bh, bw), dtype=np.int32)
    nonaligned_cover = np.zeros((bh, bw), dtype=bool)
    per_patch = []
    for pidx, patch in enumerate(meta.patches):
        su0, sv0 = patch.size_uv0
        a, b, cxb, c, d, cyb = patch.orientation_coeffs(1)
        u0 = np.arange(max(su0, 0), dtype=np.int64)
        v0 = np.arange(max(sv0, 0), dtype=np.int64)
        u0g, v0g = np.meshgrid(u0, v0)  # (sv0, su0) — v0-major raster
        bx = a * u0g + b * v0g + cxb
        by = c * u0g + d * v0g + cyb
        if (bx < 0).any() or (bx >= bw).any() or (by < 0).any() or (by >= bh).any():
            raise ValueError(
                f"patch {pidx} footprint outside canvas "
                f"(orientation {patch.patch_orientation!r})"
            )
        cover_cnt[by, bx] += 1  # a patch covers each of its blocks once
        if res > 1 and patch.patch_orientation not in _BLOCK_ALIGNED:
            nonaligned_cover[by, bx] = True
        per_patch.append((u0g, v0g, bx, by))

    # contested-block precedence: flag off = later patches overwrite
    # earlier ones (the reference's only mode); flag on = decoding
    # order wins, so earlier patches overwrite (FrameMeta.patch_precedence)
    owner_order = (
        range(len(meta.patches) - 1, -1, -1)
        if meta.patch_precedence else range(len(meta.patches))
    )
    for pidx in owner_order:
        _, _, bx, by = per_patch[pidx]
        owner[by, bx] = pidx + 1

    # hazard = some CONTESTED block is covered by a patch whose pixel
    # tile is not the canvas block; only there can the occupancy-ignored
    # owner diverge from the reference's (module docstring)
    if bool((nonaligned_cover & (cover_cnt >= 2)).any()):
        if occ_provider is None:
            raise UnsupportedFeature(
                "overlapping non-block-aligned patches need the "
                "occupancy-gated ownership pass, and no occupancy plane "
                "was provided to build_group_table"
            )
        owner = _occupancy_gated_owner(
            meta, per_patch, (bh, bw), occ_provider(), occ_precision
        )

    n_groups = 0
    tiled_ok = True
    fields = np.zeros((g_cap, N_GROUP_FIELDS), dtype=np.int32)
    trim = None
    for pidx, patch in enumerate(meta.patches):
        u0g, v0g, bx, by = per_patch[pidx]
        owned = owner[by, bx] == pidx + 1  # (sv0, su0) mask in raster order
        u0s = u0g[owned]
        v0s = v0g[owned]
        k = u0s.shape[0]
        if k == 0:
            continue
        sl = slice(n_groups, n_groups + k)
        n_groups += k
        if n_groups > g_cap:
            raise ValueError("group capacity exceeded")
        res_p = patch.occupancy_resolution
        a, b, cxp, c, d, cyp = patch.orientation_coeffs(res_p)
        fields[sl, G_VALID] = 1
        fields[sl, G_X00] = a * (u0s * res_p) + b * (v0s * res_p) + cxp
        fields[sl, G_Y00] = c * (u0s * res_p) + d * (v0s * res_p) + cyp
        fields[sl, G_A] = a
        fields[sl, G_B] = b
        fields[sl, G_C] = c
        fields[sl, G_D] = d
        fields[sl, G_T00] = u0s * res_p * patch.level_of_detail[0] + patch.uv1[0]
        fields[sl, G_LODX] = patch.level_of_detail[0]
        fields[sl, G_B00] = v0s * res_p * patch.level_of_detail[1] + patch.uv1[1]
        fields[sl, G_LODY] = patch.level_of_detail[1]
        fields[sl, G_D1] = patch.d1
        fields[sl, G_MODE] = patch.projection_mode
        fields[sl, G_NORMAL] = patch.axes[0]
        fields[sl, G_TANGENT] = patch.axes[1]
        fields[sl, G_BITANGENT] = patch.axes[2]
        fields[sl, G_BLOCKID] = by[owned] * bw + bx[owned]
        fields[sl, G_PATCH] = pidx
        fields[sl, G_PLANE] = patch.axis_of_additional_plane
        if patch.size_2d_in_pixel is not None:
            # quantized extent: patch-space pixel limits of each owned
            # block, clamped to the tile edge. size_uv0 = ceil(extent /
            # res) guarantees lims >= 1 (no block is fully outside).
            if trim is None:
                trim = np.full((g_cap, 2), res, dtype=np.int32)
            sx, sy = patch.size_2d_in_pixel
            trim[sl, 0] = np.clip(sx - u0s * res_p, 1, res_p)
            trim[sl, 1] = np.clip(sy - v0s * res_p, 1, res_p)
        fields[sl, G_EMITBASE] = (
            np.arange(sl.start, sl.stop) * (res * res * 2)
        )
        # Orientations whose pixel tile is the canvas block, possibly
        # transposed: DEFAULT (identity), SWAP/MROT270 (transpose). All
        # others leave block alignment (the tmc2-rs size quirk, see
        # patches.orientation_coeffs) and force the gather fallback.
        o = patch.patch_orientation
        if o in (PatchOrientation.SWAP, PatchOrientation.MROT270):
            fields[sl, G_SWAP] = 1
        elif o != PatchOrientation.DEFAULT:
            tiled_ok = False

    return GroupTable(
        fields=fields, n_groups=n_groups, block_to_patch=owner,
        tiled_ok=tiled_ok, trim=trim,
    )


# per-patch parameter columns of build_group_tables
(
    _P_SU0, _P_SV0,                # size in blocks, clamped at 0
    _P_A, _P_B, _P_CXB, _P_C, _P_D, _P_CYB,  # orientation_coeffs(1)
    _P_CX, _P_CY,                  # orientation_coeffs(res) origins
    _P_U1, _P_LODX, _P_V1, _P_LODY,
    _P_D1, _P_MODE, _P_NORMAL, _P_TANGENT, _P_BITANGENT, _P_PLANE,
    _P_SWAP,                       # pixel tile transposed (SWAP/MROT270)
    _P_GATHER,                     # pixel tile leaves block alignment
    _P_NONALIGNED,                 # ... and res > 1 (ownership hazard)
    _P_QUANTIZED, _P_SX, _P_SY,    # size_2d_in_pixel (0, 0 when None)
) = range(26)

# the table columns that hold one value per patch, and their parameters
_CONST_FIELDS = (
    (G_A, _P_A), (G_B, _P_B), (G_C, _P_C), (G_D, _P_D),
    (G_LODX, _P_LODX), (G_LODY, _P_LODY), (G_D1, _P_D1),
    (G_MODE, _P_MODE), (G_NORMAL, _P_NORMAL), (G_TANGENT, _P_TANGENT),
    (G_BITANGENT, _P_BITANGENT), (G_SWAP, _P_SWAP), (G_PLANE, _P_PLANE),
)
_TILE_SWAPPED = frozenset({PatchOrientation.SWAP, PatchOrientation.MROT270})


def build_group_tables(
    metas, occupancy_resolution: int = 0, occ_provider_for=None,
    occ_precision: int = 1, g_cap: int = 0,
):
    """:func:`build_group_table` for every frame of ``metas``, each
    frame's table built in one vectorised pass: the same ``fields``,
    ``n_groups``, ``block_to_patch``, ``tiled_ok`` and ``trim``, byte for
    byte, and the same exceptions.

    ``occ_provider_for(meta)`` returns that frame's ``occ_provider``
    (None: no occupancy plane). Returns ``(tables, gated)``, where
    ``gated`` counts the frames that took the occupancy-gated ownership
    pass (``_occupancy_gated_owner``)."""
    tables, gated = [], 0
    for meta in metas:
        provider = occ_provider_for(meta) if occ_provider_for else None
        table, was_gated = _frame_group_table(
            meta, g_cap, occupancy_resolution, provider, occ_precision
        )
        tables.append(table)
        gated += was_gated
    return tables, gated


def _patch_params(patch: Patch, res: int):
    su0, sv0 = patch.size_uv0
    a, b, cxb, c, d, cyb = patch.orientation_coeffs(1)
    cx, cy = patch.orientation_coeffs(res)[2::3]
    o = patch.patch_orientation
    quantized = patch.size_2d_in_pixel is not None
    return (
        max(su0, 0), max(sv0, 0), a, b, cxb, c, d, cyb, cx, cy,
        patch.uv1[0], patch.level_of_detail[0],
        patch.uv1[1], patch.level_of_detail[1],
        patch.d1, patch.projection_mode, *patch.axes,
        patch.axis_of_additional_plane, o in _TILE_SWAPPED,
        o != PatchOrientation.DEFAULT and o not in _TILE_SWAPPED,
        res > 1 and o not in _BLOCK_ALIGNED,
        quantized, *(patch.size_2d_in_pixel if quantized else (0, 0)),
    )


def _frame_group_table(meta: FrameMeta, g_cap: int,
                       occupancy_resolution: int, occ_provider,
                       occ_precision: int):
    """One frame's table as :func:`build_group_table` builds it, and
    whether it took the occupancy-gated owner. Every patch block is one
    row, in emission order (patches ascending, (v0, u0) raster within a
    patch); ownership, the owned rows and the fields are array
    operations over the rows."""
    patches = meta.patches
    if occupancy_resolution > 0:
        res = occupancy_resolution
    elif patches:
        res = patches[0].occupancy_resolution
    else:
        res = 16
    for pidx, p in enumerate(patches):
        if p.occupancy_resolution != res:
            raise ValueError(
                f"patch {pidx} occupancy_resolution "
                f"{p.occupancy_resolution} != table resolution {res}"
            )
    bw = meta.width // res
    bh = meta.height // res
    if g_cap <= 0:
        g_cap = bh * bw
    fields = np.zeros((g_cap, N_GROUP_FIELDS), dtype=np.int32)
    if not patches:
        return GroupTable(
            fields=fields, n_groups=0,
            block_to_patch=np.zeros((bh, bw), dtype=np.int32),
        ), False

    n_patches = len(patches)
    par = np.array([_patch_params(p, res) for p in patches], dtype=np.int64)
    counts = par[:, _P_SU0] * par[:, _P_SV0]
    ends = np.cumsum(counts)
    pid = np.repeat(np.arange(n_patches, dtype=np.int32), counts)
    # in-patch raster index -> (u0, v0), v0-major as np.meshgrid gives
    v0, u0 = np.divmod(np.arange(pid.shape[0]) - (ends - counts)[pid],
                       par[pid, _P_SU0])
    a, b, cxb, c, d, cyb = par[:, _P_A:_P_CYB + 1].T
    bx = a[pid] * u0 + b[pid] * v0 + cxb[pid]
    by = c[pid] * u0 + d[pid] * v0 + cyb[pid]
    outside = (bx < 0) | (bx >= bw) | (by < 0) | (by >= bh)
    if outside.any():
        pidx = int(pid[outside.argmax()])
        raise ValueError(
            f"patch {pidx} footprint outside canvas "
            f"(orientation {patches[pidx].patch_orientation!r})"
        )
    flat = by * bw + bx

    # contested blocks: the last covering patch wins, or the first with
    # meta.patch_precedence; a max over each block's rows keeps that
    # deterministic
    owner = np.zeros(bh * bw, dtype=np.int32)
    if meta.patch_precedence:
        np.maximum.at(owner, flat, n_patches - pid)
        owner = np.where(owner > 0, n_patches + 1 - owner, 0).astype(np.int32)
    else:
        np.maximum.at(owner, flat, pid + 1)

    gated = False
    nonaligned = par[:, _P_NONALIGNED].astype(bool)
    if nonaligned.any():
        cover = np.bincount(flat, minlength=bh * bw)
        if bool((nonaligned[pid] & (cover[flat] >= 2)).any()):
            if occ_provider is None:
                raise UnsupportedFeature(
                    "overlapping non-block-aligned patches need the "
                    "occupancy-gated ownership pass, and no occupancy plane "
                    "was provided to build_group_table"
                )
            per_patch = [
                tuple(x[e - su * sv:e].reshape(sv, su)
                      for x in (u0, v0, bx, by))
                for e, su, sv in zip(ends.tolist(), par[:, _P_SU0].tolist(),
                                     par[:, _P_SV0].tolist())
            ]
            owner = _occupancy_gated_owner(
                meta, per_patch, (bh, bw), occ_provider(), occ_precision
            ).ravel()
            gated = True

    owned = np.flatnonzero(owner[flat] == pid + 1)
    n_groups = owned.shape[0]
    if n_groups > g_cap:
        raise ValueError("group capacity exceeded")
    opid = pid[owned]
    has_rows = np.bincount(opid, minlength=n_patches) > 0
    # build_group_table writes these as Python ints, which NumPy refuses
    # outside int32 (a corrupt stream's Exp-Golomb LoD, say)
    const = par[has_rows][:, [k for _, k in _CONST_FIELDS]]
    if const.size and (const.min() < -(1 << 31) or const.max() >= 1 << 31):
        raise OverflowError("a patch's group field is out of bounds for int32")
    # the per-patch columns, with each patch's offsets of X00, Y00, T00
    # and B00: X00 = a*u0*res + b*v0*res + cx = res*(bx - cxb) + cx
    tmpl = np.zeros((n_patches, N_GROUP_FIELDS), dtype=np.int64)
    tmpl[:, G_VALID] = 1
    for g, k in _CONST_FIELDS:
        tmpl[:, g] = par[:, k]
    tmpl[:, G_PATCH] = np.arange(n_patches)
    tmpl[:, G_X00] = par[:, _P_CX] - res * cxb
    tmpl[:, G_Y00] = par[:, _P_CY] - res * cyb
    tmpl[:, G_T00] = par[:, _P_U1]
    tmpl[:, G_B00] = par[:, _P_V1]
    rows = tmpl[opid]
    obx, oby = bx[owned], by[owned]
    rows[:, G_X00] += res * obx
    rows[:, G_Y00] += res * oby
    us = u0[owned] * res
    vs = v0[owned] * res
    rows[:, G_T00] += us * par[opid, _P_LODX]
    rows[:, G_B00] += vs * par[opid, _P_LODY]
    rows[:, G_BLOCKID] = oby * bw + obx
    rows[:, G_EMITBASE] = np.arange(n_groups) * (res * res * 2)
    fields[:n_groups] = rows

    tiled_ok = not bool((par[:, _P_GATHER].astype(bool) & has_rows).any())
    trim = None
    if (par[:, _P_QUANTIZED].astype(bool) & has_rows).any():
        # quantized extents: patch-space pixel limits of each owned
        # block, clamped to the tile edge (as build_group_table)
        trim = np.full((g_cap, 2), res, dtype=np.int32)
        q = np.flatnonzero(par[opid, _P_QUANTIZED])
        trim[q, 0] = np.clip(par[opid[q], _P_SX] - us[q], 1, res)
        trim[q, 1] = np.clip(par[opid[q], _P_SY] - vs[q], 1, res)
    return GroupTable(
        fields=fields, n_groups=n_groups,
        block_to_patch=owner.reshape(bh, bw),
        tiled_ok=tiled_ok, trim=trim,
    ), gated
