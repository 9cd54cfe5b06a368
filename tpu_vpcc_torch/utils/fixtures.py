"""End-to-end V3C bitstream fixture generation.

Composes synthetic scenes (``tpu_vpcc.utils.synthetic``) into complete
V3C sample-stream files: VPS + atlas NAL stream (ASPS/AFPS/one I-tile
layer per frame) + losslessly HEVC-encoded occupancy/geometry/attribute
sub-streams. Because the video coding is lossless, the NumPy oracle run
on the synthetic planes defines the exact expected decoder output.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..atlas.patches import Patch, RawPatch
from ..utils.synthetic import SyntheticFrame
from ..v3c import writer as w3c
from ..v3c.syntax import (
    AtlasFrameParameterSet,
    AtlasFrameTileInformation,
    AtlasSequenceParameterSet,
    AtlasTileHeader,
    AtlasTileLayer,
    AttributeInformation,
    EomPatchDataUnit,
    GeometryInformation,
    InterPatchDataUnit,
    IntraPatchDataUnit,
    MergePatchDataUnit,
    NalUnitType,
    OccupancyInformation,
    PatchInformationData,
    PatchModeITile,
    PatchModePTile,
    RawPatchDataUnit,
    RefListStruct,
    SkipPatchDataUnit,
    TileType,
    V3CParameterSet,
    V3CUnitType,
)
from ..video import encode_yuv420


def _patch_block_bbox(p: Patch):
    """Inclusive canvas-block bbox of a patch footprint (any
    orientation), from the affine corner transform."""
    a, b, cx, c, d, cy = p.orientation_coeffs(1)
    su, sv = p.size_uv0
    corners = [(u, v) for u in (0, su - 1) for v in (0, sv - 1)]
    xs = [a * u + b * v + cx for u, v in corners]
    ys = [c * u + d * v + cy for u, v in corners]
    return min(xs), min(ys), max(xs), max(ys)


def _split_patches_by_tile(meta, afti, width: int, height: int):
    """Per-tile (coded ath id, tile-local patches, tile-local raw
    patches, tile-local EOM patches) views of a frame's
    canvas-coordinate patch lists — the authoring inverse of
    ``atlas.patches._merge_tile_frames``.

    Aux-flagged raw/EOM patches (coords in the AUX video) are assigned
    to the tile whose aux band (AFTI aux tile rows, heights in units of
    64) contains their region, and re-coded band-relative. EOM member
    indices are remapped tile-local; every member must land in the same
    tile as its EOM patch."""
    from dataclasses import replace

    res = (
        meta.patches[0].occupancy_resolution if meta.patches
        else meta.raw_patches[0].occupancy_resolution if meta.raw_patches
        else meta.eom_patches[0].occupancy_resolution if meta.eom_patches
        else 16
    )
    # aux band [start, end) pixel ranges per tile
    heights = afti.auxiliary_video_tile_row_height
    band_y, bands = 0, []
    for t in range(afti.tile_count()):
        h = 64 * (heights[t] if t < len(heights) else 0)
        bands.append((band_y, band_y + h))
        band_y += h

    def aux_tile_of(v0_blocks: int, size_v0: int, what: str) -> int:
        y0, y1 = v0_blocks * res, (v0_blocks + size_v0) * res
        for t, (b0, b1) in enumerate(bands):
            if b0 <= y0 and y1 <= b1:
                assert b0 % res == 0, (
                    f"aux band start {b0} not {res}-px block aligned"
                )
                return t
        raise AssertionError(
            f"aux {what} rows [{y0},{y1}) fit no declared aux band "
            f"{bands}"
        )

    views = []
    n_assigned = 0
    # global regular-patch index -> (tile, tile-local index)
    local_of = {}
    for t in range(afti.tile_count()):
        tx, ty, tw, th = afti.tile_rect(t, width, height)
        assert (
            tx % res == 0 and ty % res == 0
            and tw % res == 0 and th % res == 0
        ), f"tile rect {(tx, ty, tw, th)} not {res}-px block aligned"
        bx0, by0 = tx // res, ty // res
        bx1, by1 = bx0 + tw // res, by0 + th // res
        t_patches, t_raws, t_eoms = [], [], []
        for gi, p in enumerate(meta.patches):
            x0, y0, x1, y1 = _patch_block_bbox(p)
            if bx0 <= x0 and x1 < bx1 and by0 <= y0 and y1 < by1:
                local_of[gi] = (t, len(t_patches))
                t_patches.append(
                    replace(p, uv0=(p.uv0[0] - bx0, p.uv0[1] - by0))
                )
                n_assigned += 1
        for rp in meta.raw_patches:
            if rp.in_aux_video:
                if aux_tile_of(rp.v0, rp.size_v0, "raw patch") == t:
                    t_raws.append(
                        replace(rp, v0=rp.v0 - bands[t][0] // res)
                    )
                    n_assigned += 1
            elif (
                bx0 <= rp.u0 and rp.u0 + rp.size_u0 <= bx1
                and by0 <= rp.v0 and rp.v0 + rp.size_v0 <= by1
            ):
                t_raws.append(replace(rp, u0=rp.u0 - bx0, v0=rp.v0 - by0))
                n_assigned += 1
        tid = afti.tile_id[t] if afti.signalled_tile_id_flag else t
        views.append((tid, t_patches, t_raws, t_eoms))
    assert n_assigned == len(meta.patches) + len(meta.raw_patches), (
        "a patch straddles tile boundaries"
    )
    # EOM patches go to their members' tile (members must agree); the
    # region is canvas-tile-local or aux-band-local by the flag
    for ep in meta.eom_patches:
        tiles_of = {local_of[m][0] for m in ep.member_patches}
        assert len(tiles_of) == 1, (
            f"EOM members {ep.member_patches} span tiles {tiles_of}"
        )
        t = tiles_of.pop()
        if ep.in_aux_video:
            assert aux_tile_of(ep.v0, ep.size_v0, "EOM patch") == t, (
                "aux EOM region lies outside its members' tile band"
            )
            u0, v0 = ep.u0, ep.v0 - bands[t][0] // res
        else:
            tx, ty, tw, th = afti.tile_rect(t, width, height)
            bx0, by0 = tx // res, ty // res
            assert (
                bx0 <= ep.u0 and (ep.u0 + ep.size_u0) * res <= tx + tw
                and by0 <= ep.v0 and (ep.v0 + ep.size_v0) * res <= ty + th
            ), "EOM region lies outside its members' tile"
            u0, v0 = ep.u0 - bx0, ep.v0 - by0
        views[t][3].append(
            replace(
                ep, u0=u0, v0=v0,
                member_patches=[local_of[m][1] for m in ep.member_patches],
                member_points=list(ep.member_points),
            )
        )
    return views


# Inverse of Patch.set_view_id over the full 18-view table (views 6..17
# are the 45-degree additional planes — framework extension)
_VIEW_FROM_AXES = {
    (plane, (n, t, b), mode): vid
    for vid, (plane, n, t, b, mode) in Patch._VIEW_TABLE.items()
}


def patch_to_pdu(
    patch: Patch, geometry_bitdepth_3d: int, min_level: int = 1,
    size_quantizer=None,
) -> IntraPatchDataUnit:
    """Invert the patch-frame construction (``src/decoder.rs:421-509``).

    ``size_quantizer``: the ath's (log2 qx, log2 qy) when the ASPS
    codes quantized patch sizes — the PDU size is then derived from
    ``patch.size_2d_in_pixel`` (must be set, each axis a multiple of
    its quantizer) instead of the block count."""
    view_id = _VIEW_FROM_AXES[
        (patch.axis_of_additional_plane, patch.axes, patch.projection_mode)
    ]
    if patch.projection_mode == 0:
        offset_d = patch.d1 // min_level
    else:
        offset_d = ((1 << geometry_bitdepth_3d) - patch.d1) // min_level
    range_d = 0 if patch.size_d == 0 else (patch.size_d + 1) // min_level
    if size_quantizer is not None:
        qx, qy = 1 << size_quantizer[0], 1 << size_quantizer[1]
        px, py = patch.size_2d_in_pixel
        res = patch.occupancy_resolution
        assert px % qx == 0 and py % qy == 0, (
            f"extent {patch.size_2d_in_pixel} not expressible at "
            f"quantizers {(qx, qy)}"
        )
        size_2d_minus1 = (px // qx - 1, py // qy - 1)
        # the derivation must reproduce the block footprint
        assert (-(-px // res), -(-py // res)) == tuple(patch.size_uv0), (
            patch.size_2d_in_pixel, patch.size_uv0,
        )
    else:
        size_2d_minus1 = (patch.size_uv0[0] - 1, patch.size_uv0[1] - 1)
    pdu = IntraPatchDataUnit(
        projection_id=view_id,
        orientation_index=patch.patch_orientation,
        pos_2d=patch.uv0,
        size_2d_minus1=size_2d_minus1,
        pos_3d_offset=patch.uv1,
        pos_3d_offset_d=offset_d,
        pos_3d_range_d=range_d,
    )
    sx, sy = patch.level_of_detail
    if (sx, sy) != (1, 1):
        # invert the LoD derivation (atlas.patches; sy floor is 2 when
        # sx == 1 — (1, sy<2) and (sx>1, 0) are not bitstream-expressible)
        pdu.lod_enabled_flag = True
        pdu.lod_scale_x_minus1 = sx - 1
        pdu.lod_scale_y_idc = sy - (1 if sx > 1 else 2)
        assert pdu.lod_scale_y_idc >= 0, f"LoD {patch.level_of_detail}"
    return pdu


def patch_to_inter_pdu(
    patch: Patch,
    ref: Patch,
    ref_patch_idx: int,
    pred_index: int,
    geometry_bitdepth_3d: int,
    min_level: int = 1,
    ref_index: int = 0,
) -> InterPatchDataUnit:
    """Invert the inter-patch derivation (`atlas.patches._derive_inter_patch`):
    encode ``patch`` as signed deltas against ``ref``. Orientation, axes,
    projection mode and LoD must already match (they are inherited)."""
    assert patch.patch_orientation == ref.patch_orientation
    assert patch.axes == ref.axes and patch.projection_mode == ref.projection_mode
    max3d = 1 << geometry_bitdepth_3d
    if ref.projection_mode == 0:
        dd = patch.d1 // min_level - ref.d1 // min_level
    else:
        dd = (max3d - patch.d1) // min_level - (max3d - ref.d1) // min_level
    return InterPatchDataUnit(
        ref_index=ref_index,
        ref_patch_index=ref_patch_idx - pred_index,
        pos_2d=(patch.uv0[0] - ref.uv0[0], patch.uv0[1] - ref.uv0[1]),
        delta_2d_size=(
            patch.size_uv0[0] - ref.size_uv0[0],
            patch.size_uv0[1] - ref.size_uv0[1],
        ),
        pos_3d_offset=(patch.uv1[0] - ref.uv1[0], patch.uv1[1] - ref.uv1[1]),
        pos_3d_offset_d=dd,
        pos_3d_range_d=_range_d_delta(patch.size_d, ref.size_d, min_level),
    )


def _range_d_delta(want: int, ref_size_d: int, min_level: int) -> int:
    """Invert the inter/merge sizeD derivation
    ``size_d = min((range + ceil(ref.size_d/min_level)) * min_level, 255)``
    — the signed quantized-range delta that reproduces ``want``."""
    prev_dd = -(-ref_size_d // min_level)  # ceil
    if want >= 255:
        rd = max(0, -(-(want + 1) // min_level) - prev_dd)
    else:
        assert want % min_level == 0, (
            f"size_d {want} is not a multiple of min_level {min_level}: "
            f"not expressible as an inter/merge range delta"
        )
        rd = want // min_level - prev_dd
    got = min((rd + prev_dd) * min_level, 255)
    assert got == want or (want >= 255 and got == 255), (want, got)
    return rd


def patch_to_merge_pdu(
    patch: Patch,
    ref: Patch,
    override_2d: bool,
    geometry_bitdepth_3d: int,
    min_level: int = 1,
) -> MergePatchDataUnit:
    """Invert the merge-patch derivation: either the 2D or the 3D group
    is coded as deltas against the same-index reference patch."""
    max3d = 1 << geometry_bitdepth_3d
    if override_2d:
        assert patch.uv1 == ref.uv1 and patch.d1 == ref.d1
        return MergePatchDataUnit(
            override_2d_params_flag=True,
            pos_2d=(patch.uv0[0] - ref.uv0[0], patch.uv0[1] - ref.uv0[1]),
            delta_2d_size=(
                patch.size_uv0[0] - ref.size_uv0[0],
                patch.size_uv0[1] - ref.size_uv0[1],
            ),
        )
    assert patch.uv0 == ref.uv0 and patch.size_uv0 == ref.size_uv0
    if ref.projection_mode == 0:
        dd = patch.d1 // min_level - ref.d1 // min_level
    else:
        dd = (max3d - patch.d1) // min_level - (max3d - ref.d1) // min_level
    return MergePatchDataUnit(
        override_2d_params_flag=False,
        override_3d_params_flag=True,
        pos_3d_offset=(patch.uv1[0] - ref.uv1[0], patch.uv1[1] - ref.uv1[1]),
        pos_3d_offset_d=dd,
        pos_3d_range_d=_range_d_delta(patch.size_d, ref.size_d, min_level),
    )


def raw_patch_to_pdu(rp: RawPatch) -> RawPatchDataUnit:
    """Invert the raw-patch construction (framework extension)."""
    return RawPatchDataUnit(
        patch_in_auxiliary_video_flag=rp.in_aux_video,
        pos_2d=(rp.u0, rp.v0),
        size_2d_minus1=(rp.size_u0 - 1, rp.size_v0 - 1),
        pos_3d_offset_u=rp.u1,
        pos_3d_offset_v=rp.v1,
        pos_3d_offset_d=rp.d1,
        raw_points_minus1=rp.n_points - 1,
    )


def plr_modes_to_plrd(modes, plri):
    """Invert the PLR-data normalization (framework extension): a
    per-block mode list (-1 = absent) back to 8.3.7.9 plr_data.
    Uniform lists code patch-level; mixed lists need the block count
    above the plri threshold (the level flag is only coded there)."""
    from ..v3c.syntax import PlrData

    d = PlrData()
    if len(set(modes)) == 1:
        d.level_flag = True
        d.present_flag = modes[0] >= 0
        d.mode_minus1 = max(modes[0], 0)
    else:
        assert len(modes) > plri.block_threshold_per_patch_minus1 + 1, (
            "block-level PLR needs the block count above the threshold"
        )
        d.level_flag = False
        d.block_present_flag = [m >= 0 for m in modes]
        d.block_mode_minus1 = [max(m, 0) for m in modes]
    return d


def eom_patch_to_pdu(ep) -> EomPatchDataUnit:
    """Invert the EOM-patch construction (framework extension)."""
    return EomPatchDataUnit(
        patch_in_auxiliary_video_flag=ep.in_aux_video,
        pos_2d=(ep.u0, ep.v0),
        size_2d_minus1=(ep.size_u0 - 1, ep.size_v0 - 1),
        associated_patch_idx=list(ep.member_patches),
        points=list(ep.member_points),
    )


def concat_streams(streams: List[bytes]) -> bytes:
    """Concatenate single-GOF sample streams into one multi-GOF file.

    Re-frames every unit under the first stream's size precision; the
    decoder splits GOFs at each subsequent VPS (``reader.rs:672-700``).
    """
    from ..bitio import Bitstream
    from ..v3c.stream import SampleStreamV3CUnit

    sw = w3c.V3CSampleStreamWriter()
    for stream in streams:
        ssvu = SampleStreamV3CUnit.from_bitstream(Bitstream(stream))
        for unit in ssvu.units:
            sw.units.append(unit.data)
    return sw.getvalue()


def build_fixture_stream(
    frames: List[SyntheticFrame],
    geometry_bitdepth_3d: int = 10,
    qp: int = 0,
    lossless: bool = True,
    p_modes=None,
    ref_deltas=(1,),
    geo_smoothing_sei=None,
    attr_smoothing_sei=None,
    occ_synthesis_sei=None,
    suffix_sei=None,
    pos_min_d_quantizer: int = 0,
    multi_map_streams: bool = False,
    map1_absolute: bool = True,
    plr=None,
    size_quantizer=None,
    patch_precedence: bool = False,
    tiles=None,
    tile_ids=None,
    aux_tile_row_heights=None,
    pixel_interleave: bool = False,
    chroma422: bool = False,
    secondary_attrs=None,
    no_attributes: bool = False,
    aux_attr_bit_depth: int = 10,
    force_aux_videos: bool = False,
    vui=None,
    atlas_hash_sei=None,
    atlas_hash_tamper: bool = False,
) -> bytes:
    """Build a complete single-GOF V3C sample-stream file.

    ``p_modes`` (optional) maps a frame index to either the string
    ``"skip_tile"`` (the whole tile replicates the previous frame's patch
    list) or a per-patch mode list for a P-tile referencing the previous
    frame: ``"intra"``, ``("inter", ref_patch_idx)`` or
    ``("inter", ref_patch_idx, ref_index)``, ``"merge2d"``, ``"merge3d"``,
    or ``"skip"``. Frames not in the map are coded as I-tiles. All
    streams carry normal_axis_max_delta range deltas (framework
    extension — the reference rejects them on P-tiles). ``ref_deltas``
    gives the
    sps reference list's short-term AFOC deltas (entry j references the
    frame ``delta`` frames back); with more than one entry the default
    active ref count covers them all, so ``ref_index`` is coded.

    ``geo_smoothing_sei`` (optional) is a ``(grid_size, threshold)`` pair:
    a prefix GeometrySmoothing SEI (method 1) is attached before the first
    tile layer. ``attr_smoothing_sei`` (optional) is
    ``(grid_size, threshold_variation, threshold_difference)`` for a
    prefix AttributeSmoothing SEI on attribute 0.

    ``suffix_sei`` (optional) is ``(payload_type, payload_bytes)``: a
    suffix SEI NAL is emitted after the first tile layer (the decoder
    records-and-skips it; the reference panics, ``reader.rs:813-815``).

    ``pos_min_d_quantizer`` codes depth offsets in units of
    ``min_level = 1 << q`` (patch d1 values must be exact multiples for
    the roundtrip to be lossless).

    ``multi_map_streams`` (framework extension — the reference rejects
    the VPS flag, ``reader.rs:278-283``) codes each map's geometry and
    attribute in its OWN video sub-stream (GVD/AVD units with
    map_index); needs two maps. ``map1_absolute=False`` additionally
    codes the D1 geometry as deltas against D0
    (``map_absolute_coding_enable_flag[1] = 0``).

    ``plr`` (framework extension — the reference panics,
    ``reader.rs:1082``) is a ``(modes_table, surface_thickness)`` pair
    for single-map PLR streams: ``modes_table`` lists (interpolate,
    filling, minimum_depth, neighbour_minus1) tuples; each patch's
    ``plr_modes`` (per-block mode list, -1 = absent, None = all
    absent) is coded as 8.3.7.9 plr_data.

    ``size_quantizer`` (framework extension — the reference asserts the
    ASPS flag false, ``reader.rs:1052``) is the ath's (log2 qx, log2 qy)
    pair: patch sizes are coded from ``patch.size_2d_in_pixel`` in
    quantized pixel units (I-tiles only; the parsers gate P-tiles).

    ``tiles`` (framework extension — atlas frame partitioning, which
    the reference asserts away at ``reader.rs:1266-1270``): either an
    explicit :class:`AtlasFrameTileInformation` or an ``(n_cols,
    n_rows)`` uniform-tile shorthand (partition size must be a 64-px
    multiple). Each frame's patches are split per tile by their canvas
    block footprint (every patch must lie inside exactly one tile) and
    coded as one I-tile layer per tile, tile-local coordinates.
    ``tile_ids``: optional explicit id list — codes the AFTI's
    signalled-tile-id path (ids in tile-index order).

    ``secondary_attrs`` (framework extension — the reference reads only
    attribute 0): a list of ``(type_id, dim, planes)`` triples, each
    coded as its own AVD sub-stream family with
    ``vuh_attribute_index = 1 + list position``. ``planes`` mirrors
    ``sf.attr_planes`` (per synthetic frame, per map, ``[y, u, v]``);
    pass None for deterministic pseudo-random content (flat chroma
    when ``dim == 1``).

    ``no_attributes`` (framework extension — the reference asserts
    exactly one attribute, ``decoder.rs:133``): a geometry-only stream
    (``vps_attribute_video_present_flag = 0``, no AVD units); the
    synthetic frames' attribute planes are simply not coded.
    """
    f0 = frames[0]
    width, height = f0.meta.width, f0.meta.height
    res = f0.occupancy_resolution
    map_count = f0.map_count
    log2_block = res.bit_length() - 1
    assert 1 << log2_block == res

    pix_il_planes = None
    if pixel_interleave:
        # single-map pixel-interleaved geometry (framework extension):
        # fold the authored D0/D1 into ONE checkerboard plane per
        # frame, then REPLACE the frames' geometry with the planes the
        # DEFINED derivation reconstructs — the oracle expectation
        # machinery then states the decoder contract exactly
        from ..reconstruction.pixel_interleave import (
            deinterleave_geometry,
            upsample_occupancy_full,
        )

        assert map_count == 2, "pixel-interleave fixtures author 2 maps"
        assert all(
            not f.meta.raw_patches and not f.meta.eom_patches
            for f in frames
        ) and plr is None, "pixel deinterleave excludes raw/EOM/PLR"
        pix_il_planes = []
        for f in frames:
            h, w = f.geo_planes[0].shape
            par = (
                np.arange(h, dtype=np.int64)[:, None]
                + np.arange(w, dtype=np.int64)[None, :]
            ) & 1
            v = np.where(
                par == 0, f.geo_planes[0], f.geo_planes[1]
            ).astype(np.uint16)
            pix_il_planes.append(v)
            occ_c = upsample_occupancy_full(
                f.occ_plane, f.occupancy_precision
            )
            d0, d1 = deinterleave_geometry(v, occ_c)
            f.geo_planes = [d0, d1]
        map_count = 1

    vps = V3CParameterSet()
    vps.frame_width = width
    vps.frame_height = height
    vps.map_count_minus1 = map_count - 1
    vps.map_absolute_coding_enable_flag = [True] * map_count
    vps.map_predictor_index_diff = [False] * map_count
    if multi_map_streams:
        assert map_count >= 2, "multi-map-stream fixtures need >= two maps"
        vps.multiple_map_streams_present_flag = True
        vps.map_absolute_coding_enable_flag[1] = map1_absolute
        assert map1_absolute or map_count == 2, (
            "delta-coded map 1 with >2 maps is gated by the decoder "
            "(layer comparands need absolute depths)"
        )
    else:
        assert map1_absolute, "delta D1 coding needs multi_map_streams"
    vps.occupancy_video_present_flag = True
    vps.geometry_video_present_flag = True
    vps.attribute_video_present_flag = not no_attributes
    # auxiliary raw-patch videos (framework extension)
    has_aux = any(
        rp.in_aux_video for f in frames for rp in f.meta.raw_patches
    ) or any(ep.in_aux_video for f in frames for ep in f.meta.eom_patches
    ) or force_aux_videos  # aux videos with zero aux-flagged patches:
    # legal stream shape; the decoder must ignore the unconsumed planes
    vps.auxiliary_video_present_flag = has_aux
    vps.occupancy_information = OccupancyInformation(
        occupancy_codec_id=1, occupancy_2d_bitdepth_minus1=7
    )
    vps.geometry_information = GeometryInformation(
        geometry_codec_id=1,
        geometry_2d_bitdepth_minus1=9,
        geometry_3d_coordinates_bitdepth_minus1=geometry_bitdepth_3d - 1,
        auxiliary_geometry_codec_id=1 if has_aux else 0,
    )
    assert not (no_attributes and (secondary_attrs or chroma422)), (
        "no_attributes codes no AVD units at all"
    )
    n_attrs = 0 if no_attributes else 1 + len(secondary_attrs or [])
    sec_types = [sa[0] for sa in (secondary_attrs or [])]
    sec_dims = [sa[1] for sa in (secondary_attrs or [])]
    vps.attribute_information = AttributeInformation(
        attribute_count=n_attrs,
        attribute_type_id=[0] + sec_types,
        attribute_codec_id=[1] * n_attrs,
        auxiliary_attribute_codec_id=[1 if has_aux else 0] * n_attrs,
        attribute_map_absolute_coding_persistence_flag=[True] * n_attrs,
        attribute_dimension_minus1=[2] + [d - 1 for d in sec_dims],
        attribute_dimension_partitions_minus1=[0] * n_attrs,
        attribute_partition_channels_minus1=[[2]] + [[d - 1] for d in sec_dims],
        attribute_2d_bitdepth_minus1=[9] * n_attrs,
        attribute_msb_align_flag=[False] * n_attrs,
    )

    asps = AtlasSequenceParameterSet()
    asps.frame_width = width
    asps.frame_height = height
    asps.geometry_3d_bitdepth_minus1 = geometry_bitdepth_3d - 1
    asps.geometry_2d_bitdepth_minus1 = 9
    asps.log2_patch_packing_block_size = log2_block
    # orientations beyond DEFAULT/SWAP need the 3-bit coding
    # (``reader.rs:1908-1913``); MROT270 (=8) is not bitstream-expressible
    asps.use_eight_orientations_flag = any(
        int(p.patch_orientation) > 1
        for f in frames
        for p in f.meta.patches
    )
    assert all(
        int(p.patch_orientation) <= 7 for f in frames for p in f.meta.patches
    ), "orientation 8 (MROT270) cannot be coded in the 3-bit PDU field"
    # 45-degree views (framework extension): widen the projection-id
    # field to the full 18-view table when any patch uses one
    if any(
        p.axis_of_additional_plane != 0
        for f in frames for p in f.meta.patches
    ):
        asps.extended_projection_enabled_flag = True
        asps.max_number_projections_minus1 = 17
    if vui is not None:
        # F.2.1 VUI parameters (framework extension — the reference
        # panics on the present flag, reader.rs:1089)
        asps.vui_parameters_present_flag = True
        asps.vui_parameters = vui
    asps.map_count_minus1 = map_count - 1
    asps.pixel_deinterleaving_flag = pixel_interleave
    asps.normal_axis_limits_quantization_enabled_flag = True
    # P fixtures carry NAMD too now that the inter/merge parse and
    # derivation consume ipdu/mpdu_3d_range_d (framework extension —
    # the reference rejects the combination, ``reader.rs:1963,2025``)
    asps.normal_axis_max_delta_value_enabled_flag = True
    n_ltr = 0
    if p_modes is not None:
        # one sps ref list: entry j is either short-term (int delta:
        # references the frame `delta` back) or long-term (("lt", afoc):
        # references the frame with that absolute AFOC lsb)
        st_flags, st_deltas, lt_afocs = [], [], []
        for d in ref_deltas:
            if isinstance(d, tuple) and d[0] == "lt":
                st_flags.append(False)
                lt_afocs.append(d[1])
            else:
                st_flags.append(True)
                st_deltas.append(d)
        n_ltr = len(lt_afocs)
        asps.long_term_ref_atlas_frames_flag = n_ltr > 0
        asps.num_ref_atlas_frame_lists_in_asps = 1
        asps.ref_list_struct = [
            RefListStruct(
                num_ref_entries=len(ref_deltas),
                abs_delta_afoc_st=st_deltas,
                afoc_lsb_lt=lt_afocs,
                st_ref_atlas_frame_flag=st_flags,
                strpf_entry_sign_flag=[True] * len(st_deltas),
            )
        ]

    # raw patches (framework extension): explicit AFPS offset-bitcount
    # mode with the widest expressible count (the 3-bit field caps
    # minus1 at 7 → 8-bit offsets; the implicit derivation wraps to an
    # unreadable 256-bit field when the 2D/3D bitdepths are equal)
    has_raw = any(f.meta.raw_patches for f in frames)
    raw_bitcount_minus1 = 7
    if has_raw or force_aux_videos:
        # the ASPS auxiliary flag is only codeable under raw/EOM enable
        # (23090-5 field order), so a forced aux video rides an enabled-
        # but-unused raw patch mode
        asps.raw_patch_enabled_flag = True
    if has_raw:
        assert all(
            max(rp.u1, rp.v1, rp.d1) < (1 << (raw_bitcount_minus1 + 1))
            for f in frames
            for rp in f.meta.raw_patches
        ), "raw 3D offsets exceed the 8-bit explicit coding range"
    if has_aux:
        # auxiliary raw-patch videos: ASPS flag + AFTI declaration (set
        # on the single-tile AFTI below); every frame needs aux planes
        # so the aux video has one frame per atlas frame
        from .synthetic import ensure_aux_planes

        asps.auxiliary_video_enabled_flag = True
        for f in frames:
            ensure_aux_planes(f)
        aux_shapes = {f.aux_geo_plane.shape for f in frames} | {
            f.aux_attr_planes[0].shape for f in frames
        }
        assert len(aux_shapes) == 1, (
            f"aux planes must share one shape, got {aux_shapes}"
        )
    # EOM patches (framework extension). Single-map streams code the
    # fixed codeword bit count the decoder validates against
    if any(f.meta.eom_patches for f in frames):
        asps.eom_patch_enabled_flag = True
        if map_count == 1:
            max_code = max(
                (int(f.occ_plane.max()) - 1 for f in frames), default=1
            )
            asps.eom_fix_bit_count_minus1 = max(1, max_code.bit_length()) - 1

    if size_quantizer is not None:
        # quantized patch sizes: I-tiles only, no PLR/EOM combos (the
        # parsers gate those — keep fixtures inside the envelope)
        assert p_modes is None, "quantized sizes are I-tile-only"
        assert plr is None and not asps.eom_patch_enabled_flag
        asps.patch_size_quantizer_present_flag = True

    # decoding-order patch precedence (framework extension — the
    # reference asserts the flag false, ``codec.rs:340-347``)
    asps.patch_precedence_order_flag = patch_precedence

    plri = None
    if plr is not None:
        from ..v3c.syntax import PlrInformation

        modes_table, surface_thickness = plr
        assert map_count == 1, "PLR fixtures are single-map"
        asps.plr_enabled_flag = True
        plri = PlrInformation(
            map_present_flag=True,
            interpolate_flag=[bool(m[0]) for m in modes_table],
            filling_flag=[bool(m[1]) for m in modes_table],
            minimum_depth_flag=[bool(m[2]) for m in modes_table],
            neighbour_minus1=[int(m[3]) for m in modes_table],
            block_threshold_per_patch_minus1=0,
        )
        asps.plr_information = [plri]
        asps.extension_flag = True
        asps.vpcc_extension_flag = True
        asps.vpcc_extension.surface_thickness_minus1 = surface_thickness - 1

    afps = AtlasFrameParameterSet()
    afps.raw_3d_offset_bitcount_explicit_mode_flag = has_raw
    if tiles is not None:
        # atlas frame partitioning (framework extension): one I-tile
        # layer per tile per frame, patches in tile-local coordinates
        assert p_modes is None, "multi-tile fixtures are I-tile-only"
        if isinstance(tiles, AtlasFrameTileInformation):
            afti = tiles
        else:
            n_cols, n_rows = tiles
            assert width % (n_cols * 64) == 0, (width, n_cols)
            assert height % (n_rows * 64) == 0, (height, n_rows)
            afti = AtlasFrameTileInformation(
                single_tile_in_atlas_frame_flag=False,
                uniform_partition_spacing_flag=True,
                partition_cols_width_minus1=width // n_cols // 64 - 1,
                partition_rows_height_minus1=height // n_rows // 64 - 1,
                single_partition_per_tile_flag=True,
                num_tiles_in_atlas_frame_minus1=n_cols * n_rows - 1,
            )
        if tile_ids is not None:
            assert len(set(tile_ids)) == afti.tile_count()
            afti.signalled_tile_id_flag = True
            afti.signalled_tile_id_length_minus1 = max(
                max(tile_ids).bit_length(), 1
            ) - 1
            afti.tile_id = list(tile_ids)
        afps.atlas_frame_tile_information = afti
    if has_aux:
        ti = afps.atlas_frame_tile_information
        ah, aw = frames[0].aux_geo_plane.shape
        # declared in units of 64 samples (23090-5 AFTI aux fields);
        # one aux band per tile, stacked vertically in the aux video
        ti.auxiliary_video_tile_row_width_minus1 = -(-aw // 64) - 1
        if aux_tile_row_heights is not None:
            assert len(aux_tile_row_heights) == ti.tile_count(), (
                f"{len(aux_tile_row_heights)} aux band heights for "
                f"{ti.tile_count()} tiles"
            )
            ti.auxiliary_video_tile_row_height = list(aux_tile_row_heights)
        else:
            # default: one band covering the whole aux plane, owned by
            # tile 0 (the single-tile case, and the multi-tile case
            # where only tile 0 carries aux patches)
            ti.auxiliary_video_tile_row_height = [-(-ah // 64)] + [0] * (
                ti.tile_count() - 1
            )
    # LoD-scaled patches (framework extension; the reference
    # `unimplemented!`s on this AFPS flag, ``reader.rs:1915``)
    afps.lod_mode_enable_flag = any(
        p.level_of_detail != (1, 1) for f in frames for p in f.meta.patches
    )
    if p_modes is not None:
        # default active ref count covers the whole list, so multi-entry
        # lists code ref_index on inter/merge units
        afps.num_ref_idx_default_active_minus1 = len(ref_deltas) - 1

    nalus = [
        w3c.wrap_nal_unit(NalUnitType.ASPS, w3c.write_asps(asps)),
        w3c.wrap_nal_unit(NalUnitType.AFPS, w3c.write_afps(afps, asps)),
    ]
    if atlas_hash_sei is not None:
        # decoded-atlas-hash suffix SEI per frame (H.20.2.8; framework
        # extension — the reference skips hash SEI, lib.rs:100). The
        # hashes are computed from the AUTHORED metadata; the decoder
        # recomputes them from its parsed + derived state
        # (atlas/atlas_hash.py), so any atlas-decode divergence fails.
        assert tiles is None and p_modes is None, (
            "hash-SEI fixtures are single-tile I-frame streams (the "
            "authored meta is canvas-level; tiled/P metas are derived)"
        )
        from ..atlas import atlas_hash as _ah

        _daih_type = 0 if atlas_hash_sei is True else int(atlas_hash_sei)
        _daih_hl = w3c.write_asps(asps) + w3c.write_afps(afps, asps)
        _daih_prec = width // frames[0].occ_plane.shape[1]
    # A prefix SEI attaches to the FOLLOWING tile layer and a later
    # prefix SEI overwrites a pending one (reader.rs:810-811), so
    # multiple requested SEIs go before successive tile layers.
    sei_nalus = []
    if geo_smoothing_sei is not None:
        grid_size, threshold = geo_smoothing_sei
        sei_nalus.append(
            w3c.wrap_nal_unit(
                NalUnitType.PREFIX_ESEI,
                w3c.write_sei_geometry_smoothing(
                    instances=((0, 1, grid_size - 2, threshold),)
                ),
            )
        )
    if attr_smoothing_sei is not None:
        # (grid, thr_var, thr_diff) targets attribute 0; 4-tuples
        # (attr_idx, grid, thr_var, thr_diff) — possibly a list of
        # them — target explicit attributes (framework extension)
        insts = attr_smoothing_sei
        if not isinstance(insts, list):
            insts = [insts]
        insts = [
            (0,) + tuple(t) if len(t) == 3 else tuple(t) for t in insts
        ]
        sei_nalus.append(
            w3c.wrap_nal_unit(
                NalUnitType.PREFIX_ESEI,
                w3c.write_sei_attribute_smoothing(
                    instances=tuple(
                        (aidx, 0, 1, grid - 2, 0, thr_var, thr_diff)
                        for (aidx, grid, thr_var, thr_diff) in insts
                    )
                ),
            )
        )
    if occ_synthesis_sei is not None:
        thr, passes, fsize = occ_synthesis_sei
        sei_nalus.append(
            w3c.wrap_nal_unit(
                NalUnitType.PREFIX_ESEI,
                w3c.write_sei_occupancy_synthesis(
                    instances=((0, 1, thr, passes, fsize),)
                ),
            )
        )
    assert len(sei_nalus) <= len(frames), "more SEIs than tile layers"
    sei_by_frame = dict(enumerate(sei_nalus))
    for fi, sf in enumerate(frames):
        if fi in sei_by_frame:
            nalus.append(sei_by_frame[fi])
        spec = (p_modes or {}).get(sf.meta.frame_index)
        if tiles is not None:
            # one tile layer per AFTI tile, patches in tile-local
            # coordinates (I-tiles only; asserted above)
            tile_views = _split_patches_by_tile(sf.meta, afti, width, height)
        else:
            tile_views = [
                (0, sf.meta.patches, sf.meta.raw_patches,
                 sf.meta.eom_patches)
            ]
        # per-tile layer authoring (a single iteration unless ``tiles``)
        for tile_coded_id, reg_patches, raw_list, eom_list in tile_views:
            ath = AtlasTileHeader()
            ath.id = tile_coded_id
            ath.atlas_frame_order_count_lsb = sf.meta.frame_index
            ath.pos_min_d_quantizer = pos_min_d_quantizer
            if size_quantizer is not None:
                ath.patch_size_info_quantizer = tuple(size_quantizer)
            if has_raw:
                ath.raw_3d_offset_axis_bitcount_minus1 = raw_bitcount_minus1
            ath.ref_atlas_frame_list_sps_flag = p_modes is not None
            # one flag per long-term entry (parsed for every tile type)
            ath.additional_afoc_lsb_present_flag = [False] * n_ltr
            atl = AtlasTileLayer(header=ath)
            if spec is None:
                ath.tile_type = TileType.I
                nal_type = NalUnitType.IDR_N_LP
                for patch in reg_patches:
                    pdu = patch_to_pdu(
                        patch, geometry_bitdepth_3d,
                        min_level=1 << pos_min_d_quantizer,
                        size_quantizer=size_quantizer,
                    )
                    if plri is not None:
                        blocks = patch.size_uv0[0] * patch.size_uv0[1]
                        pdu.plr_data = [
                            plr_modes_to_plrd(
                                patch.plr_modes
                                if patch.plr_modes is not None
                                else [-1] * blocks,
                                plri,
                            )
                        ]
                    atl.patch_information_data.append(
                        PatchInformationData(
                            patch_mode=int(PatchModeITile.INTRA),
                            patch_data_unit=pdu,
                        )
                    )
            elif spec == "skip_tile":
                ath.tile_type = TileType.SKIP
                nal_type = NalUnitType.TRAIL_R
            else:
                ath.tile_type = TileType.P
                nal_type = NalUnitType.TRAIL_R

                def ref_meta_for(ridx):
                    d = ref_deltas[ridx]
                    if isinstance(d, tuple) and d[0] == "lt":
                        return frames[d[1]].meta  # fixture AFOC == frame index
                    return frames[fi - d].meta

                ref_meta = ref_meta_for(0)
                pred_index = 0
                assert len(spec) == len(reg_patches)
                for i, (patch, mode) in enumerate(zip(reg_patches, spec)):
                    if mode == "intra":
                        pid = PatchInformationData(
                            patch_mode=int(PatchModePTile.INTRA),
                            patch_data_unit=patch_to_pdu(
                                patch, geometry_bitdepth_3d,
                                min_level=1 << pos_min_d_quantizer,
                            ),
                        )
                    elif isinstance(mode, tuple) and mode[0] == "inter":
                        rpi = mode[1]
                        ridx = mode[2] if len(mode) > 2 else 0
                        pid = PatchInformationData(
                            patch_mode=int(PatchModePTile.INTER),
                            patch_data_unit=patch_to_inter_pdu(
                                patch, ref_meta_for(ridx).patches[rpi], rpi,
                                pred_index, geometry_bitdepth_3d,
                                min_level=1 << pos_min_d_quantizer,
                                ref_index=ridx,
                            ),
                        )
                        pred_index = rpi + 1
                    elif mode in ("merge2d", "merge3d"):
                        pid = PatchInformationData(
                            patch_mode=int(PatchModePTile.MERGE),
                            patch_data_unit=patch_to_merge_pdu(
                                patch, ref_meta.patches[i], mode == "merge2d",
                                geometry_bitdepth_3d,
                                min_level=1 << pos_min_d_quantizer,
                            ),
                        )
                    elif mode == "skip":
                        assert patch == ref_meta.patches[i], "skip needs identity"
                        pid = PatchInformationData(
                            patch_mode=int(PatchModePTile.SKIP),
                            patch_data_unit=SkipPatchDataUnit(),
                        )
                    else:
                        raise ValueError(f"unknown p-mode {mode!r}")
                    if plri is not None:
                        # P-tile PLR (framework extension): intra PDUs
                        # carry full plrd; inter/merge code LEVEL-mode
                        # only (the parse-time accumulator block count
                        # need not match the derived footprint, and a
                        # patch-level mode is count-independent)
                        pdu2 = pid.patch_data_unit
                        modes = patch.plr_modes
                        if mode == "intra":
                            bc = patch.size_uv0[0] * patch.size_uv0[1]
                            pdu2.plr_data = [plr_modes_to_plrd(
                                modes if modes is not None else [-1] * bc,
                                plri,
                            )]
                        elif isinstance(mode, tuple) and mode[0] == "inter":
                            assert modes is None or len(set(modes)) == 1, (
                                "inter-PDU PLR fixtures code level mode"
                            )
                            pdu2.plr_data = [plr_modes_to_plrd(
                                [modes[0] if modes else -1], plri
                            )]
                        elif mode == "merge2d":
                            ref_modes = ref_meta.patches[i].plr_modes
                            if modes != ref_modes:
                                assert modes is None or len(set(modes)) == 1
                                pdu2.override_plr_flag = True
                                pdu2.plr_data = [plr_modes_to_plrd(
                                    [modes[0] if modes else -1], plri
                                )]
                        elif mode in ("merge3d", "skip"):
                            assert modes == ref_meta.patches[i].plr_modes, (
                                f"{mode} inherits the reference PLR modes"
                            )
                    atl.patch_information_data.append(pid)
            if ath.tile_type != TileType.SKIP:
                # raw patches follow the regular patches (SKIP tiles
                # replicate the reference frame's raw list implicitly)
                raw_mode = (
                    PatchModeITile.RAW
                    if ath.tile_type == TileType.I
                    else PatchModePTile.RAW
                )
                for rp in raw_list:
                    atl.patch_information_data.append(
                        PatchInformationData(
                            patch_mode=int(raw_mode),
                            patch_data_unit=raw_patch_to_pdu(rp),
                        )
                    )
                eom_mode = (
                    PatchModeITile.EOM
                    if ath.tile_type == TileType.I
                    else PatchModePTile.EOM
                )
                for ep in eom_list:
                    atl.patch_information_data.append(
                        PatchInformationData(
                            patch_mode=int(eom_mode),
                            patch_data_unit=eom_patch_to_pdu(ep),
                        )
                    )
            nalus.append(
                w3c.wrap_nal_unit(
                    nal_type,
                    w3c.write_atlas_tile_layer(atl, asps, afps, nal_type),
                )
            )
        if atlas_hash_sei is not None:
            from ..v3c.syntax import SeiDecodedAtlasInformationHash

            _m = [sf.meta]
            _b2p = _ah.hash_bytes(
                _ah.frame_b2p_byte_string(
                    _m, sf.occ_plane, res, _daih_prec
                ),
                _daih_type,
            )
            daih = SeiDecodedAtlasInformationHash(
                hash_type=_daih_type,
                high_level_present=True,
                atlas_present=True,
                b2p_present=True,
                tiles_present=True,
                tiles_b2p_present=True,
                high_level_hash=_ah.hash_bytes(_daih_hl, _daih_type),
                atlas_hash=_ah.hash_bytes(
                    _ah.frame_atlas_byte_string(_m), _daih_type
                ),
                b2p_hash=_b2p,
                tile_ids=[0],
                tiles_hash=[_ah.hash_bytes(
                    _ah.tile_byte_string(sf.meta), _daih_type
                )],
                tiles_b2p_hash=[_b2p],
            )
            if atlas_hash_tamper and fi == 0:
                daih.atlas_hash = bytes(
                    b ^ (0xFF if i == 0 else 0)
                    for i, b in enumerate(daih.atlas_hash)
                )
            nalus.append(
                w3c.wrap_nal_unit(
                    NalUnitType.SUFFIX_NSEI, w3c.write_sei_daih(daih)
                )
            )
        if fi == 0 and suffix_sei is not None:
            ptype, payload = suffix_sei
            nalus.append(
                w3c.wrap_nal_unit(
                    NalUnitType.SUFFIX_ESEI, w3c.write_sei_raw(ptype, payload)
                )
            )

    # --- video sub-streams (lossless HEVC) -------------------------------
    occ_h, occ_w = frames[0].occ_plane.shape
    occ_video = [
        [
            sf.occ_plane.astype(np.uint8),
            np.zeros((occ_h // 2, occ_w // 2), np.uint8),
            np.zeros((occ_h // 2, occ_w // 2), np.uint8),
        ]
        for sf in frames
    ]
    ch, cw = height // 2, width // 2

    def geo_frame(sf, m):
        plane = sf.geo_planes[m]
        if m == 1 and not map1_absolute:
            # delta D1 coding: samples carry (d1 - d0) premultiplied by
            # the same MSB alignment as the absolute planes
            plane = (plane - sf.geo_planes[0]).astype(np.uint16)
        return [
            plane,
            np.zeros((ch, cw), np.uint16),
            np.zeros((ch, cw), np.uint16),
        ]

    # chroma format auto-detects from the plane shapes: full-res chroma in
    # the synthetic frames -> a 4:4:4-coded attribute sub-stream
    attr_444 = (not no_attributes) and (
        frames[0].attr_planes[0][1].shape == frames[0].attr_planes[0][0].shape
    )
    if chroma422:
        # 4:2:2 coding of a 4:2:0-authored scene (framework extension):
        # row-double the chroma to (h, w/2). The decoder's host
        # column-doubling then reconstructs exactly the 4:2:0 sampling,
        # so the decode must equal the 4:2:0-coded stream's
        assert not attr_444, "chroma422 fixtures author 4:2:0 frames"

        def to_422(planes):
            y, u, v = planes
            return [y, np.repeat(u, 2, axis=0), np.repeat(v, 2, axis=0)]

    if multi_map_streams:
        geo_annexbs = [
            encode_yuv420(
                [geo_frame(sf, m) for sf in frames],
                bit_depth=10, lossless=lossless, qp=qp,
            )
            for m in range(map_count)
        ]
        attr_annexbs = [] if no_attributes else [
            encode_yuv420(
                [
                    to_422(sf.attr_planes[m]) if chroma422
                    else sf.attr_planes[m]
                    for sf in frames
                ],
                bit_depth=10, lossless=lossless, qp=qp, chroma444=attr_444,
                chroma422=chroma422,
            )
            for m in range(map_count)
        ]
    else:
        if pixel_interleave:
            geo_video = [
                [v, np.zeros((ch, cw), np.uint16),
                 np.zeros((ch, cw), np.uint16)]
                for v in pix_il_planes
            ]
            attr_video = [sf.attr_planes[0] for sf in frames]
        else:
            geo_video = [
                geo_frame(sf, m) for sf in frames for m in range(map_count)
            ]
            attr_video = [
                sf.attr_planes[m] for sf in frames for m in range(map_count)
            ]
        if chroma422:
            attr_video = [to_422(p) for p in attr_video]
        geo_annexbs = [
            encode_yuv420(geo_video, bit_depth=10, lossless=lossless, qp=qp)
        ]
        attr_annexbs = [] if no_attributes else [
            encode_yuv420(
                attr_video, bit_depth=10, lossless=lossless, qp=qp,
                chroma444=attr_444, chroma422=chroma422,
            )
        ]

    sec_annexb_sets = []
    if secondary_attrs:
        for k, spec in enumerate(secondary_attrs):
            type_id, dim, planes = spec[:3]
            if planes is None:
                rng = np.random.default_rng(9000 + k)

                def gen():
                    y = rng.integers(0, 1024, (height, width)).astype(np.uint16)
                    if dim == 1:
                        u = np.full((ch, cw), 512, np.uint16)
                        v = u.copy()
                    else:
                        u = rng.integers(0, 1024, (ch, cw)).astype(np.uint16)
                        v = rng.integers(0, 1024, (ch, cw)).astype(np.uint16)
                    return [y, u, v]

                planes = [
                    [gen() for _ in range(map_count)] for _ in frames
                ]
            # coding format is shape-driven, like the primary: full-res
            # chroma -> 4:4:4, (h, w/2) -> 4:2:2 (author 4:2:0 and
            # row-double, cf. ``to_422``), (h/2, w/2) -> 4:2:0
            y0, u0 = planes[0][0][0], planes[0][0][1]
            sec_444 = u0.shape == y0.shape
            sec_422 = u0.shape == (y0.shape[0], y0.shape[1] // 2)
            if multi_map_streams:
                sec_annexb_sets.append([
                    encode_yuv420(
                        [planes[fi][m] for fi in range(len(frames))],
                        bit_depth=10, lossless=lossless, qp=qp,
                        chroma444=sec_444, chroma422=sec_422,
                    )
                    for m in range(map_count)
                ])
            else:
                # pixel-interleaved streams code ONE frame per frame
                # (map 0), like the primary
                maps = 1 if pixel_interleave else map_count
                sec_annexb_sets.append([
                    encode_yuv420(
                        [
                            planes[fi][m]
                            for fi in range(len(frames))
                            for m in range(maps)
                        ],
                        bit_depth=10, lossless=lossless, qp=qp,
                        chroma444=sec_444, chroma422=sec_422,
                    )
                ])

    occ_annexb = encode_yuv420(occ_video, bit_depth=8, lossless=lossless, qp=qp)

    aux_geo_annexb = aux_attr_annexb = None
    sec_aux_annexbs = []
    if has_aux:
        ach, acw = frames[0].aux_attr_planes[1].shape
        aux_geo_annexb = encode_yuv420(
            [[f.aux_geo_plane,
              np.zeros((ach, acw), np.uint16),
              np.zeros((ach, acw), np.uint16)] for f in frames],
            bit_depth=10, lossless=lossless, qp=qp,
        )
        # aux_attr_bit_depth != 10 authors a format MISMATCH with the
        # regular attribute video (the decoder must gate it cleanly)
        aux_attr_annexb = encode_yuv420(
            [f.aux_attr_planes for f in frames],
            bit_depth=aux_attr_bit_depth, lossless=lossless, qp=qp,
        )
        # one auxiliary video per SECONDARY attribute family too (the
        # decode samples raw/EOM tail channels from it). 4-tuples
        # supply explicit per-frame [y, u, v] aux planes; otherwise
        # deterministic pseudo-random content at the primary aux size.
        ah = frames[0].aux_attr_planes[0].shape[0]
        aw = frames[0].aux_attr_planes[0].shape[1]
        for k, spec in enumerate(secondary_attrs or []):
            aux_planes = spec[3] if len(spec) > 3 else None
            if aux_planes is None:
                rng = np.random.default_rng(9500 + k)
                aux_planes = [
                    [rng.integers(0, 1024, (ah, aw)).astype(np.uint16),
                     rng.integers(0, 1024, (ach, acw)).astype(np.uint16),
                     rng.integers(0, 1024, (ach, acw)).astype(np.uint16)]
                    for _ in frames
                ]
            sec_aux_annexbs.append(encode_yuv420(
                aux_planes, bit_depth=10, lossless=lossless, qp=qp,
            ))

    sw = w3c.V3CSampleStreamWriter()
    sw.add_unit(w3c.v3c_unit_header(V3CUnitType.VPS), w3c.write_vps(vps))
    sw.add_unit(w3c.v3c_unit_header(V3CUnitType.AD), w3c.build_nal_sample_stream(nalus))
    sw.add_unit(
        w3c.v3c_unit_header(V3CUnitType.OVD),
        w3c.annexb_to_length_prefixed(occ_annexb),
    )
    for m, annexb in enumerate(geo_annexbs):
        sw.add_unit(
            w3c.v3c_unit_header(
                V3CUnitType.GVD, map_index=m if multi_map_streams else 0
            ),
            w3c.annexb_to_length_prefixed(annexb),
        )
    for m, annexb in enumerate(attr_annexbs):
        sw.add_unit(
            w3c.v3c_unit_header(
                V3CUnitType.AVD, map_index=m if multi_map_streams else 0
            ),
            w3c.annexb_to_length_prefixed(annexb),
        )
    for k, annexbs in enumerate(sec_annexb_sets, start=1):
        for m, annexb in enumerate(annexbs):
            sw.add_unit(
                w3c.v3c_unit_header(
                    V3CUnitType.AVD,
                    map_index=m if multi_map_streams else 0,
                    attribute_index=k,
                ),
                w3c.annexb_to_length_prefixed(annexb),
            )
    if aux_geo_annexb is not None:
        sw.add_unit(
            w3c.v3c_unit_header(V3CUnitType.GVD, auxiliary_video_flag=True),
            w3c.annexb_to_length_prefixed(aux_geo_annexb),
        )
        sw.add_unit(
            w3c.v3c_unit_header(V3CUnitType.AVD, auxiliary_video_flag=True),
            w3c.annexb_to_length_prefixed(aux_attr_annexb),
        )
        for k, annexb in enumerate(sec_aux_annexbs, start=1):
            sw.add_unit(
                w3c.v3c_unit_header(
                    V3CUnitType.AVD, auxiliary_video_flag=True,
                    attribute_index=k,
                ),
                w3c.annexb_to_length_prefixed(annexb),
            )
    return sw.getvalue()
