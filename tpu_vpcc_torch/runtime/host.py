"""Host half of the decoder pipeline: the decoded GOF, the SEI-derived
configurations, the numpy oracle decode and the host tails.

Copied from ``tpu_vpcc.runtime.pipeline`` (the jax-free functions the
port's pipeline runs around its device dispatch): :class:`GofData` and
:class:`SecAttr`, the ``extract_*`` SEI readers, the oracle decode
(:func:`_reconstruct_gof_oracle`), the raw/EOM/PLR tails
(``_append_*_points``), and the emission helpers of the device path
(:func:`_emit_pointset`, the map-pair views of M-map GOFs, the colour
mode).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterator, List, Optional

import numpy as np

from ..atlas.patches import FrameMeta
from ..reconstruction.pointset import PointSet3
from ..v3c.context import Context
from ..v3c.syntax import UnsupportedFeature


@dataclass
class GofData:
    """Decoded inputs for one GOF, ready for reconstruction."""

    metas: List[FrameMeta]
    occ_planes: np.ndarray  # (F, H/prec, W/prec) uint8
    geo_planes: List[np.ndarray]  # map-interleaved Y planes
    attr_planes: List[List[np.ndarray]]  # per video frame [y, u, v]
    map_count: int
    occupancy_precision: int
    occupancy_resolution: int
    absolute_d1: bool
    geo_shift: int
    attribute_count: int
    frame_count: int
    # decoded attribute color format: chroma subsampling shift (1 = 4:2:0,
    # 0 = 4:4:4) and whether the samples are RGB (GBR 4:4:4 content) — the
    # reference branches on ``color_format()`` (``src/decoder.rs:300-305``)
    attr_chroma_shift: int = 1
    attr_is_rgb444: bool = False
    # grid geometry smoothing (SmoothingConfig) when the SEI is present
    # AND apply_geo_smoothing_type is set; None otherwise
    geo_smoothing: Optional[object] = None
    # grid attribute smoothing (AttrSmoothingConfig), same contract
    attr_smoothing: Optional[object] = None
    # When tiled, geo/attr planes are block-tiled (n_blocks, t, t) straight
    # from the native decoder copy (luma t = tile_size, chroma t/2);
    # occupancy stays raw (its size defines occupancy_precision).
    tiled: bool = False
    # tile edge of the tiled planes: the packing block size normally, or
    # the occupancy precision when the cell-granular path is active
    tile_size: int = 0
    # cell-granular dispatch (groups = occupied precision cells; see
    # atlas.groups.build_cell_table): chosen at prepare time so the
    # planes are decoded pre-tiled at the cell edge
    cell: bool = False
    # the tiled kernels bit-pack samples into 10-bit u32 fields; wider
    # decoded samples must use the gather kernel (i32 end to end)
    packed10_ok: bool = True
    # PLR (framework extension, single-map streams): the ASPS mode
    # table as (interpolate, filling, minimum_depth, neighbour_minus1)
    # tuples + the surface-thickness clamp; None when PLR is off
    plr_table: Optional[tuple] = None
    plr_thickness: int = 1
    # 3D geometry bit depth (asps_geometry_3d_bit_depth_minus1 + 1):
    # re-centering shift for the 45-degree inverse rotation
    geometry_bitdepth_3d: int = 10
    # single-map EOM: the fixed codeword bit count
    # (asps_eom_fix_bit_count_minus1 + 1); None on two-map streams
    # (there the D0..D1 gap bounds the codewords)
    eom_fix_bit_count: Optional[int] = None
    # auxiliary raw-patch videos (aux-flagged GVD/AVD units), raster
    # layout, one frame per atlas frame; None when the stream has none.
    # Only the host raw/EOM tails read them (framework extension).
    aux_geo_planes: Optional[List[np.ndarray]] = None
    aux_attr_planes: Optional[List[List[np.ndarray]]] = None
    aux_geo_shift: int = 0
    aux_chroma_shift: int = 1
    # FRAMEWORK EXTENSION: secondary attributes (vuh_attribute_index >
    # 0; the reference reads only attribute 0). Each decodes through
    # the IDENTICAL reconstruction graph with the attribute planes
    # swapped — emission order is a function of occupancy/geometry
    # only, so per-point alignment with the primary pass is free.
    sec_attrs: tuple = ()


# V3C attribute type ids (23090-5 table; the reference only ever
# consumes ATTR_TEXTURE). Names drive the extra PLY properties.
_ATTR_TYPE_NAMES = {
    0: "texture",
    1: "material_id",
    2: "transparency",
    3: "reflectance",
    4: "normal",
}


@dataclass(frozen=True)
class SecAttr:
    """One decoded secondary attribute (vuh_attribute_index >= 1)."""

    attr_index: int  # vuh_attribute_index (>= 1)
    type_id: int  # ai_attribute_type_id
    dimension: int  # ai_attribute_dimension_minus1 + 1 (1 or 3)
    planes: tuple  # per video frame (map-interleaved): [y, u, v]
    chroma_shift: int  # 1 = 4:2:0, 0 = 4:4:4 (after any 4:2:2 doubling)
    is_rgb444: bool
    bit_depth: int  # decoded sample bit depth
    # AttrSmoothingConfig when an attribute-smoothing SEI targets THIS
    # index (and the toggle is set, YUV dim-3 only); None otherwise
    smoothing: object = None
    # vuh_attribute_index as a string when another secondary shares this
    # type (PLY vertex properties must be uniquely named); "" otherwise
    name_suffix: str = ""
    # this attribute's AUXILIARY video (aux-flagged AVD units with this
    # vuh_attribute_index), raster, one frame per atlas frame; () when
    # the stream has no aux patches. The host tails' twin calls read it.
    aux_planes: tuple = ()
    aux_chroma_shift: int = 1

    def property_names(self) -> tuple:
        """PLY property names for this attribute's channels."""
        base = _ATTR_TYPE_NAMES.get(self.type_id, f"attr{self.attr_index}")
        sfx = self.name_suffix
        if self.dimension == 1:
            nm = base if self.type_id in _ATTR_TYPE_NAMES else f"{base}_c0"
            return (nm + sfx,)
        if self.type_id == 0:
            # a secondary texture: an index-suffixed RGB triple
            k = self.attr_index
            return (f"red{k}", f"green{k}", f"blue{k}")
        if self.type_id == 4:
            return (f"nx{sfx}", f"ny{sfx}", f"nz{sfx}")
        return tuple(f"{base}{sfx}_c{c}" for c in range(self.dimension))

    def finalize(self, col16: np.ndarray) -> np.ndarray:
        """Raw fetched (n, 3) u16 samples -> the output channel array.

        Texture-typed triples get the primary color treatment (exact
        f64 BT.709, or u8 truncation for decoded-RGB content); other
        types keep raw integer samples at the decoded bit depth."""
        from ..reconstruction.pointset import convert_yuv10_to_rgb8

        if self.dimension == 1:
            v = col16[:, :1]
            return v.astype(np.uint8) if self.bit_depth <= 8 else v
        if self.type_id == 0:
            if self.is_rgb444:
                return (col16 & 0xFF).astype(np.uint8)
            return convert_yuv10_to_rgb8(col16)
        return col16 if self.bit_depth > 8 else col16.astype(np.uint8)


def extract_geo_smoothing(context: Context, asps) -> Optional[object]:
    """Grid geometry-smoothing parameters from the first applicable
    prefix SEI (method_type 1), or None."""
    from ..ops.smoothing import SmoothingConfig
    from ..v3c.syntax import SeiPayloadType

    for i in range(context.atlas_tile_layer_len()):
        sei = context.get_atlas_tile_layer(i).sei
        if sei is None:
            continue
        for s in sei.sei_prefix:
            if s.payload_type != SeiPayloadType.GEOMETRY_SMOOTHING:
                continue
            for k in range(len(s.method_type)):
                if not s.instance_cancel_flag[k] and s.method_type[k] == 1:
                    cfg = SmoothingConfig(
                        grid_size=s.grid_size_minus_2[k] + 2,
                        threshold=s.threshold[k],
                        geometry_bitdepth_3d=asps.geometry_3d_bitdepth_minus1
                        + 1,
                    )
                    _check_grid_bound(cfg.grid_width)
                    return cfg
    return None


def extract_occupancy_synthesis(context: Context):
    """PBF parameters from the first applicable occupancy-synthesis SEI
    (method_type 1), or None (framework extension — the reference can
    neither parse the payload nor act on it, ``decoder.rs:240-242``)."""
    from ..reconstruction.occupancy_synthesis import (
        OccupancySynthesisConfig,
    )
    from ..v3c.syntax import SeiPayloadType

    for i in range(context.atlas_tile_layer_len()):
        sei = context.get_atlas_tile_layer(i).sei
        if sei is None:
            continue
        for s in sei.sei_prefix:
            if s.payload_type != SeiPayloadType.OCCUPANCY_SYNTHESIS:
                continue
            for k in range(len(s.method_type)):
                if not s.instance_cancel_flag[k] and s.method_type[k] == 1:
                    return OccupancySynthesisConfig(
                        threshold=1 << (s.pbf_log2_threshold_minus1[k] + 1),
                        passes=s.pbf_passes_count_minus1[k] + 1,
                        radius=s.pbf_filter_size_minus1[k] + 1,
                    )
    return None


# finest smoothing grid accepted: grid_width^3 cells x 6 int32 arrays per
# frame; 2^24 cells = ~400 MB at DEVICE_BATCH=2 — beyond that a (spec-
# legal) tiny grid_size would OOM the decode, so fail cleanly instead
_MAX_GRID_CELLS = 1 << 24


def _check_grid_bound(grid_width: int) -> None:
    if grid_width ** 3 > _MAX_GRID_CELLS:
        raise UnsupportedFeature(
            f"smoothing grid too fine: {grid_width}^3 cells exceeds the "
            f"supported bound ({_MAX_GRID_CELLS})"
        )


def extract_attr_smoothing(
    context: Context, asps, attr_idx: int = 0
) -> Optional[object]:
    """Grid attribute-smoothing parameters from the first applicable
    prefix SEI (method_type 1) targeting ``attr_idx``, or None. The SEI
    addresses attributes explicitly (``sai_attribute_idx``); secondary
    attributes take their own instance through the twin pass."""
    from ..ops.smoothing import AttrSmoothingConfig
    from ..v3c.syntax import SeiPayloadType

    for i in range(context.atlas_tile_layer_len()):
        sei = context.get_atlas_tile_layer(i).sei
        if sei is None:
            continue
        for s in sei.sei_prefix:
            if s.payload_type != SeiPayloadType.ATTRIBUTE_SMOOTHING:
                continue
            for j in range(s.num_attributes_updated):
                if (
                    s.attribute_smoothing_cancel_flag[j]
                    or s.attribute_idx[j] != attr_idx
                ):
                    continue
                for k in range(len(s.method_type[j])):
                    if (
                        not s.instance_cancel_flag[j][k]
                        and s.method_type[j][k] == 1
                    ):
                        cfg = AttrSmoothingConfig(
                            grid_size=s.grid_size_minus_2[j][k] + 2,
                            threshold_variation=s.threshold_variation[j][k],
                            threshold_difference=s.threshold_difference[j][k],
                            geometry_bitdepth_3d=asps.geometry_3d_bitdepth_minus1
                            + 1,
                        )
                        _check_grid_bound(cfg.grid_width)
                        return cfg
    return None


def _gof_color_mode(gof: GofData) -> str:
    """Device color finalization for a GOF: exact integer BT.709 for YUV
    content, u16→u8 truncation for decoded-RGB content."""
    if gof.attribute_count <= 0:
        return "raw"
    return "rgb16" if gof.attr_is_rgb444 else "yuv10"


def _emit_pointset(pos: np.ndarray, col: np.ndarray, gof: GofData) -> PointSet3:
    """Wrap fetched device output. ``col`` is u8 RGB when the dispatch
    finalized colors on device (the production path — conversion proven
    bit-equal to the host f64 chain, see ops/color.py), or u16 YUV from a
    'raw'-mode dispatch, converted here with the reference f64 chain."""
    ps = PointSet3(
        positions=pos.copy(),
        with_colors=gof.attribute_count > 0,
    )
    if gof.attribute_count > 0:
        if col.dtype == np.uint8:
            ps.colors = col.copy()
        else:
            ps.colors16bit = col.copy()
            if gof.attr_is_rgb444:
                # decoded attribute is already RGB (GBR 4:4:4 content):
                # plain 16->8 bit copy, no matrix (``src/decoder.rs:300-305``)
                ps.copy_rgb16_to_rgb8()
            else:
                # exact f64 BT.709 conversion (``src/codec.rs:661-687``)
                ps.convert_yuv16_to_rgb8()
    else:
        # attribute-less frames keep a deterministic neutral filler so
        # direct array consumers match the tails' 127s (the PLY writer
        # omits colors entirely: with_colors is False)
        ps.colors = np.full((len(ps), 3), 127, dtype=np.uint8)
    return ps


def _append_layer_frame(ps: PointSet3, pos, col, gof: GofData) -> None:
    """Append one trailing-layer dispatch's frame output to ``ps`` (the
    layer points follow the map-0/1 points, before any tails)."""
    lps = _emit_pointset(pos, col, gof)
    ps.positions = np.concatenate([ps.positions, lps.positions])
    ps.colors = np.concatenate([ps.colors, lps.colors])
    ps.colors16bit = np.concatenate([ps.colors16bit, lps.colors16bit])


def _gof_map_pair_view(gof: GofData, lo: int) -> GofData:
    """A two-map view of an M-map GOF selecting geometry/attribute maps
    (lo, lo+1) — the unit the device kernels reconstruct. Trailing-layer
    passes (lo >= 1) run this view with ``cfg.drop_map0`` so only the
    second map's points emit (dedup'd against map lo)."""
    mc = gof.map_count
    sel = [
        f * mc + lo + d
        for f in range(gof.frame_count)
        for d in (0, 1)
    ]
    return replace(
        gof,
        map_count=2,
        geo_planes=[gof.geo_planes[i] for i in sel],
        attr_planes=(
            [gof.attr_planes[i] for i in sel] if gof.attr_planes else gof.attr_planes
        ),
        # secondary families pair-select too: their twin dispatches run
        # per view (primary + one per trailing layer), values merged by
        # _merge_layer_sec_vals; aux planes are not map-indexed
        sec_attrs=tuple(
            replace(sa, planes=tuple(sa.planes[i] for i in sel))
            for sa in gof.sec_attrs
        ),
    )


def _merge_layer_sec_vals(sec_vals, layer_vals) -> None:
    """Append a trailing-layer twin dispatch's secondary values to the
    primary's, frame by frame, family by family (rows follow the layer
    points appended by _append_layer_frame)."""
    for j in range(len(sec_vals)):
        sec_vals[j] = [
            (names, np.concatenate([vals, lvals]))
            for (names, vals), (_ln, lvals) in zip(sec_vals[j], layer_vals[j])
        ]


def _append_tail_points(ps: PointSet3, gof: GofData, pos_r, col_r,
                        extra_cols=None) -> None:
    """Append host-decoded tail points (raw/EOM patches) with the same
    exact color-conversion chain the regular points took (host f64 ==
    device jit, ops/color.py). ``extra_cols`` (one finalized array per
    ``gof.sec_attrs`` entry, from the tail's secondary twin calls)
    extends the extra-attribute channels in lockstep with positions."""
    from ..reconstruction.pointset import convert_yuv10_to_rgb8

    if pos_r.shape[0] == 0:
        return
    ps.positions = np.concatenate([ps.positions, pos_r])
    if gof.attribute_count > 0:
        rgb = (
            (col_r & 0xFF).astype(np.uint8)
            if gof.attr_is_rgb444
            else convert_yuv10_to_rgb8(col_r)
        )
        ps.colors = np.concatenate([ps.colors, rgb])
        if ps.colors16bit.shape[0]:
            ps.colors16bit = np.concatenate([ps.colors16bit, col_r])
    else:
        ps.colors = np.concatenate(
            [ps.colors, np.full((pos_r.shape[0], 3), 127, np.uint8)]
        )
    if gof.sec_attrs:
        assert extra_cols is not None and len(extra_cols) == len(
            ps.extra_attrs
        ), "tail points must extend every secondary channel"
        ps.extra_attrs = [
            (names, np.concatenate([vals, extra]))
            for (names, vals), extra in zip(ps.extra_attrs, extra_cols)
        ]


def _tail_secondary_extras(run, gof: GofData, base: int, fi: int):
    """Secondary twin calls for one host tail: rerun the tail function
    with each secondary's planes (regular AND auxiliary — every
    attribute family carries its own aux video) swapped in; tails are
    deterministic, so positions align, and the second call's colors
    are the secondary's samples."""
    return [
        sa.finalize(run(
            sa.planes[base], sa.chroma_shift,
            sa.aux_planes[fi] if sa.aux_planes else None,
            sa.aux_chroma_shift,
        )[1])
        for sa in gof.sec_attrs
    ]


def _append_raw_points(ps: PointSet3, gof: GofData, meta) -> None:
    """Append the frame's raw-patch points (framework extension — the
    reference panics on raw patches, ``reader.rs:1068``) AFTER the
    regular points and after smoothing/color conversion: raw coordinates
    are verbatim outliers, not projected surface, so smoothing never
    touches them. Host-side NumPy by design — raw patches are a tiny
    tail, far below device-dispatch scale."""
    from ..reconstruction.raw_points import raw_points_for_frame

    base = meta.frame_index * gof.map_count
    attr = gof.attr_planes[base] if gof.attribute_count > 0 else None

    def run(planes, shift, aux_planes, aux_shift):
        return raw_points_for_frame(
            meta.raw_patches,
            gof.geo_planes[base],
            planes,
            gof.geo_shift,
            shift,
            meta.width,
            tile_size=gof.tile_size if gof.tiled else 0,
            left_top=meta.left_top_in_frame,
            aux_geo_plane=(
                gof.aux_geo_planes[meta.frame_index]
                if gof.aux_geo_planes else None
            ),
            aux_attr_planes=aux_planes,
            aux_geo_shift=gof.aux_geo_shift,
            aux_chroma_shift=aux_shift,
        )

    fi = meta.frame_index
    pos_r, col_r = run(
        attr, gof.attr_chroma_shift,
        gof.aux_attr_planes[fi] if gof.aux_attr_planes else None,
        gof.aux_chroma_shift,
    )
    _append_tail_points(
        ps, gof, pos_r, col_r, _tail_secondary_extras(run, gof, base, fi)
    )


def _meta_has_plr(gof: GofData, meta) -> bool:
    return gof.plr_table is not None and any(
        p.plr_modes is not None for p in meta.patches
    )


def _append_plr_points(ps: PointSet3, gof: GofData, meta) -> None:
    """Append the frame's PLR-derived far-surface points (framework
    extension — the reference panics on the ASPS flag,
    ``reader.rs:1082``) AFTER the regular points and after smoothing.
    See ``reconstruction/plr_points.py`` for the mode semantics."""
    from ..reconstruction.plr_points import plr_points_for_frame

    base = meta.frame_index * gof.map_count
    attr = gof.attr_planes[base] if gof.attribute_count > 0 else None

    def run(planes, shift, _aux_planes=None, _aux_shift=1):
        # PLR has no auxiliary-video form; uniform twin signature
        return plr_points_for_frame(
            meta,
            gof.occ_planes[meta.frame_index],
            gof.geo_planes[base],
            planes,
            gof.geo_shift,
            shift,
            meta.width,
            gof.occupancy_precision,
            gof.plr_table,
            gof.plr_thickness,
            tile_size=gof.tile_size if gof.tiled else 0,
            left_top=meta.left_top_in_frame,
            geometry_bitdepth_3d=gof.geometry_bitdepth_3d,
        )

    pos_p, col_p = run(attr, gof.attr_chroma_shift)
    _append_tail_points(
        ps, gof, pos_p, col_p,
        _tail_secondary_extras(run, gof, base, meta.frame_index),
    )


def _append_eom_points(ps: PointSet3, gof: GofData, meta) -> None:
    """Append the frame's EOM in-between points (framework extension —
    the reference panics on EOM patches, ``reader.rs:1069``) AFTER the
    regular points and after smoothing, BEFORE raw points. See
    ``reconstruction/eom_points.py`` for the codeword convention and
    why this is host-side."""
    from ..reconstruction.eom_points import eom_points_for_frame

    base = meta.frame_index * gof.map_count
    attr = gof.attr_planes[base] if gof.attribute_count > 0 else None

    def run(planes, shift, aux_planes, aux_shift):
        return eom_points_for_frame(
            meta,
            gof.occ_planes[meta.frame_index],
            gof.geo_planes[base],
            planes,
            gof.geo_shift,
            shift,
            meta.width,
            gof.occupancy_precision,
            tile_size=gof.tile_size if gof.tiled else 0,
            left_top=meta.left_top_in_frame,
            geometry_bitdepth_3d=gof.geometry_bitdepth_3d,
            fix_bit_count=gof.eom_fix_bit_count,
            aux_attr_planes=aux_planes,
            aux_chroma_shift=aux_shift,
        )

    fi = meta.frame_index
    pos_e, col_e = run(
        attr, gof.attr_chroma_shift,
        gof.aux_attr_planes[fi] if gof.aux_attr_planes else None,
        gof.aux_chroma_shift,
    )
    _append_tail_points(
        ps, gof, pos_e, col_e, _tail_secondary_extras(run, gof, base, fi)
    )


def _reconstruct_gof_oracle(gof: GofData) -> Iterator[PointSet3]:
    from ..reconstruction.oracle import GeneratePointCloudParams, generate_point_cloud

    for meta in gof.metas:
        params = GeneratePointCloudParams(
            occupancy_resolution=gof.occupancy_resolution,
            occupancy_precision=gof.occupancy_precision,
            absolute_d1=gof.absolute_d1,
            map_count_minus1=gof.map_count - 1,
            attribute_count=gof.attribute_count,
            geo_shift=gof.geo_shift,
            geometry_bitdepth_3d=gof.geometry_bitdepth_3d,
        )
        mc = gof.map_count
        base = meta.frame_index * mc
        attr_video = gof.attr_planes  # full video; oracle indexes by map+shift
        ps, partition, _ = generate_point_cloud(
            meta,
            params,
            gof.occ_planes[meta.frame_index],
            gof.geo_planes,
            [attr_video],
        )
        if gof.geo_smoothing is not None and len(ps) > 0:
            from ..ops.smoothing_np import smooth_slots_np

            pos = ps.positions.astype(np.int32)
            sx, sy, sz = smooth_slots_np(
                pos[:, 0], pos[:, 1], pos[:, 2],
                np.ones(len(ps), np.int32),
                np.asarray(partition, np.int32),
                gof.geo_smoothing,
            )
            ps.positions = np.stack([sx, sy, sz], axis=1).astype(np.uint16)
        if (
            gof.attr_smoothing is not None
            and len(ps) > 0
            and gof.attribute_count > 0
            and not gof.attr_is_rgb444
        ):
            from ..ops.smoothing_np import smooth_colors_np

            pos = ps.positions.astype(np.int32)
            col = ps.colors16bit.astype(np.int32)
            cy2, cu2, cv2 = smooth_colors_np(
                pos[:, 0], pos[:, 1], pos[:, 2],
                col[:, 0], col[:, 1], col[:, 2],
                np.ones(len(ps), np.int32),
                np.asarray(partition, np.int32),
                gof.attr_smoothing,
            )
            ps.colors16bit = np.stack([cy2, cu2, cv2], axis=1).astype(np.uint16)
        if gof.attribute_count > 0:
            if gof.attr_is_rgb444:
                ps.copy_rgb16_to_rgb8()
            else:
                ps.convert_yuv16_to_rgb8()
        for sa in gof.sec_attrs:
            # oracle twin pass (cf. _secondary_chunk_values): the same
            # scalar reconstruction with the attribute video swapped;
            # positions/order are attribute-independent, colors16bit
            # carries the secondary's raw samples
            ps2, partition2, _ = generate_point_cloud(
                meta,
                params,
                gof.occ_planes[meta.frame_index],
                gof.geo_planes,
                [list(sa.planes)],
            )
            col2 = ps2.colors16bit
            if sa.smoothing is not None and len(ps2) > 0:
                # the secondary's own attribute-smoothing SEI instance:
                # smoothing consumes geometry-SMOOTHED positions, like
                # the primary sequence above
                from ..ops.smoothing_np import (
                    smooth_colors_np,
                    smooth_slots_np,
                )

                pos2 = ps2.positions.astype(np.int32)
                part2 = np.asarray(partition2, np.int32)
                ones = np.ones(len(ps2), np.int32)
                if gof.geo_smoothing is not None:
                    sx, sy, sz = smooth_slots_np(
                        pos2[:, 0], pos2[:, 1], pos2[:, 2],
                        ones, part2, gof.geo_smoothing,
                    )
                    pos2 = np.stack([sx, sy, sz], axis=1)
                c = col2.astype(np.int32)
                cy2, cu2, cv2 = smooth_colors_np(
                    pos2[:, 0], pos2[:, 1], pos2[:, 2],
                    c[:, 0], c[:, 1], c[:, 2],
                    ones, part2, sa.smoothing,
                )
                col2 = np.stack([cy2, cu2, cv2], axis=1).astype(np.uint16)
            ps.extra_attrs.append(
                (sa.property_names(), sa.finalize(col2))
            )
        if _meta_has_plr(gof, meta):
            _append_plr_points(ps, gof, meta)
        if meta.eom_patches:
            _append_eom_points(ps, gof, meta)
        if meta.raw_patches:
            _append_raw_points(ps, gof, meta)
        yield ps
