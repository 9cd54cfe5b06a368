"""V3C bitstream writer — the exact inverse of the parsers in syntax.py.

The reference is decode-only; this module exists (a) to author synthetic
conformance fixtures for the test suite (the environment carries no MPEG
CTC streams), and (b) as a standalone mux capability. Every write mirrors
the corresponding parse field-for-field, including the reference quirks
(`byte_align` stop-bit, PTL byte-skips, SEI trailing byte).
"""

from __future__ import annotations

from typing import List, Sequence

from ..bitio import BitWriter
from .syntax import (
    AtlasFrameParameterSet,
    AtlasSequenceParameterSet,
    AtlasTileHeader,
    AtlasTileLayer,
    InterPatchDataUnit,
    IntraPatchDataUnit,
    MergePatchDataUnit,
    NalUnitType,
    PatchModeITile,
    ProfileTierLevel,
    EomPatchDataUnit,
    RawPatchDataUnit,
    RefListStruct,
    SkipPatchDataUnit,
    TileType,
    V3CParameterSet,
    V3CUnitType,
    VuiParameters,
    ceil_log2,
)


def write_vui(w: BitWriter, vui: VuiParameters) -> None:
    """F.2.1 VUI parameters — mirror of ``VuiParameters.parse``."""
    w.write(int(vui.timing_info_present_flag), 1)
    if vui.timing_info_present_flag:
        w.write(vui.num_units_in_tick, 32)
        w.write(vui.time_scale, 32)
        w.write(int(vui.poc_proportional_to_timing_flag), 1)
        if vui.poc_proportional_to_timing_flag:
            w.write_uvlc(vui.num_ticks_poc_diff_one_minus1)
        w.write(int(vui.hrd_parameters_present_flag), 1)
        if vui.hrd_parameters_present_flag:
            hp = vui.hrd_parameters
            w.write(int(hp.nal_parameters_present_flag), 1)
            w.write(int(hp.acl_parameters_present_flag), 1)
            if hp.nal_parameters_present_flag or hp.acl_parameters_present_flag:
                w.write(hp.bit_rate_scale, 4)
                w.write(hp.cab_size_scale, 4)
                w.write(hp.initial_cab_removal_delay_length_minus1, 5)
                w.write(hp.au_cab_removal_delay_length_minus1, 5)
                w.write(hp.dab_output_delay_length_minus1, 5)
            for i in range(hp.MAX_NUM_SUB_LAYERS):
                w.write(int(hp.fixed_atlas_rate_general_flag[i]), 1)
                if not hp.fixed_atlas_rate_general_flag[i]:
                    w.write(int(hp.fixed_atlas_rate_within_cas_flag[i]), 1)
                fixed = (hp.fixed_atlas_rate_general_flag[i]
                         or hp.fixed_atlas_rate_within_cas_flag[i])
                if fixed:
                    w.write_uvlc(hp.elemental_duration_in_tc_minus1[i])
                else:
                    w.write(int(hp.low_delay_flag[i]), 1)
                if not hp.low_delay_flag[i]:
                    w.write_uvlc(hp.cab_cnt_minus1[i])
                for k, present in enumerate(
                    (hp.nal_parameters_present_flag,
                     hp.acl_parameters_present_flag)
                ):
                    if present:
                        slp = hp.sub_layer_parameters[k][i]
                        for j in range(hp.cab_cnt_minus1[i] + 1):
                            w.write_uvlc(slp.bit_rate_value_minus1[j])
                            w.write_uvlc(slp.cab_size_value_minus1[j])
                            w.write(int(slp.cbr_flag[j]), 1)
    w.write(int(vui.tile_restrictions_present_flag), 1)
    if vui.tile_restrictions_present_flag:
        w.write(int(vui.fixed_atlas_tile_structure_flag), 1)
        w.write(int(vui.fixed_video_tile_structure_flag), 1)
        w.write_uvlc(vui.constrained_tiles_across_v3c_components_idc)
        w.write_uvlc(vui.max_num_tiles_per_atlas_minus1)
    w.write(int(vui.max_coded_video_resolution_present_flag), 1)
    if vui.max_coded_video_resolution_present_flag:
        w.write_uvlc(vui.coded_max_video_width)
        w.write_uvlc(vui.coded_max_video_height)
    w.write(int(vui.coordinate_system_parameters_present_flag), 1)
    if vui.coordinate_system_parameters_present_flag:
        csp = vui.coordinate_system_parameters
        w.write(csp.forward_axis, 2)
        w.write(csp.delta_left_axis, 1)
        w.write(int(csp.forward_sign), 1)
        w.write(int(csp.left_sign), 1)
        w.write(int(csp.up_sign), 1)
    w.write(int(vui.unit_in_metres_flag), 1)
    w.write(int(vui.display_box_info_present_flag), 1)
    if vui.display_box_info_present_flag:
        for d in range(3):
            w.write_uvlc(vui.display_box_origin[d])
            w.write_uvlc(vui.display_box_size[d])
        w.write(int(vui.anchor_point_present_flag), 1)
        if vui.anchor_point_present_flag:
            for d in range(3):
                w.write_uvlc(vui.anchor_point[d])


def write_ptl(w: BitWriter, ptl: ProfileTierLevel) -> None:
    w.write(int(ptl.tier_flag), 1)
    w.write(ptl.profile_codec_group_idc, 7)
    w.write(ptl.profile_toolset_idc, 8)
    w.write(ptl.profile_reconstruction_idc, 8)
    w.write(0, 32)  # reserved, skipped byte-wise by the reader
    w.write(ptl.level_idc, 8)
    w.write(0, 6)  # num_sub_profiles == 0
    w.write(int(ptl.extended_sub_profile_flag), 1)
    w.write(0, 1)  # tool_constraints_present_flag == 0


def write_vps(vps: V3CParameterSet) -> bytes:
    """Serialize a VPS payload (inverse of ``V3CParameterSet.parse``)."""
    w = BitWriter()
    write_ptl(w, vps.profile_tier_level)
    w.write(vps.v3c_parameter_set_id, 4)
    w.write(0, 8)  # reserved
    w.write(vps.atlas_count_minus1, 6)
    w.write(vps.atlas_id, 6)
    w.write_uvlc(vps.frame_width)
    w.write_uvlc(vps.frame_height)
    w.write(vps.map_count_minus1, 4)
    if vps.map_count_minus1 > 0:
        w.write(int(vps.multiple_map_streams_present_flag), 1)
    for k in range(1, vps.map_count_minus1 + 1):
        if vps.multiple_map_streams_present_flag:
            w.write(int(vps.map_absolute_coding_enable_flag[k]), 1)
        if not vps.map_absolute_coding_enable_flag[k]:
            w.write_uvlc(int(vps.map_predictor_index_diff[k]))
    w.write(int(vps.auxiliary_video_present_flag), 1)
    w.write(int(vps.occupancy_video_present_flag), 1)
    w.write(int(vps.geometry_video_present_flag), 1)
    w.write(int(vps.attribute_video_present_flag), 1)
    if vps.occupancy_video_present_flag:
        oi = vps.occupancy_information
        w.write(oi.occupancy_codec_id, 8)
        w.write(oi.occupancy_lossy_compression_threshold, 8)
        w.write(oi.occupancy_2d_bitdepth_minus1, 5)
        w.write(int(oi.occupancy_msb_align_flag), 1)
    if vps.geometry_video_present_flag:
        gi = vps.geometry_information
        w.write(gi.geometry_codec_id, 8)
        w.write(gi.geometry_2d_bitdepth_minus1, 5)
        w.write(int(gi.geometry_msb_align_flag), 1)
        w.write(gi.geometry_3d_coordinates_bitdepth_minus1, 5)
        if vps.auxiliary_video_present_flag:
            w.write(gi.auxiliary_geometry_codec_id, 8)
    if vps.attribute_video_present_flag:
        ai = vps.attribute_information
        w.write(ai.attribute_count, 7)
        for i in range(ai.attribute_count):
            w.write(ai.attribute_type_id[i], 4)
            w.write(ai.attribute_codec_id[i], 8)
            if vps.auxiliary_video_present_flag:
                w.write(ai.auxiliary_attribute_codec_id[i], 8)
            if vps.map_count_minus1 > 0:
                w.write(int(ai.attribute_map_absolute_coding_persistence_flag[i]), 1)
            w.write(ai.attribute_dimension_minus1[i], 6)
            if ai.attribute_dimension_minus1[i] > 0:
                w.write(ai.attribute_dimension_partitions_minus1[i], 6)
                remaining = ai.attribute_dimension_minus1[i]
                k = ai.attribute_dimension_partitions_minus1[i]
                for j in range(k):
                    channels = ai.attribute_partition_channels_minus1[i][j]
                    if k - j != remaining:
                        w.write_uvlc(channels)
                    remaining -= channels
            w.write(ai.attribute_2d_bitdepth_minus1[i], 5)
            w.write(int(ai.attribute_msb_align_flag[i]), 1)
    w.write(int(vps.extension_present_flag), 1)
    w.byte_align()
    return w.getvalue()


def write_ref_list_struct(
    w: BitWriter, rls: RefListStruct, long_term_flag: bool, log2_max_afoc: int
) -> None:
    w.write_uvlc(rls.num_ref_entries)
    st_i = lt_i = 0
    for k in range(rls.num_ref_entries):
        st = rls.st_ref_atlas_frame_flag[k]
        if long_term_flag:
            w.write(int(st), 1)
        if st:
            delta = rls.abs_delta_afoc_st[st_i]
            w.write_uvlc(delta)
            if delta > 0:
                w.write(int(rls.strpf_entry_sign_flag[st_i]), 1)
            st_i += 1
        else:
            w.write(rls.afoc_lsb_lt[lt_i], log2_max_afoc)
            lt_i += 1


def write_asps(asps: AtlasSequenceParameterSet) -> bytes:
    w = BitWriter()
    w.write_uvlc(asps.atlas_sequence_parameter_set_id)
    w.write_uvlc(asps.frame_width)
    w.write_uvlc(asps.frame_height)
    w.write(asps.geometry_3d_bitdepth_minus1, 5)
    w.write(asps.geometry_2d_bitdepth_minus1, 5)
    w.write_uvlc(asps.log2_max_atlas_frame_order_cnt_lsb_minus_4)
    w.write_uvlc(asps.max_dec_atlas_frame_buffering_minus1)
    w.write(int(asps.long_term_ref_atlas_frames_flag), 1)
    w.write_uvlc(asps.num_ref_atlas_frame_lists_in_asps)
    for rls in asps.ref_list_struct:
        write_ref_list_struct(
            w,
            rls,
            asps.long_term_ref_atlas_frames_flag,
            asps.log2_max_atlas_frame_order_cnt_lsb_minus_4 + 4,
        )
    w.write(int(asps.use_eight_orientations_flag), 1)
    w.write(int(asps.extended_projection_enabled_flag), 1)
    if asps.extended_projection_enabled_flag:
        w.write_uvlc(asps.max_number_projections_minus1)
    w.write(int(asps.normal_axis_limits_quantization_enabled_flag), 1)
    w.write(int(asps.normal_axis_max_delta_value_enabled_flag), 1)
    w.write(int(asps.patch_precedence_order_flag), 1)
    w.write(asps.log2_patch_packing_block_size, 3)
    w.write(int(asps.patch_size_quantizer_present_flag), 1)
    w.write(asps.map_count_minus1, 4)
    w.write(int(asps.pixel_deinterleaving_flag), 1)
    w.write(int(asps.raw_patch_enabled_flag), 1)
    w.write(int(asps.eom_patch_enabled_flag), 1)
    if asps.eom_patch_enabled_flag and asps.map_count_minus1 == 0:
        w.write(asps.eom_fix_bit_count_minus1, 4)
    if asps.raw_patch_enabled_flag or asps.eom_patch_enabled_flag:
        w.write(int(asps.auxiliary_video_enabled_flag), 1)
    w.write(int(asps.plr_enabled_flag), 1)
    if asps.plr_enabled_flag:
        for plri in asps.plr_information:
            w.write(int(plri.map_present_flag), 1)
            if not plri.map_present_flag:
                continue
            w.write(plri.number_of_modes - 1, 4)
            for i in range(plri.number_of_modes):
                w.write(int(plri.interpolate_flag[i]), 1)
                w.write(int(plri.filling_flag[i]), 1)
                w.write(int(plri.minimum_depth_flag[i]), 1)
                w.write(plri.neighbour_minus1[i], 2)
            w.write(plri.block_threshold_per_patch_minus1, 6)
    w.write(int(asps.vui_parameters_present_flag), 1)
    if asps.vui_parameters_present_flag:
        write_vui(w, asps.vui_parameters)
    w.write(int(asps.extension_flag), 1)
    if asps.extension_flag:
        w.write(int(asps.vpcc_extension_flag), 1)
        w.write(asps.extension_7bits, 7)
    if asps.vpcc_extension_flag:
        w.write(int(asps.vpcc_extension.remove_duplicate_point_enabled_flag), 1)
        if asps.pixel_deinterleaving_flag or asps.plr_enabled_flag:
            w.write(asps.vpcc_extension.surface_thickness_minus1, 7)
    w.byte_align()
    return w.getvalue()


def write_afps(afps: AtlasFrameParameterSet, asps: AtlasSequenceParameterSet) -> bytes:
    w = BitWriter()
    w.write_uvlc(afps.atlas_frame_parameter_set_id)
    w.write_uvlc(afps.atlas_sequence_parameter_set_id)
    afti = afps.atlas_frame_tile_information
    w.write(int(afti.single_tile_in_atlas_frame_flag), 1)
    if not afti.single_tile_in_atlas_frame_flag:
        # atlas frame partitioning (framework extension; 8.3.6.2.2 —
        # mirror of AtlasFrameTileInformation.parse)
        w.write(int(afti.uniform_partition_spacing_flag), 1)
        if afti.uniform_partition_spacing_flag:
            w.write_uvlc(afti.partition_cols_width_minus1)
            w.write_uvlc(afti.partition_rows_height_minus1)
        else:
            w.write_uvlc(afti.num_partition_columns_minus1)
            w.write_uvlc(afti.num_partition_rows_minus1)
            assert (
                len(afti.partition_column_width_minus1)
                == afti.num_partition_columns_minus1
            ) and (
                len(afti.partition_row_height_minus1)
                == afti.num_partition_rows_minus1
            )
            for v in afti.partition_column_width_minus1:
                w.write_uvlc(v)
            for v in afti.partition_row_height_minus1:
                w.write_uvlc(v)
        cols, rows = afti.partition_grid(asps.frame_width, asps.frame_height)
        w.write(int(afti.single_partition_per_tile_flag), 1)
        if not afti.single_partition_per_tile_flag:
            w.write_uvlc(afti.num_tiles_in_atlas_frame_minus1)
            idx_bits = ceil_log2(len(cols) * len(rows))
            for tl, brc, brr in zip(
                afti.top_left_partition_idx,
                afti.bottom_right_partition_column_offset,
                afti.bottom_right_partition_row_offset,
            ):
                w.write(tl, idx_bits)
                w.write_uvlc(brc)
                w.write_uvlc(brr)
        else:
            assert (
                afti.num_tiles_in_atlas_frame_minus1
                == len(cols) * len(rows) - 1
            ), "single_partition_per_tile: tile count = partition count"
    if asps.auxiliary_video_enabled_flag:
        w.write_uvlc(afti.auxiliary_video_tile_row_width_minus1)
        for h in afti.auxiliary_video_tile_row_height:
            w.write_uvlc(h)
    w.write(int(afti.signalled_tile_id_flag), 1)
    if afti.signalled_tile_id_flag:
        w.write_uvlc(afti.signalled_tile_id_length_minus1)
        for tid in afti.tile_id:
            w.write(tid, afti.signalled_tile_id_length_minus1 + 1)
    w.write(int(afps.output_flag_present_flag), 1)
    w.write_uvlc(afps.num_ref_idx_default_active_minus1)
    w.write_uvlc(afps.additional_lt_afoc_lsb_len)
    w.write(int(afps.lod_mode_enable_flag), 1)
    w.write(int(afps.raw_3d_offset_bitcount_explicit_mode_flag), 1)
    w.write(int(afps.extension_flag), 1)
    w.byte_align()
    return w.getvalue()


def _write_plrd(w: BitWriter, asps, plr_data, block_count: int) -> None:
    """Serialize 8.3.7.9 plr_data, one per PLR-present map (inverse of
    ``PlrData.parse``; inter/merge block counts come from the TMC2
    parse-time size accumulator the caller maintains)."""
    for plri, d in zip(asps.plr_information, plr_data):
        if not plri.map_present_flag:
            continue
        mode_bits = ceil_log2(plri.number_of_modes)
        if block_count > plri.block_threshold_per_patch_minus1 + 1:
            w.write(int(d.level_flag), 1)
        else:
            assert d.level_flag, "block-level PLR under threshold"
        if d.level_flag:
            w.write(int(d.present_flag), 1)
            if d.present_flag:
                w.write(d.mode_minus1, mode_bits)
        else:
            for p, m in zip(d.block_present_flag, d.block_mode_minus1):
                w.write(int(p), 1)
                if p:
                    w.write(m, mode_bits)


def write_atlas_tile_layer(
    atl: AtlasTileLayer,
    asps: AtlasSequenceParameterSet,
    afps: AtlasFrameParameterSet,
    nal_unit_type: NalUnitType,
) -> bytes:
    """Serialize a tile layer (header + intra patch data units + End)."""
    ath = atl.header
    w = BitWriter()
    if NalUnitType.BLA_W_LP <= nal_unit_type <= NalUnitType.GCRA:
        w.write(int(ath.no_output_of_prior_atlas_frames_flag), 1)
    w.write_uvlc(ath.atlas_frame_parameter_set_id)
    w.write_uvlc(ath.atlas_adaptation_parameter_set_id)
    afti = afps.atlas_frame_tile_information
    if afti.signalled_tile_id_flag:
        w.write(ath.id, afti.signalled_tile_id_length_minus1 + 1)
    elif afti.num_tiles_in_atlas_frame_minus1 != 0:
        w.write(ath.id, ceil_log2(afti.num_tiles_in_atlas_frame_minus1 + 1))
    w.write_uvlc(int(ath.tile_type))
    if afps.output_flag_present_flag:
        w.write(int(ath.atlas_output_flag), 1)
    w.write(
        ath.atlas_frame_order_count_lsb,
        asps.log2_max_atlas_frame_order_cnt_lsb_minus_4 + 4,
    )
    if asps.num_ref_atlas_frame_lists_in_asps > 0:
        w.write(int(ath.ref_atlas_frame_list_sps_flag), 1)
    if not ath.ref_atlas_frame_list_sps_flag:
        write_ref_list_struct(
            w,
            ath.ref_list_struct,
            asps.long_term_ref_atlas_frames_flag,
            asps.log2_max_atlas_frame_order_cnt_lsb_minus_4 + 4,
        )
    if asps.num_ref_atlas_frame_lists_in_asps > 1:
        w.write(ath.ref_atlas_frame_list_idx, ceil_log2(asps.num_ref_atlas_frame_lists_in_asps))
    ref_list = (
        asps.ref_list_struct[ath.ref_atlas_frame_list_idx]
        if ath.ref_atlas_frame_list_sps_flag
        else ath.ref_list_struct
    )
    num_ltr = sum(1 for st in ref_list.st_ref_atlas_frame_flag if not st)
    for j in range(num_ltr):
        w.write(int(ath.additional_afoc_lsb_present_flag[j]), 1)
        if ath.additional_afoc_lsb_present_flag[j]:
            w.write(ath.additional_afoc_lsb_val[j], afps.additional_lt_afoc_lsb_len)
    if ath.tile_type != TileType.SKIP:
        if asps.normal_axis_limits_quantization_enabled_flag:
            w.write(ath.pos_min_d_quantizer, 5)
            w.write(ath.pos_delta_max_d_quantizer, 5)
        if asps.patch_size_quantizer_present_flag:
            w.write(ath.patch_size_info_quantizer[0], 3)
            w.write(ath.patch_size_info_quantizer[1], 3)
        if afps.raw_3d_offset_bitcount_explicit_mode_flag:
            bit_count = (asps.geometry_3d_bitdepth_minus1 + 1).bit_length() - 1
            w.write(ath.raw_3d_offset_axis_bitcount_minus1, bit_count)
        if ath.tile_type == TileType.P and ref_list.num_ref_entries > 1:
            w.write(int(ath.num_ref_idx_active_override_flag), 1)
            if ath.num_ref_idx_active_override_flag:
                w.write_uvlc(ath.num_ref_idx_active_minus1)
    w.byte_align()

    if ath.tile_type == TileType.SKIP:
        # SKIP tiles carry no patch data, but the rbsp-level byte_align
        # still runs in the parser (reader.rs:1526-1542) and — per the
        # TMC2 quirk — consumes a whole stop byte on an aligned cursor
        w.byte_align()
        return w.getvalue()

    # num_ref_idx_active (context.rs:234-259), for the inter/merge
    # ref_index conditional
    if ath.tile_type == TileType.I:
        num_ref_idx_active = 0
    elif ath.num_ref_idx_active_override_flag:
        num_ref_idx_active = ath.num_ref_idx_active_minus1 + 1
    else:
        num_ref_idx_active = min(
            ref_list.num_ref_entries, afps.num_ref_idx_default_active_minus1 + 1
        )

    # patch data units
    bitcount_uv = asps.geometry_3d_bitdepth_minus1 + 1
    bitcount_d = asps.geometry_3d_bitdepth_minus1 - ath.pos_min_d_quantizer + 1
    # TMC2 parse-time size accumulator twin (prevPatchSizeU_/V_): the
    # parser sizes inter/merge plrd from it, so the writer must too
    plr_prev = [0, 0]
    for pid in atl.patch_information_data:
        pdu = pid.patch_data_unit
        w.write_uvlc(pid.patch_mode)
        if isinstance(pdu, IntraPatchDataUnit):
            w.write_uvlc(pdu.pos_2d[0])
            w.write_uvlc(pdu.pos_2d[1])
            w.write_uvlc(pdu.size_2d_minus1[0])
            w.write_uvlc(pdu.size_2d_minus1[1])
            w.write(pdu.pos_3d_offset[0], bitcount_uv)
            w.write(pdu.pos_3d_offset[1], bitcount_uv)
            w.write(pdu.pos_3d_offset_d, bitcount_d)
            if asps.normal_axis_max_delta_value_enabled_flag:
                bitcount_max_depth = (
                    min(asps.geometry_2d_bitdepth_minus1, asps.geometry_3d_bitdepth_minus1)
                    + 1
                    - ath.pos_delta_max_d_quantizer
                )
                w.write(pdu.pos_3d_range_d, bitcount_max_depth)
            w.write(pdu.projection_id, ceil_log2(asps.max_number_projections_minus1 + 1))
            w.write(int(pdu.orientation_index), 3 if asps.use_eight_orientations_flag else 1)
            if afps.lod_mode_enable_flag:
                w.write(int(pdu.lod_enabled_flag), 1)
                if pdu.lod_enabled_flag:
                    w.write_uvlc(pdu.lod_scale_x_minus1)
                    w.write_uvlc(pdu.lod_scale_y_idc)
            plr_prev[0] = pdu.size_2d_minus1[0] + 1
            plr_prev[1] = pdu.size_2d_minus1[1] + 1
            if asps.plr_enabled_flag:
                _write_plrd(
                    w, asps, pdu.plr_data, plr_prev[0] * plr_prev[1]
                )
        elif isinstance(pdu, InterPatchDataUnit):
            if num_ref_idx_active > 1:
                w.write_uvlc(pdu.ref_index)
            w.write_svlc(pdu.ref_patch_index)
            w.write_svlc(pdu.pos_2d[0])
            w.write_svlc(pdu.pos_2d[1])
            w.write_svlc(pdu.delta_2d_size[0])
            w.write_svlc(pdu.delta_2d_size[1])
            w.write_svlc(pdu.pos_3d_offset[0])
            w.write_svlc(pdu.pos_3d_offset[1])
            w.write_svlc(pdu.pos_3d_offset_d)
            if asps.normal_axis_max_delta_value_enabled_flag:
                w.write_svlc(pdu.pos_3d_range_d)
            plr_prev[0] += pdu.delta_2d_size[0]
            plr_prev[1] += pdu.delta_2d_size[1]
            if asps.plr_enabled_flag:
                _write_plrd(
                    w, asps, pdu.plr_data, plr_prev[0] * plr_prev[1]
                )
        elif isinstance(pdu, MergePatchDataUnit):
            if num_ref_idx_active > 1:
                w.write_uvlc(pdu.ref_index)
            w.write(int(pdu.override_2d_params_flag), 1)
            if pdu.override_2d_params_flag:
                w.write_svlc(pdu.pos_2d[0])
                w.write_svlc(pdu.pos_2d[1])
                w.write_svlc(pdu.delta_2d_size[0])
                w.write_svlc(pdu.delta_2d_size[1])
                if asps.plr_enabled_flag:
                    w.write(int(pdu.override_plr_flag), 1)
            else:
                # the 3d fields are carried even when override_3d is 0,
                # mirroring the reference parser (reader.rs:2019-2024)
                w.write(int(pdu.override_3d_params_flag), 1)
                w.write_svlc(pdu.pos_3d_offset[0])
                w.write_svlc(pdu.pos_3d_offset[1])
                w.write_svlc(pdu.pos_3d_offset_d)
                if asps.normal_axis_max_delta_value_enabled_flag:
                    # None means "field not representable" only when the
                    # ASPS disables it; with NAMD on a zero delta is coded
                    w.write_svlc(pdu.pos_3d_range_d or 0)
            plr_prev[0] += pdu.delta_2d_size[0]
            plr_prev[1] += pdu.delta_2d_size[1]
            if asps.plr_enabled_flag and pdu.override_plr_flag:
                _write_plrd(
                    w, asps, pdu.plr_data, plr_prev[0] * plr_prev[1]
                )
        elif isinstance(pdu, RawPatchDataUnit):
            if asps.auxiliary_video_enabled_flag:
                w.write(int(pdu.patch_in_auxiliary_video_flag), 1)
            w.write_uvlc(pdu.pos_2d[0])
            w.write_uvlc(pdu.pos_2d[1])
            w.write_uvlc(pdu.size_2d_minus1[0])
            w.write_uvlc(pdu.size_2d_minus1[1])
            rb = ath.raw_3d_offset_axis_bitcount_minus1 + 1
            w.write(pdu.pos_3d_offset_u, rb)
            w.write(pdu.pos_3d_offset_v, rb)
            w.write(pdu.pos_3d_offset_d, rb)
            w.write_uvlc(pdu.raw_points_minus1)
        elif isinstance(pdu, EomPatchDataUnit):
            if asps.auxiliary_video_enabled_flag:
                w.write(int(pdu.patch_in_auxiliary_video_flag), 1)
            w.write_uvlc(pdu.pos_2d[0])
            w.write_uvlc(pdu.pos_2d[1])
            w.write_uvlc(pdu.size_2d_minus1[0])
            w.write_uvlc(pdu.size_2d_minus1[1])
            w.write_uvlc(len(pdu.associated_patch_idx) - 1)
            for idx, n in zip(pdu.associated_patch_idx, pdu.points):
                w.write_uvlc(idx)
                w.write_uvlc(n)
        elif isinstance(pdu, SkipPatchDataUnit):
            pass  # P_SKIP carries no fields
        else:
            raise NotImplementedError(f"unsupported patch data unit {type(pdu)}")
    # End patch mode terminates the unit (value 14 for both I and P tiles)
    end_mode = int(PatchModeITile.END)
    w.write_uvlc(end_mode)
    w.byte_align()
    return w.getvalue()


def write_sei_geometry_smoothing(
    instances=((0, 1, 2, 3),),  # (instance_index, method_type, grid_size_minus_2, threshold)
    persistence_flag: bool = False,
    reset_flag: bool = False,
) -> bytes:
    """Serialize a prefix geometry-smoothing SEI payload (inverse of
    ``SeiGeometrySmoothing.parse`` + the SEI envelope quirks: byte_align
    followed by one extra trailing byte, ``reader.rs:1414-1417``)."""
    from .syntax import SeiPayloadType

    w = BitWriter()
    w.write(int(SeiPayloadType.GEOMETRY_SMOOTHING), 8)
    w.write(8, 8)  # payload size varint (parsed but unused by the reference)
    w.write(int(persistence_flag), 1)
    w.write(int(reset_flag), 1)
    w.write(len(instances), 8)
    for (idx, method, grid, threshold) in instances:
        w.write(idx, 8)
        w.write(0, 1)  # instance_cancel_flag
        w.write_uvlc(method)
        if method == 1:
            w.write(0, 1)  # filter_eom_points_flag
            w.write(grid, 7)
            w.write(threshold, 8)
    w.byte_align()
    w.write(0, 8)  # the extra trailing byte the parser consumes
    return w.getvalue()


def write_sei_attribute_smoothing(
    instances=((0, 0, 1, 2, 0, 10, 10),),
    # (attribute_idx, instance_index, method_type, grid_size_minus_2,
    #  threshold, threshold_variation, threshold_difference)
    persistence_flag: bool = False,
    reset_flag: bool = False,
) -> bytes:
    """Serialize a prefix attribute-smoothing SEI payload (inverse of
    ``SeiAttributeSmoothing.parse``) — the reference cannot parse this
    payload; framework extension."""
    from .syntax import SeiPayloadType

    w = BitWriter()
    w.write(int(SeiPayloadType.ATTRIBUTE_SMOOTHING), 8)
    w.write(8, 8)  # payload size varint (unused by the parser)
    w.write(int(persistence_flag), 1)
    w.write(int(reset_flag), 1)
    w.write_uvlc(len(instances))
    for (aidx, iidx, method, grid, thr, thr_var, thr_diff) in instances:
        w.write(aidx, 7)
        w.write(0, 1)  # attribute_smoothing_cancel_flag
        w.write(1, 8)  # instances_updated
        w.write(iidx, 8)
        w.write(0, 1)  # instance_cancel_flag
        w.write_uvlc(method)
        if method == 1:
            w.write(grid, 8)
            w.write(thr, 8)
            w.write(thr_var, 8)
            w.write(thr_diff, 8)
    w.byte_align()
    w.write(0, 8)  # the extra trailing byte the parser consumes
    return w.getvalue()


def write_sei_occupancy_synthesis(
    instances=((0, 1, 1, 0, 2),),
    # (instance_index, method_type, pbf_log2_threshold_minus1,
    #  pbf_passes_count_minus1, pbf_filter_size_minus1)
    persistence_flag: bool = False,
    reset_flag: bool = False,
) -> bytes:
    """Serialize a prefix occupancy-synthesis SEI payload (inverse of
    ``SeiOccupancySynthesis.parse``)."""
    from .syntax import SeiPayloadType

    w = BitWriter()
    w.write(int(SeiPayloadType.OCCUPANCY_SYNTHESIS), 8)
    w.write(4, 8)  # payload size varint (unused by the parser)
    w.write(int(persistence_flag), 1)
    w.write(int(reset_flag), 1)
    w.write(len(instances), 8)
    for (idx, method, thr, passes, fsize) in instances:
        w.write(idx, 8)
        w.write(0, 1)  # instance_cancel_flag
        w.write_uvlc(method)
        if method == 1:
            w.write(thr, 2)
            w.write(passes, 2)
            w.write(fsize, 3)
    w.byte_align()
    w.write(0, 8)  # the extra trailing byte the parser consumes
    return w.getvalue()


def write_sei_daih(sei) -> bytes:
    """H.20.2.8 decoded atlas information hash SEI payload, wrapped in
    the SEI envelope — mirror of ``SeiDecodedAtlasInformationHash.parse``
    (``sei`` is that dataclass)."""
    from .syntax import SeiPayloadType

    w = BitWriter()
    w.write(int(sei.cancel_flag), 1)
    if not sei.cancel_flag:
        w.write(int(sei.persistence_flag), 1)
        w.write(sei.hash_type, 8)
        w.write(int(sei.high_level_present), 1)
        w.write(int(sei.atlas_present), 1)
        w.write(int(sei.b2p_present), 1)
        w.write(int(sei.tiles_present), 1)
        w.write(int(sei.tiles_b2p_present), 1)
        w.byte_align()
        for present, h in (
            (sei.high_level_present, sei.high_level_hash),
            (sei.atlas_present, sei.atlas_hash),
            (sei.b2p_present, sei.b2p_hash),
        ):
            if present:
                for b in h:
                    w.write(b, 8)
        if sei.tiles_present or sei.tiles_b2p_present:
            w.write_uvlc(len(sei.tile_ids) - 1)
            id_len = max(1, max(sei.tile_ids).bit_length())
            w.write_uvlc(id_len - 1)
            for tid in sei.tile_ids:
                w.write(tid, id_len)
            w.byte_align()
            for t in range(len(sei.tile_ids)):
                if sei.tiles_present:
                    for b in sei.tiles_hash[t]:
                        w.write(b, 8)
                if sei.tiles_b2p_present:
                    for b in sei.tiles_b2p_hash[t]:
                        w.write(b, 8)
    w.pad_to_byte()
    return write_sei_raw(
        int(SeiPayloadType.DECODED_ATLAS_INFORMATION_HASH), w.getvalue()
    )


def write_sei_raw(payload_type: int, payload: bytes) -> bytes:
    """Serialize a generic SEI payload envelope (type + size varints +
    opaque payload bytes) — used to exercise the record-and-skip paths
    (unknown prefix payloads, suffix SEI) end to end."""
    w = BitWriter()
    t = int(payload_type)
    while t >= 0xFF:
        w.write(0xFF, 8)
        t -= 0xFF
    w.write(t, 8)
    s = len(payload)
    while s >= 0xFF:
        w.write(0xFF, 8)
        s -= 0xFF
    w.write(s, 8)
    for b in payload:
        w.write(b, 8)
    return w.getvalue()


def wrap_nal_unit(unit_type: NalUnitType, payload: bytes) -> bytes:
    """2-byte NAL header + payload (``reader.rs:770-778``)."""
    w = BitWriter()
    w.write(0, 1)  # forbidden zero bit
    w.write(int(unit_type), 6)
    w.write(0, 6)  # layer id
    w.write(1, 3)  # temporal id plus 1
    return w.getvalue() + payload


def build_nal_sample_stream(nal_units: Sequence[bytes], precision: int = 2) -> bytes:
    """Sample-stream NAL framing: 1-byte header + sized units."""
    w = BitWriter()
    w.write(precision - 1, 3)
    w.write(0, 5)
    out = bytearray(w.getvalue())
    for nalu in nal_units:
        out += len(nalu).to_bytes(precision, "big")
        out += nalu
    return bytes(out)


def v3c_unit_header(
    unit_type: V3CUnitType,
    *,
    vps_id: int = 0,
    atlas_id: int = 0,
    attribute_index: int = 0,
    attribute_dimension_index: int = 0,
    map_index: int = 0,
    auxiliary_video_flag: bool = False,
) -> bytes:
    """4-byte V3C unit header (inverse of ``V3CUnit._decode_header``)."""
    w = BitWriter()
    w.write(int(unit_type), 5)
    if unit_type == V3CUnitType.VPS:
        w.write(0, 27)
        return w.getvalue()
    w.write(vps_id, 4)
    w.write(atlas_id, 6)
    if unit_type == V3CUnitType.AVD:
        w.write(attribute_index, 7)
        w.write(attribute_dimension_index, 5)
        w.write(map_index, 4)
        w.write(int(auxiliary_video_flag), 1)
    elif unit_type == V3CUnitType.GVD:
        w.write(map_index, 4)
        w.write(int(auxiliary_video_flag), 1)
        w.write(0, 12)
    else:  # OVD / AD
        w.write(0, 17)
    return w.getvalue()


def annexb_to_length_prefixed(annexb: bytes, precision: int = 4) -> bytes:
    """Convert an Annex-B HEVC bytestream (00 00 01 / 00 00 00 01 start
    codes) into the length-prefixed NALU sample-stream format carried in
    V3C video units (the inverse of ``sample_stream_to_bytestream``,
    reference ``src/bitstream.rs:216-289``)."""
    out = bytearray()
    n = len(annexb)
    starts = []
    i = 0
    while i + 2 < n:
        if annexb[i] == 0 and annexb[i + 1] == 0:
            if annexb[i + 2] == 1:
                starts.append((i, 3))
                i += 3
                continue
            if i + 3 < n and annexb[i + 2] == 0 and annexb[i + 3] == 1:
                starts.append((i, 4))
                i += 4
                continue
        i += 1
    if not starts:
        raise ValueError("no Annex-B start codes found")
    for idx, (pos, sc_len) in enumerate(starts):
        begin = pos + sc_len
        end = starts[idx + 1][0] if idx + 1 < len(starts) else n
        nalu = annexb[begin:end]
        out += len(nalu).to_bytes(precision, "big")
        out += nalu
    return bytes(out)


class V3CSampleStreamWriter:
    """Builds a complete V3C sample-stream file from composed units."""

    def __init__(self, precision: int = 4):
        self.precision = precision
        self.units: List[bytes] = []

    def add_unit(self, header: bytes, payload: bytes) -> None:
        self.units.append(header + payload)

    def getvalue(self) -> bytes:
        w = BitWriter()
        w.write(self.precision - 1, 3)
        w.write(0, 5)
        out = bytearray(w.getvalue())
        for unit in self.units:
            out += len(unit).to_bytes(self.precision, "big")
            out += unit
        return bytes(out)
