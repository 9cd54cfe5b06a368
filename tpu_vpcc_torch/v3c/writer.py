"""The ASPS and AFPS writers of the V3C bitstream writer: the exact
inverse of their parsers in syntax.py.

The decoded-atlas-hash SEI's high-level hash covers the re-serialized
ASPS/AFPS (``atlas.atlas_hash.high_level_byte_string``); these four
functions are what that needs of the JAX package's ``v3c/writer.py``,
copied unchanged.
"""

from __future__ import annotations

from ..bitio import BitWriter
from .syntax import (
    AtlasFrameParameterSet,
    AtlasSequenceParameterSet,
    RefListStruct,
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
