"""V3C syntax structures and their bitstream parsers.

Each ``parse`` classmethod consumes bits from a :class:`~tpu_vpcc.bitio.Bitstream`
in the exact field order of the V3C spec as implemented by the reference
(``tmc2-rs src/bitstream/reader.rs``); ``file:line`` parity notes are on each
parser. Structures are plain dataclasses (host-side cold path).

Unsupported-profile features raise :class:`UnsupportedFeature` at the same
points the reference panics with ``unimplemented!``/``assert!`` — failing
fast on bitstreams outside the rec0 conformance envelope.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..bitio import Bitstream, BitstreamError


class UnsupportedFeature(Exception):
    """Bitstream uses a feature outside the supported rec0 envelope."""


def ceil_log2(x: int) -> int:
    """Exact ceil(log2(x)) for x >= 1.

    The reference uses ``fast_math::log2_raw(..).ceil()`` (an *approximate*
    f32 log2, ``reader.rs:1597,1632,1671,1905``); upstream TMC2 C++ uses the
    exact value. We implement the exact integer version — audited in
    tests/test_log2_parity.py and docs/DESIGN.md §7: of the four call
    sites one is unreachable and one has a singleton domain; on the two
    live sites every plausible fast-log2 family matches this exact value
    for all non-power-of-two arguments, and at exact powers of two the
    exact value is the TMC2/spec behavior (any crate deviation there
    would be a reference bug against its own conformance target).
    """
    if x <= 0:
        raise ValueError("ceil_log2 requires x >= 1")
    return (x - 1).bit_length()


def floor_log2(x: int) -> int:
    if x <= 0:
        raise ValueError("floor_log2 requires x >= 1")
    return x.bit_length() - 1


# ---------------------------------------------------------------------------
# enums
# ---------------------------------------------------------------------------


class V3CUnitType(enum.IntEnum):
    """5-bit V3C unit type (``reader.rs:163-176``)."""

    VPS = 0  # V3C parameter set
    AD = 1  # Atlas data
    OVD = 2  # Occupancy video data
    GVD = 3  # Geometry video data
    AVD = 4  # Attribute video data


class VideoType(enum.IntEnum):
    """Video sub-bitstream kind (``src/bitstream.rs:295-335``)."""

    OCCUPANCY = 0
    GEOMETRY = 1
    # per-map geometry sub-streams (multiple_map_streams mode): the
    # reference reserves GeometryD0..D15 (``src/bitstream.rs:295-335``)
    # but panics before demuxing any; here every map decodes
    GEOMETRY_D0 = 2
    GEOMETRY_D1 = 3
    GEOMETRY_D2 = 4
    GEOMETRY_D3 = 5
    GEOMETRY_D4 = 6
    GEOMETRY_D5 = 7
    GEOMETRY_D6 = 8
    GEOMETRY_D7 = 9
    GEOMETRY_D8 = 10
    GEOMETRY_D9 = 11
    GEOMETRY_D10 = 12
    GEOMETRY_D11 = 13
    GEOMETRY_D12 = 14
    GEOMETRY_D13 = 15
    GEOMETRY_D14 = 16
    GEOMETRY_D15 = 17
    GEOMETRY_RAW = 18
    ATTRIBUTE = 19
    # per-map attribute sub-streams (the reference comments its
    # AttributeT0..T15 out entirely)
    ATTRIBUTE_T0 = 20
    ATTRIBUTE_T1 = 21
    ATTRIBUTE_T2 = 22
    ATTRIBUTE_T3 = 23
    ATTRIBUTE_T4 = 24
    ATTRIBUTE_T5 = 25
    ATTRIBUTE_T6 = 26
    ATTRIBUTE_T7 = 27
    ATTRIBUTE_T8 = 28
    ATTRIBUTE_T9 = 29
    ATTRIBUTE_T10 = 30
    ATTRIBUTE_T11 = 31
    ATTRIBUTE_T12 = 32
    ATTRIBUTE_T13 = 33
    ATTRIBUTE_T14 = 34
    ATTRIBUTE_T15 = 35
    # auxiliary attribute sub-stream (aux-flagged AVD units; the
    # reference's enum has AttributeRaw but panics before demuxing).
    # Internal demux key only — never serialized (the unit header
    # carries the aux flag), so the value tracks the reference's slot
    # after the full T0..T15 range.
    ATTRIBUTE_RAW = 36


class NalUnitType(enum.IntEnum):
    """Atlas NAL unit types (``reader.rs:823-932``)."""

    TRAIL_N = 0
    TRAIL_R = 1
    TSA_N = 2
    TSA_R = 3
    STSA_N = 4
    STSA_R = 5
    RADL_N = 6
    RADL_R = 7
    RASL_N = 8
    RASL_R = 9
    SKIP_N = 10
    SKIP_R = 11
    # 12-15: reserved non-IRAP sub-layer ACL types (spec-reserved; the
    # reference leaves them out of its enum and panics on FromPrimitive —
    # we map them and raise UnsupportedFeature at dispatch instead)
    RSV_ACL_N12 = 12
    RSV_ACL_R13 = 13
    RSV_ACL_N14 = 14
    RSV_ACL_R15 = 15
    BLA_W_LP = 16
    BLA_W_RADL = 17
    BLA_N_LP = 18
    GBLA_W_LP = 19
    GBLA_W_RADL = 20
    GBLA_N_LP = 21
    IDR_W_RADL = 22
    IDR_N_LP = 23
    GIDR_W_RADL = 24
    GIDR_N_LP = 25
    CRA = 26
    GCRA = 27
    # 28-29: reserved IRAP ACL; 30-35: reserved non-IRAP ACL
    RSV_IRAP_ACL_28 = 28
    RSV_IRAP_ACL_29 = 29
    RSV_ACL_30 = 30
    RSV_ACL_31 = 31
    RSV_ACL_32 = 32
    RSV_ACL_33 = 33
    RSV_ACL_34 = 34
    RSV_ACL_35 = 35
    ASPS = 36
    AFPS = 37
    AUD = 38
    V3C_AUD = 39
    EOS = 40
    EOB = 41
    FD = 42
    PREFIX_NSEI = 43
    SUFFIX_NSEI = 44
    PREFIX_ESEI = 45
    SUFFIX_ESEI = 46
    AAPS = 47

    @property
    def is_acl(self) -> bool:
        return self <= NalUnitType.RSV_ACL_35

    @property
    def is_prefix_sei(self) -> bool:
        return self in (NalUnitType.PREFIX_NSEI, NalUnitType.PREFIX_ESEI)

    @property
    def is_suffix_sei(self) -> bool:
        return self in (NalUnitType.SUFFIX_NSEI, NalUnitType.SUFFIX_ESEI)


# ACL NAL types dispatched to the tile-layer parser (``reader.rs:792-804``).
TILE_NAL_TYPES = frozenset(
    {
        NalUnitType.TRAIL_N,
        NalUnitType.TRAIL_R,
        NalUnitType.TSA_N,
        NalUnitType.TSA_R,
        NalUnitType.STSA_N,
        NalUnitType.STSA_R,
        NalUnitType.RADL_N,
        NalUnitType.RADL_R,
        NalUnitType.RASL_N,
        NalUnitType.RASL_R,
        NalUnitType.SKIP_N,
        NalUnitType.SKIP_R,
        NalUnitType.IDR_N_LP,
    }
)


class TileType(enum.IntEnum):
    """``reader.rs:1692-1702``."""

    P = 0
    I = 1
    SKIP = 2


class PatchOrientation(enum.IntEnum):
    """The 8 canvas orientations + swap (``src/decoder.rs:694-707``)."""

    DEFAULT = 0
    SWAP = 1
    ROT90 = 2
    ROT180 = 3
    ROT270 = 4
    MIRROR = 5
    MROT90 = 6
    MROT180 = 7
    MROT270 = 8


class PatchModeITile(enum.IntEnum):
    """23090-5 Table 7-4. The reference enumerates only INTRA/END and
    comments RAW/EOM out (``reader.rs:1740-1753``); RAW and EOM decode
    are framework extensions (reconstruction/raw_points.py,
    reconstruction/eom_points.py)."""

    INTRA = 0
    RAW = 1
    EOM = 2
    END = 14


class PatchModePTile(enum.IntEnum):
    """23090-5 Table 7-5 (``reader.rs:1755-1773``; RAW/EOM commented
    out there — see :class:`PatchModeITile`)."""

    SKIP = 0
    MERGE = 1
    INTER = 2
    INTRA = 3
    RAW = 4
    EOM = 5
    END = 14


class SeiPayloadType(enum.IntEnum):
    """``reader.rs:1339-1368``."""

    BUFFERING_PERIOD = 0
    ATLAS_FRAME_TIMING = 1
    FILLER_PAYLOAD = 2
    USER_DATA_REGISTERED_ITUTT35 = 3
    USER_DATA_UNREGISTERED = 4
    RECOVERY_POINT = 5
    NO_RECONSTRUCTION = 6
    TIME_CODE = 7
    SEI_MANIFEST = 8
    SEI_PREFIX_INDICATION = 9
    ACTIVE_SUB_BITSTREAMS = 10
    COMPONENT_CODEC_MAPPING = 11
    SCENE_OBJECT_INFORMATION = 12
    OBJECT_LABEL_INFORMATION = 13
    PATCH_INFORMATION = 14
    VOLUMETRIC_RECTANGLE_INFORMATION = 15
    ATLAS_OBJECT_INFORMATION = 16
    VIEWPORT_CAMERA_PARAMETERS = 17
    VIEWPORT_POSITION = 18
    DECODED_ATLAS_INFORMATION_HASH = 19
    ATTRIBUTE_TRANSFORMATION_PARAMS = 64
    OCCUPANCY_SYNTHESIS = 65
    GEOMETRY_SMOOTHING = 66
    ATTRIBUTE_SMOOTHING = 67
    RESERVED_SEI_MESSAGE = 68


# ---------------------------------------------------------------------------
# VPS and sub-structures
# ---------------------------------------------------------------------------


@dataclass
class ProfileTierLevel:
    """8.3.4.2 profile/tier/level (``reader.rs:500-569``)."""

    tier_flag: bool = False
    profile_codec_group_idc: int = 1  # HEVC Main10
    profile_toolset_idc: int = 0
    profile_reconstruction_idc: int = 0  # rec0
    level_idc: int = 30
    extended_sub_profile_flag: bool = False

    @classmethod
    def parse(cls, bs: Bitstream) -> "ProfileTierLevel":
        ptl = cls(
            tier_flag=bs.read(1) != 0,
            profile_codec_group_idc=bs.read(7),
            profile_toolset_idc=bs.read(8),
            profile_reconstruction_idc=bs.read(8),
        )
        # 32 reserved zero bits, skipped byte-wise (``reader.rs:533-537``)
        for _ in range(4):
            bs.move_to_next_byte()
        ptl.level_idc = bs.read(8)
        if bs.read(6) != 0:
            raise UnsupportedFeature("ptl sub-profiles not supported")
        ptl.extended_sub_profile_flag = bs.read(1) != 0
        if bs.read(1) != 0:
            raise UnsupportedFeature("ptl toolset constraints not supported")
        return ptl


@dataclass
class OccupancyInformation:
    """8.3.4.3 (``reader.rs:343-372``)."""

    occupancy_codec_id: int = 0
    occupancy_lossy_compression_threshold: int = 0
    occupancy_2d_bitdepth_minus1: int = 10
    occupancy_msb_align_flag: bool = False

    @classmethod
    def parse(cls, bs: Bitstream) -> "OccupancyInformation":
        return cls(
            occupancy_codec_id=bs.read(8),
            occupancy_lossy_compression_threshold=bs.read(8),
            occupancy_2d_bitdepth_minus1=bs.read(5),
            occupancy_msb_align_flag=bs.read(1) != 0,
        )


@dataclass
class GeometryInformation:
    """8.3.4.4 (``reader.rs:374-410``)."""

    geometry_codec_id: int = 0
    auxiliary_geometry_codec_id: int = 0
    geometry_2d_bitdepth_minus1: int = 10
    geometry_3d_coordinates_bitdepth_minus1: int = 9
    geometry_msb_align_flag: bool = False

    @classmethod
    def parse(cls, bs: Bitstream, aux_video_present: bool) -> "GeometryInformation":
        gi = cls(
            geometry_codec_id=bs.read(8),
            geometry_2d_bitdepth_minus1=bs.read(5),
            geometry_msb_align_flag=bs.read(1) != 0,
            geometry_3d_coordinates_bitdepth_minus1=bs.read(5),
        )
        if aux_video_present:
            gi.auxiliary_geometry_codec_id = bs.read(8)
        return gi


@dataclass
class AttributeInformation:
    """8.3.4.5 (``reader.rs:412-482``)."""

    attribute_count: int = 0
    attribute_type_id: List[int] = field(default_factory=list)
    attribute_codec_id: List[int] = field(default_factory=list)
    auxiliary_attribute_codec_id: List[int] = field(default_factory=list)
    attribute_map_absolute_coding_persistence_flag: List[bool] = field(default_factory=list)
    attribute_dimension_minus1: List[int] = field(default_factory=list)
    attribute_dimension_partitions_minus1: List[int] = field(default_factory=list)
    attribute_partition_channels_minus1: List[List[int]] = field(default_factory=list)
    attribute_2d_bitdepth_minus1: List[int] = field(default_factory=list)
    attribute_msb_align_flag: List[bool] = field(default_factory=list)

    @classmethod
    def parse(
        cls, bs: Bitstream, aux_video_present: bool, map_count_minus1: int
    ) -> "AttributeInformation":
        n = bs.read(7)
        ai = cls(
            attribute_count=n,
            attribute_type_id=[0] * n,
            attribute_codec_id=[0] * n,
            auxiliary_attribute_codec_id=[0] * n,
            attribute_map_absolute_coding_persistence_flag=[False] * n,
            attribute_dimension_minus1=[0] * n,
            attribute_dimension_partitions_minus1=[0] * n,
            attribute_partition_channels_minus1=[[] for _ in range(n)],
            attribute_2d_bitdepth_minus1=[0] * n,
            attribute_msb_align_flag=[False] * n,
        )
        for i in range(n):
            ai.attribute_type_id[i] = bs.read(4)
            ai.attribute_codec_id[i] = bs.read(8)
            if aux_video_present:
                ai.auxiliary_attribute_codec_id[i] = bs.read(8)
            ai.attribute_map_absolute_coding_persistence_flag[i] = True
            if map_count_minus1 > 0:
                ai.attribute_map_absolute_coding_persistence_flag[i] = bs.read(1) != 0
            ai.attribute_dimension_minus1[i] = bs.read(6)
            if ai.attribute_dimension_minus1[i] > 0:
                ai.attribute_dimension_partitions_minus1[i] = bs.read(6)
                remaining = ai.attribute_dimension_minus1[i]
                k = ai.attribute_dimension_partitions_minus1[i]
                for j in range(k):
                    channels = 0 if k - j == remaining else bs.read_uvlc()
                    ai.attribute_partition_channels_minus1[i].append(channels)
                    remaining -= channels
                ai.attribute_partition_channels_minus1[i].append(remaining)
            ai.attribute_2d_bitdepth_minus1[i] = bs.read(5)
            ai.attribute_msb_align_flag[i] = bs.read(1) != 0
        return ai


@dataclass
class V3CParameterSet:
    """8.3.4.1 V3C parameter set (``reader.rs:178-341``).

    Single-atlas only (``atlas_count_minus1 == 0`` asserted, ``reader.rs:266``).
    """

    profile_tier_level: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    v3c_parameter_set_id: int = 0
    atlas_count_minus1: int = 0
    atlas_id: int = 0
    frame_width: int = 0
    frame_height: int = 0
    map_count_minus1: int = 0
    multiple_map_streams_present_flag: bool = False
    map_absolute_coding_enable_flag: List[bool] = field(default_factory=lambda: [True])
    map_predictor_index_diff: List[bool] = field(default_factory=lambda: [False])
    auxiliary_video_present_flag: bool = False
    occupancy_video_present_flag: bool = False
    geometry_video_present_flag: bool = False
    attribute_video_present_flag: bool = False
    occupancy_information: OccupancyInformation = field(default_factory=OccupancyInformation)
    geometry_information: GeometryInformation = field(default_factory=GeometryInformation)
    attribute_information: AttributeInformation = field(default_factory=AttributeInformation)
    extension_present_flag: bool = False

    @classmethod
    def parse(cls, bs: Bitstream) -> "V3CParameterSet":
        vps = cls(profile_tier_level=ProfileTierLevel.parse(bs))
        vps.v3c_parameter_set_id = bs.read(4)
        bs.read(8)  # reserved
        vps.atlas_count_minus1 = bs.read(6)
        if vps.atlas_count_minus1 != 0:
            raise UnsupportedFeature("V3C has a single atlas (tmc2 v18)")
        vps.atlas_id = bs.read(6)
        vps.frame_width = bs.read_uvlc()
        vps.frame_height = bs.read_uvlc()
        vps.map_count_minus1 = bs.read(4)
        n_maps = vps.map_count_minus1 + 1
        vps.map_absolute_coding_enable_flag = [True] * n_maps
        vps.map_predictor_index_diff = [False] * n_maps
        if vps.map_count_minus1 > 0:
            # FRAMEWORK EXTENSION: per-map video sub-streams decode
            # (runtime/pipeline.py interleaves them); the reference
            # rejects the flag (``reader.rs:278-283``)
            vps.multiple_map_streams_present_flag = bs.read(1) != 0
        for k in range(1, n_maps):
            if vps.multiple_map_streams_present_flag:
                vps.map_absolute_coding_enable_flag[k] = bs.read(1) != 0
            if not vps.map_absolute_coding_enable_flag[k]:
                vps.map_predictor_index_diff[k] = bs.read_uvlc() != 0
        vps.auxiliary_video_present_flag = bs.read(1) != 0
        vps.occupancy_video_present_flag = bs.read(1) != 0
        vps.geometry_video_present_flag = bs.read(1) != 0
        vps.attribute_video_present_flag = bs.read(1) != 0
        if vps.occupancy_video_present_flag:
            vps.occupancy_information = OccupancyInformation.parse(bs)
        if vps.geometry_video_present_flag:
            vps.geometry_information = GeometryInformation.parse(
                bs, vps.auxiliary_video_present_flag
            )
        if vps.attribute_video_present_flag:
            vps.attribute_information = AttributeInformation.parse(
                bs, vps.auxiliary_video_present_flag, vps.map_count_minus1
            )
        vps.extension_present_flag = bs.read(1) != 0
        if vps.extension_present_flag:
            raise UnsupportedFeature("vps extension not supported")
        bs.byte_align()
        return vps


# ---------------------------------------------------------------------------
# ASPS / AFPS
# ---------------------------------------------------------------------------


@dataclass
class RefListStruct:
    """8.3.6.1.2 reference list struct (``reader.rs:1119-1167``)."""

    num_ref_entries: int = 0
    abs_delta_afoc_st: List[int] = field(default_factory=list)
    afoc_lsb_lt: List[int] = field(default_factory=list)
    st_ref_atlas_frame_flag: List[bool] = field(default_factory=list)
    strpf_entry_sign_flag: List[bool] = field(default_factory=list)

    @classmethod
    def parse(
        cls, bs: Bitstream, long_term_flag: bool, log2_max_afoc: int
    ) -> "RefListStruct":
        rls = cls(num_ref_entries=bs.read_uvlc())
        for _ in range(rls.num_ref_entries):
            st = bs.read(1) != 0 if long_term_flag else True
            rls.st_ref_atlas_frame_flag.append(st)
            if st:
                delta = bs.read_uvlc()
                rls.abs_delta_afoc_st.append(delta)
                rls.strpf_entry_sign_flag.append(bs.read(1) != 0 if delta > 0 else True)
            else:
                rls.afoc_lsb_lt.append(bs.read(log2_max_afoc))
        return rls


@dataclass
class AspsVpccExtension:
    remove_duplicate_point_enabled_flag: bool = False
    surface_thickness_minus1: int = 0


@dataclass
class PlrInformation:
    """8.3.6.1.2 PLR information, one per map (FRAMEWORK EXTENSION —
    the reference comments the struct out and panics on the ASPS flag,
    ``reader.rs:972``, ``:1082``). Each mode is an
    (interpolate, filling, minimum_depth, neighbour) tuple driving the
    point-local reconstruction in ``reconstruction/plr_points.py``."""

    map_present_flag: bool = False
    interpolate_flag: List[bool] = field(default_factory=list)
    filling_flag: List[bool] = field(default_factory=list)
    minimum_depth_flag: List[bool] = field(default_factory=list)
    neighbour_minus1: List[int] = field(default_factory=list)
    block_threshold_per_patch_minus1: int = 0

    @property
    def number_of_modes(self) -> int:
        return len(self.interpolate_flag)

    @classmethod
    def parse(cls, bs: Bitstream) -> "PlrInformation":
        plri = cls()
        plri.map_present_flag = bs.read(1) != 0
        if not plri.map_present_flag:
            return plri
        n_modes = bs.read(4) + 1
        for _ in range(n_modes):
            plri.interpolate_flag.append(bs.read(1) != 0)
            plri.filling_flag.append(bs.read(1) != 0)
            plri.minimum_depth_flag.append(bs.read(1) != 0)
            plri.neighbour_minus1.append(bs.read(2))
        plri.block_threshold_per_patch_minus1 = bs.read(6)
        return plri


@dataclass
class HrdSubLayerParameters:
    """F.2.3 HRD sub-layer parameters (FRAMEWORK EXTENSION — the
    reference panics on the VUI present flag, ``reader.rs:1089``, so
    it never reaches HRD). One (bit_rate, cab_size, cbr) triple per
    CAB count."""

    bit_rate_value_minus1: List[int] = field(default_factory=list)
    cab_size_value_minus1: List[int] = field(default_factory=list)
    cbr_flag: List[bool] = field(default_factory=list)

    @classmethod
    def parse(cls, bs: Bitstream, cab_cnt: int) -> "HrdSubLayerParameters":
        p = cls()
        for _ in range(cab_cnt + 1):
            p.bit_rate_value_minus1.append(bs.read_uvlc())
            p.cab_size_value_minus1.append(bs.read_uvlc())
            p.cbr_flag.append(bs.read(1) != 0)
        return p


@dataclass
class HrdParameters:
    """F.2.2 HRD parameters. V3C HRD is defined over atlas sub-layers;
    this decoder carries the single-sub-layer form (max_num_sub_layers
    == 1, matching every stream this framework authors — TMC2 likewise
    never codes extra sub-layers)."""

    nal_parameters_present_flag: bool = False
    acl_parameters_present_flag: bool = False
    bit_rate_scale: int = 0
    cab_size_scale: int = 0
    initial_cab_removal_delay_length_minus1: int = 0
    au_cab_removal_delay_length_minus1: int = 0
    dab_output_delay_length_minus1: int = 0
    fixed_atlas_rate_general_flag: List[bool] = field(default_factory=list)
    fixed_atlas_rate_within_cas_flag: List[bool] = field(default_factory=list)
    elemental_duration_in_tc_minus1: List[int] = field(default_factory=list)
    low_delay_flag: List[bool] = field(default_factory=list)
    cab_cnt_minus1: List[int] = field(default_factory=list)
    sub_layer_parameters: List[List[Optional["HrdSubLayerParameters"]]] = field(
        default_factory=lambda: [[], []]
    )

    MAX_NUM_SUB_LAYERS: int = 1

    @classmethod
    def parse(cls, bs: Bitstream) -> "HrdParameters":
        hp = cls()
        hp.nal_parameters_present_flag = bs.read(1) != 0
        hp.acl_parameters_present_flag = bs.read(1) != 0
        if hp.nal_parameters_present_flag or hp.acl_parameters_present_flag:
            hp.bit_rate_scale = bs.read(4)
            hp.cab_size_scale = bs.read(4)
            hp.initial_cab_removal_delay_length_minus1 = bs.read(5)
            hp.au_cab_removal_delay_length_minus1 = bs.read(5)
            hp.dab_output_delay_length_minus1 = bs.read(5)
        for i in range(cls.MAX_NUM_SUB_LAYERS):
            hp.fixed_atlas_rate_general_flag.append(bs.read(1) != 0)
            within = False
            if not hp.fixed_atlas_rate_general_flag[i]:
                within = bs.read(1) != 0
            hp.fixed_atlas_rate_within_cas_flag.append(within)
            fixed = hp.fixed_atlas_rate_general_flag[i] or within
            if fixed:
                hp.elemental_duration_in_tc_minus1.append(bs.read_uvlc())
                hp.low_delay_flag.append(False)
            else:
                hp.elemental_duration_in_tc_minus1.append(0)
                hp.low_delay_flag.append(bs.read(1) != 0)
            if not hp.low_delay_flag[i]:
                hp.cab_cnt_minus1.append(bs.read_uvlc())
            else:
                hp.cab_cnt_minus1.append(0)
            for k, present in enumerate(
                (hp.nal_parameters_present_flag,
                 hp.acl_parameters_present_flag)
            ):
                hp.sub_layer_parameters[k].append(
                    HrdSubLayerParameters.parse(bs, hp.cab_cnt_minus1[i])
                    if present else None
                )
        return hp


@dataclass
class CoordinateSystemParameters:
    """F.2.4 coordinate system parameters: how the decoded XYZ axes map
    to a viewing coordinate system (display metadata only — the
    reconstruction is unaffected)."""

    forward_axis: int = 0
    delta_left_axis: int = 0
    forward_sign: bool = True
    left_sign: bool = True
    up_sign: bool = True

    @classmethod
    def parse(cls, bs: Bitstream) -> "CoordinateSystemParameters":
        return cls(
            forward_axis=bs.read(2),
            delta_left_axis=bs.read(1),
            forward_sign=bs.read(1) != 0,
            left_sign=bs.read(1) != 0,
            up_sign=bs.read(1) != 0,
        )


@dataclass
class VuiParameters:
    """F.2.1 VUI parameters (FRAMEWORK EXTENSION — the reference panics
    on ``asps.vui_parameters_present_flag``, ``reader.rs:1089``; this
    was the last piece of V3C syntax neither decoder could even skip).
    Pure display/timing metadata: parsed, stored, and roundtripped, but
    it does not alter reconstruction.

    CAVEAT (spec text unavailable in this environment): the field order
    follows F.2.1/F.2.2 as mirrored by TMC2's reader; writer/parser
    symmetry, every-branch roundtrips, and a bit-flip sweep are pinned,
    but a foreign stream whose VUI layout differs (e.g. multi-sub-layer
    HRD) would desync the remaining mid-ASPS fields — the NAL-boundary
    over-read check is the backstop, trailing-padding tolerance the
    limit. First action with conformance material: diff this parse
    against a real VUI-bearing CTC stream."""

    timing_info_present_flag: bool = False
    num_units_in_tick: int = 1001
    time_scale: int = 60000
    poc_proportional_to_timing_flag: bool = False
    num_ticks_poc_diff_one_minus1: int = 0
    hrd_parameters_present_flag: bool = False
    hrd_parameters: Optional[HrdParameters] = None
    tile_restrictions_present_flag: bool = False
    fixed_atlas_tile_structure_flag: bool = False
    fixed_video_tile_structure_flag: bool = False
    constrained_tiles_across_v3c_components_idc: int = 0
    max_num_tiles_per_atlas_minus1: int = 0
    max_coded_video_resolution_present_flag: bool = False
    coded_max_video_width: int = 0
    coded_max_video_height: int = 0
    coordinate_system_parameters_present_flag: bool = False
    coordinate_system_parameters: Optional[CoordinateSystemParameters] = None
    unit_in_metres_flag: bool = False
    display_box_info_present_flag: bool = False
    display_box_origin: List[int] = field(default_factory=lambda: [0, 0, 0])
    display_box_size: List[int] = field(default_factory=lambda: [0, 0, 0])
    anchor_point_present_flag: bool = False
    anchor_point: List[int] = field(default_factory=lambda: [0, 0, 0])

    @classmethod
    def parse(cls, bs: Bitstream) -> "VuiParameters":
        vui = cls()
        vui.timing_info_present_flag = bs.read(1) != 0
        if vui.timing_info_present_flag:
            vui.num_units_in_tick = bs.read(32)
            vui.time_scale = bs.read(32)
            vui.poc_proportional_to_timing_flag = bs.read(1) != 0
            if vui.poc_proportional_to_timing_flag:
                vui.num_ticks_poc_diff_one_minus1 = bs.read_uvlc()
            vui.hrd_parameters_present_flag = bs.read(1) != 0
            if vui.hrd_parameters_present_flag:
                vui.hrd_parameters = HrdParameters.parse(bs)
        vui.tile_restrictions_present_flag = bs.read(1) != 0
        if vui.tile_restrictions_present_flag:
            vui.fixed_atlas_tile_structure_flag = bs.read(1) != 0
            vui.fixed_video_tile_structure_flag = bs.read(1) != 0
            vui.constrained_tiles_across_v3c_components_idc = bs.read_uvlc()
            vui.max_num_tiles_per_atlas_minus1 = bs.read_uvlc()
        vui.max_coded_video_resolution_present_flag = bs.read(1) != 0
        if vui.max_coded_video_resolution_present_flag:
            vui.coded_max_video_width = bs.read_uvlc()
            vui.coded_max_video_height = bs.read_uvlc()
        vui.coordinate_system_parameters_present_flag = bs.read(1) != 0
        if vui.coordinate_system_parameters_present_flag:
            vui.coordinate_system_parameters = (
                CoordinateSystemParameters.parse(bs)
            )
        vui.unit_in_metres_flag = bs.read(1) != 0
        vui.display_box_info_present_flag = bs.read(1) != 0
        if vui.display_box_info_present_flag:
            for d in range(3):
                vui.display_box_origin[d] = bs.read_uvlc()
                vui.display_box_size[d] = bs.read_uvlc()
            vui.anchor_point_present_flag = bs.read(1) != 0
            if vui.anchor_point_present_flag:
                for d in range(3):
                    vui.anchor_point[d] = bs.read_uvlc()
        return vui


@dataclass
class AtlasSequenceParameterSet:
    """8.3.6.1 ASPS (``reader.rs:945-1117``), rec0 envelope enforced."""

    atlas_sequence_parameter_set_id: int = 0
    frame_width: int = 0
    frame_height: int = 0
    geometry_2d_bitdepth_minus1: int = 0
    geometry_3d_bitdepth_minus1: int = 0
    log2_max_atlas_frame_order_cnt_lsb_minus_4: int = 4
    max_dec_atlas_frame_buffering_minus1: int = 0
    long_term_ref_atlas_frames_flag: bool = False
    num_ref_atlas_frame_lists_in_asps: int = 0
    ref_list_struct: List[RefListStruct] = field(default_factory=list)
    use_eight_orientations_flag: bool = False
    extended_projection_enabled_flag: bool = False
    max_number_projections_minus1: int = 5
    normal_axis_limits_quantization_enabled_flag: bool = True
    normal_axis_max_delta_value_enabled_flag: bool = False
    patch_precedence_order_flag: bool = False
    log2_patch_packing_block_size: int = 0
    patch_size_quantizer_present_flag: bool = False
    map_count_minus1: int = 0
    pixel_deinterleaving_flag: bool = False
    raw_patch_enabled_flag: bool = False
    eom_patch_enabled_flag: bool = False
    eom_fix_bit_count_minus1: int = 0
    auxiliary_video_enabled_flag: bool = False
    plr_enabled_flag: bool = False
    plr_information: List[PlrInformation] = field(default_factory=list)
    vui_parameters_present_flag: bool = False
    vui_parameters: Optional[VuiParameters] = None
    extension_flag: bool = False
    vpcc_extension_flag: bool = False
    extension_7bits: int = 0
    vpcc_extension: AspsVpccExtension = field(default_factory=AspsVpccExtension)

    @classmethod
    def parse(cls, bs: Bitstream) -> "AtlasSequenceParameterSet":
        asps = cls()
        asps.atlas_sequence_parameter_set_id = bs.read_uvlc()
        asps.frame_width = bs.read_uvlc()
        asps.frame_height = bs.read_uvlc()
        asps.geometry_3d_bitdepth_minus1 = bs.read(5)
        asps.geometry_2d_bitdepth_minus1 = bs.read(5)
        asps.log2_max_atlas_frame_order_cnt_lsb_minus_4 = bs.read_uvlc()
        asps.max_dec_atlas_frame_buffering_minus1 = bs.read_uvlc()
        asps.long_term_ref_atlas_frames_flag = bs.read(1) != 0
        asps.num_ref_atlas_frame_lists_in_asps = bs.read_uvlc()
        for _ in range(asps.num_ref_atlas_frame_lists_in_asps):
            asps.ref_list_struct.append(
                RefListStruct.parse(
                    bs,
                    asps.long_term_ref_atlas_frames_flag,
                    asps.log2_max_atlas_frame_order_cnt_lsb_minus_4 + 4,
                )
            )
        asps.use_eight_orientations_flag = bs.read(1) != 0
        asps.extended_projection_enabled_flag = bs.read(1) != 0
        if asps.extended_projection_enabled_flag:
            # FRAMEWORK EXTENSION: 45-degree (additional-plane)
            # projections decode here — the reference parses the
            # max-projections count but asserts the flag false
            # (``reader.rs:1042-1045``) and its reconstruction is
            # ``unimplemented!`` (``codec.rs:429-440``)
            asps.max_number_projections_minus1 = bs.read_uvlc()
            if asps.max_number_projections_minus1 > 17:
                raise UnsupportedFeature(
                    f"max projections {asps.max_number_projections_minus1 + 1}"
                    " beyond the 18-view table"
                )
        asps.normal_axis_limits_quantization_enabled_flag = bs.read(1) != 0
        asps.normal_axis_max_delta_value_enabled_flag = bs.read(1) != 0
        asps.patch_precedence_order_flag = bs.read(1) != 0
        asps.log2_patch_packing_block_size = bs.read(3)
        # FRAMEWORK EXTENSION: quantized patch sizes decode (the
        # reference asserts the flag false, ``reader.rs:1052``); the
        # tile header carries the two 3-bit quantizers and the intra
        # derivation trims points past the patch's pixel extent
        asps.patch_size_quantizer_present_flag = bs.read(1) != 0
        asps.map_count_minus1 = bs.read(4)
        asps.pixel_deinterleaving_flag = bs.read(1) != 0
        if asps.pixel_deinterleaving_flag and asps.map_count_minus1 != 0:
            # FRAMEWORK EXTENSION: single-map pixel-interleaved geometry
            # decodes (reconstruction/pixel_interleave.py); the
            # reference asserts the flag false (``reader.rs:1066``)
            raise UnsupportedFeature(
                "pixel deinterleaving with more than one map"
            )
        asps.raw_patch_enabled_flag = bs.read(1) != 0
        asps.eom_patch_enabled_flag = bs.read(1) != 0
        # FRAMEWORK EXTENSION: raw AND EOM patches decode here (in the
        # geometry/attribute/occupancy video; see
        # reconstruction/raw_points.py and reconstruction/eom_points.py).
        # The reference asserts both flags false (``reader.rs:1066-1069``).
        if asps.eom_patch_enabled_flag and asps.map_count_minus1 == 0:
            # single-map EOM: codewords have a FIXED bit count (no D1
            # surface bounds them) — the reconstruction validates every
            # codeword against it (reconstruction/eom_points.py)
            asps.eom_fix_bit_count_minus1 = bs.read(4)
        if asps.raw_patch_enabled_flag or asps.eom_patch_enabled_flag:
            # FRAMEWORK EXTENSION: raw/EOM patches in a separate
            # auxiliary video sub-stream decode too (aux-flagged
            # GVD/AVD units; see reconstruction/raw_points.py) — the
            # reference never demuxes one (``reader.rs:74``)
            asps.auxiliary_video_enabled_flag = bs.read(1) != 0
        asps.plr_enabled_flag = bs.read(1) != 0
        if asps.plr_enabled_flag:
            # FRAMEWORK EXTENSION: point-local reconstruction (the
            # reference panics here, ``reader.rs:1082``); the
            # reconstruction envelope is the single-map form
            # (reconstruction/plr_points.py)
            if asps.map_count_minus1 != 0:
                raise UnsupportedFeature("PLR with more than one map")
            asps.plr_information = [
                PlrInformation.parse(bs)
                for _ in range(asps.map_count_minus1 + 1)
            ]
        if asps.patch_size_quantizer_present_flag and (
            asps.plr_enabled_flag or asps.eom_patch_enabled_flag
        ):
            # PLR/EOM derive points from occupied pixels of regular
            # patches; combining them with the quantized-extent trim is
            # outside the reconstruction envelope
            raise UnsupportedFeature(
                "patch size quantizer combined with PLR/EOM patches"
            )
        asps.vui_parameters_present_flag = bs.read(1) != 0
        if asps.vui_parameters_present_flag:
            # FRAMEWORK EXTENSION: the reference panics here
            # (``reader.rs:1089``) — mid-ASPS syntax it cannot skip.
            # VUI is display/timing metadata; parsing it restores the
            # bit cursor for the remaining ASPS fields.
            asps.vui_parameters = VuiParameters.parse(bs)
        asps.extension_flag = bs.read(1) != 0
        if asps.extension_flag:
            asps.vpcc_extension_flag = bs.read(1) != 0
            asps.extension_7bits = bs.read(7)
        if asps.vpcc_extension_flag:
            asps.vpcc_extension = AspsVpccExtension(
                remove_duplicate_point_enabled_flag=bs.read(1) != 0,
                surface_thickness_minus1=(
                    bs.read(7)
                    if asps.pixel_deinterleaving_flag or asps.plr_enabled_flag
                    else 0
                ),
            )
        if asps.extension_7bits > 0:
            raise UnsupportedFeature("asps extension_7bits not supported")
        bs.byte_align()
        return asps


@dataclass
class AtlasFrameTileInformation:
    """8.3.6.2.2 AFTI (``reader.rs:1217-1329``).

    FRAMEWORK EXTENSION: atlas frame partitioning decodes (the
    reference asserts single-tile, ``reader.rs:1266-1270``, and keeps
    every partition field commented out). Partition units are 64 pixels
    (23090-5); the last column/row takes the frame remainder. Tile
    rects come from :meth:`tile_rect`; each frame's tiles are folded
    onto the atlas canvas by the patch-frame builder
    (``atlas/patches.py``), so reconstruction sees one frame-sized
    patch list."""

    single_tile_in_atlas_frame_flag: bool = True
    uniform_partition_spacing_flag: bool = True
    partition_cols_width_minus1: int = 0  # units of 64 px
    partition_rows_height_minus1: int = 0
    num_partition_columns_minus1: int = 0
    num_partition_rows_minus1: int = 0
    partition_column_width_minus1: List[int] = field(default_factory=list)
    partition_row_height_minus1: List[int] = field(default_factory=list)
    single_partition_per_tile_flag: bool = True
    num_tiles_in_atlas_frame_minus1: int = 0
    top_left_partition_idx: List[int] = field(default_factory=list)
    bottom_right_partition_column_offset: List[int] = field(default_factory=list)
    bottom_right_partition_row_offset: List[int] = field(default_factory=list)
    signalled_tile_id_flag: bool = False
    signalled_tile_id_length_minus1: int = 0
    tile_id: List[int] = field(default_factory=list)
    auxiliary_video_tile_row_width_minus1: int = 0
    auxiliary_video_tile_row_height: List[int] = field(default_factory=list)
    # partition sizes, set later by the patch-frame builder
    # (``decoder.rs:520-538`` via set_partition_width/height)
    col_width: int = 0
    row_height: int = 0

    def partition_grid(self, frame_w: int, frame_h: int):
        """Per-column widths and per-row heights in PIXELS. The frame
        must cover every explicit partition; the last column/row is the
        (positive) remainder."""
        if self.single_tile_in_atlas_frame_flag:
            return [frame_w], [frame_h]
        if self.uniform_partition_spacing_flag:
            w64 = (self.partition_cols_width_minus1 + 1) * 64
            h64 = (self.partition_rows_height_minus1 + 1) * 64
            ncols = max(1, -(-frame_w // w64))
            nrows = max(1, -(-frame_h // h64))
            cols = [w64] * (ncols - 1) + [frame_w - (ncols - 1) * w64]
            rows = [h64] * (nrows - 1) + [frame_h - (nrows - 1) * h64]
        else:
            cols = [(v + 1) * 64 for v in self.partition_column_width_minus1]
            rows = [(v + 1) * 64 for v in self.partition_row_height_minus1]
            cols.append(frame_w - sum(cols))
            rows.append(frame_h - sum(rows))
        if cols[-1] <= 0 or rows[-1] <= 0:
            raise UnsupportedFeature(
                f"AFTI partitions exceed the {frame_w}x{frame_h} frame"
            )
        return cols, rows

    def tile_count(self) -> int:
        return self.num_tiles_in_atlas_frame_minus1 + 1

    def tile_index_of(self, ath_id: int) -> int:
        """ath_id -> tile index (identity unless ids are signalled)."""
        if not self.signalled_tile_id_flag:
            return ath_id
        try:
            return self.tile_id.index(ath_id)
        except ValueError:
            raise UnsupportedFeature(
                f"tile id {ath_id} not in the signalled id list "
                f"{self.tile_id}"
            ) from None

    def tile_rect(self, tile_idx: int, frame_w: int, frame_h: int):
        """(x, y, w, h) pixel rect of a tile on the atlas canvas."""
        if self.single_tile_in_atlas_frame_flag:
            return 0, 0, frame_w, frame_h
        cols, rows = self.partition_grid(frame_w, frame_h)
        ncols = len(cols)
        if tile_idx > self.num_tiles_in_atlas_frame_minus1:
            raise UnsupportedFeature(
                f"tile index {tile_idx} beyond the AFTI's "
                f"{self.tile_count()} tiles"
            )
        if self.single_partition_per_tile_flag:
            tl, brc, brr = tile_idx, 0, 0
        else:
            tl = self.top_left_partition_idx[tile_idx]
            brc = self.bottom_right_partition_column_offset[tile_idx]
            brr = self.bottom_right_partition_row_offset[tile_idx]
        c0, r0 = tl % ncols, tl // ncols
        if c0 + brc >= ncols or r0 + brr >= len(rows):
            raise UnsupportedFeature(
                f"tile {tile_idx} partition rect ({c0}+{brc}, {r0}+{brr}) "
                f"leaves the {ncols}x{len(rows)} partition grid"
            )
        x = sum(cols[:c0])
        y = sum(rows[:r0])
        w = sum(cols[c0 : c0 + brc + 1])
        h = sum(rows[r0 : r0 + brr + 1])
        return x, y, w, h

    @classmethod
    def parse(cls, bs: Bitstream, asps: AtlasSequenceParameterSet) -> "AtlasFrameTileInformation":
        afti = cls(single_tile_in_atlas_frame_flag=bs.read(1) != 0)
        if not afti.single_tile_in_atlas_frame_flag:
            afti.uniform_partition_spacing_flag = bs.read(1) != 0
            if afti.uniform_partition_spacing_flag:
                afti.partition_cols_width_minus1 = bs.read_uvlc()
                afti.partition_rows_height_minus1 = bs.read_uvlc()
            else:
                afti.num_partition_columns_minus1 = bs.read_uvlc()
                afti.num_partition_rows_minus1 = bs.read_uvlc()
                afti.partition_column_width_minus1 = [
                    bs.read_uvlc()
                    for _ in range(afti.num_partition_columns_minus1)
                ]
                afti.partition_row_height_minus1 = [
                    bs.read_uvlc()
                    for _ in range(afti.num_partition_rows_minus1)
                ]
            cols, rows = afti.partition_grid(
                asps.frame_width, asps.frame_height
            )
            n_partitions = len(cols) * len(rows)
            afti.single_partition_per_tile_flag = bs.read(1) != 0
            if not afti.single_partition_per_tile_flag:
                afti.num_tiles_in_atlas_frame_minus1 = bs.read_uvlc()
                idx_bits = ceil_log2(n_partitions)
                for _ in range(afti.num_tiles_in_atlas_frame_minus1 + 1):
                    afti.top_left_partition_idx.append(bs.read(idx_bits))
                    afti.bottom_right_partition_column_offset.append(
                        bs.read_uvlc()
                    )
                    afti.bottom_right_partition_row_offset.append(
                        bs.read_uvlc()
                    )
            else:
                afti.num_tiles_in_atlas_frame_minus1 = n_partitions - 1
        else:
            afti.num_tiles_in_atlas_frame_minus1 = 0
        if asps.auxiliary_video_enabled_flag:
            afti.auxiliary_video_tile_row_width_minus1 = bs.read_uvlc()
            for _ in range(afti.num_tiles_in_atlas_frame_minus1 + 1):
                afti.auxiliary_video_tile_row_height.append(bs.read_uvlc())
        afti.signalled_tile_id_flag = bs.read(1) != 0
        if afti.signalled_tile_id_flag:
            afti.signalled_tile_id_length_minus1 = bs.read_uvlc()
            id_bits = afti.signalled_tile_id_length_minus1 + 1
            afti.tile_id = [
                bs.read(id_bits)
                for _ in range(afti.num_tiles_in_atlas_frame_minus1 + 1)
            ]
            if len(set(afti.tile_id)) != len(afti.tile_id):
                raise UnsupportedFeature(
                    f"duplicate signalled tile ids {afti.tile_id}"
                )
        return afti


@dataclass
class AtlasFrameParameterSet:
    """8.3.6.2 AFPS (``reader.rs:1175-1215``)."""

    atlas_frame_parameter_set_id: int = 0
    atlas_sequence_parameter_set_id: int = 0
    atlas_frame_tile_information: AtlasFrameTileInformation = field(
        default_factory=AtlasFrameTileInformation
    )
    output_flag_present_flag: bool = False
    num_ref_idx_default_active_minus1: int = 0
    additional_lt_afoc_lsb_len: int = 0
    lod_mode_enable_flag: bool = False
    raw_3d_offset_bitcount_explicit_mode_flag: bool = False
    extension_flag: bool = False
    extension_8bits: int = 0

    @classmethod
    def parse(cls, bs: Bitstream, context) -> "AtlasFrameParameterSet":
        afps = cls()
        afps.atlas_frame_parameter_set_id = bs.read_uvlc()
        afps.atlas_sequence_parameter_set_id = bs.read_uvlc()
        asps = context.get_asps(afps.atlas_sequence_parameter_set_id)
        afps.atlas_frame_tile_information = AtlasFrameTileInformation.parse(bs, asps)
        afps.output_flag_present_flag = bs.read(1) != 0
        afps.num_ref_idx_default_active_minus1 = bs.read_uvlc()
        afps.additional_lt_afoc_lsb_len = bs.read_uvlc()
        afps.lod_mode_enable_flag = bs.read(1) != 0
        afps.raw_3d_offset_bitcount_explicit_mode_flag = bs.read(1) != 0
        afps.extension_flag = bs.read(1) != 0
        if afps.extension_flag:
            afps.extension_8bits = bs.read(8)
        if afps.extension_8bits > 0:
            raise UnsupportedFeature("afps extension not supported")
        bs.byte_align()
        return afps


# ---------------------------------------------------------------------------
# SEI
# ---------------------------------------------------------------------------


@dataclass
class SeiGeometrySmoothing:
    """H.20.2.19 geometry smoothing SEI (``reader.rs:1452-1505``)."""

    persistence_flag: bool = False
    reset_flag: bool = False
    instances_updated: int = 0
    instance_index: List[int] = field(default_factory=list)
    instance_cancel_flag: List[bool] = field(default_factory=list)
    method_type: List[int] = field(default_factory=list)
    filter_eom_points_flag: List[bool] = field(default_factory=list)
    grid_size_minus_2: List[int] = field(default_factory=list)
    threshold: List[int] = field(default_factory=list)

    payload_type = SeiPayloadType.GEOMETRY_SMOOTHING

    @classmethod
    def parse(cls, bs: Bitstream) -> "SeiGeometrySmoothing":
        sei = cls(
            persistence_flag=bs.read(1) != 0,
            reset_flag=bs.read(1) != 0,
            instances_updated=bs.read(8),
        )
        n = sei.instances_updated
        sei.instance_index = [0] * n
        sei.instance_cancel_flag = [False] * n
        sei.method_type = [0] * n
        sei.filter_eom_points_flag = [False] * n
        sei.grid_size_minus_2 = [0] * n
        sei.threshold = [0] * n
        for i in range(n):
            sei.instance_index[i] = bs.read(8)
            k = sei.instance_index[i]
            if k >= n:
                # corrupted stream: the instance id indexes arrays
                # sized by instances_updated (the reference would
                # panic on the same out-of-range Vec index)
                raise BitstreamError(
                    f"geometry-smoothing SEI instance index {k} >= "
                    f"instances_updated {n}"
                )
            sei.instance_cancel_flag[k] = bs.read(1) != 0
            if sei.instance_cancel_flag[k]:
                continue
            sei.method_type[k] = bs.read_uvlc()
            if sei.method_type[k] == 1:
                sei.filter_eom_points_flag[k] = bs.read(1) != 0
                sei.grid_size_minus_2[k] = bs.read(7)
                sei.threshold[k] = bs.read(8)
        return sei


@dataclass
class SeiAttributeSmoothing:
    """H.20.2.20 attribute smoothing SEI.

    The reference cannot parse this payload at all (its SEI dispatch
    panics on anything but geometry smoothing, ``reader.rs:1402-1412``);
    implemented here per the 23090-5 syntax shape so attribute smoothing
    reconstruction is reachable — exceeding reference parity.
    """

    persistence_flag: bool = False
    reset_flag: bool = False
    num_attributes_updated: int = 0
    attribute_idx: List[int] = field(default_factory=list)
    attribute_smoothing_cancel_flag: List[bool] = field(default_factory=list)
    instances_updated: List[int] = field(default_factory=list)
    # per (attribute, instance): keyed dicts indexed [j][k]
    instance_index: List[List[int]] = field(default_factory=list)
    instance_cancel_flag: List[List[bool]] = field(default_factory=list)
    method_type: List[List[int]] = field(default_factory=list)
    grid_size_minus_2: List[List[int]] = field(default_factory=list)
    threshold: List[List[int]] = field(default_factory=list)
    threshold_variation: List[List[int]] = field(default_factory=list)
    threshold_difference: List[List[int]] = field(default_factory=list)

    payload_type = SeiPayloadType.ATTRIBUTE_SMOOTHING

    @classmethod
    def parse(cls, bs: Bitstream) -> "SeiAttributeSmoothing":
        sei = cls(
            persistence_flag=bs.read(1) != 0,
            reset_flag=bs.read(1) != 0,
            num_attributes_updated=bs.read_uvlc(),
        )
        for _j in range(sei.num_attributes_updated):
            sei.attribute_idx.append(bs.read(7))
            cancel = bs.read(1) != 0
            sei.attribute_smoothing_cancel_flag.append(cancel)
            n = bs.read(8)
            sei.instances_updated.append(n)
            idxs, cancels, methods = [0] * n, [False] * n, [0] * n
            grids, thrs, thr_vars, thr_diffs = [0] * n, [0] * n, [0] * n, [0] * n
            for _i in range(n):
                k = bs.read(8)
                idxs[_i] = k
                cancels[_i] = bs.read(1) != 0
                if cancels[_i]:
                    continue
                methods[_i] = bs.read_uvlc()
                if methods[_i] == 1:
                    grids[_i] = bs.read(8)
                    thrs[_i] = bs.read(8)
                    thr_vars[_i] = bs.read(8)
                    thr_diffs[_i] = bs.read(8)
            sei.instance_index.append(idxs)
            sei.instance_cancel_flag.append(cancels)
            sei.method_type.append(methods)
            sei.grid_size_minus_2.append(grids)
            sei.threshold.append(thrs)
            sei.threshold_variation.append(thr_vars)
            sei.threshold_difference.append(thr_diffs)
        return sei


@dataclass
class SeiOccupancySynthesis:
    """H.20.2.18 occupancy synthesis (PBF) SEI.

    The reference cannot parse this payload (``reader.rs:1402-1412``
    panics) and its reconstruction is ``unimplemented!``
    (``decoder.rs:240-242``); parsed here per the 23090-5 syntax shape,
    and method 1 (PBF) ACTS when the apply toggle is set —
    ``reconstruction/occupancy_synthesis.py``."""

    persistence_flag: bool = False
    reset_flag: bool = False
    instances_updated: int = 0
    instance_index: List[int] = field(default_factory=list)
    instance_cancel_flag: List[bool] = field(default_factory=list)
    method_type: List[int] = field(default_factory=list)
    pbf_log2_threshold_minus1: List[int] = field(default_factory=list)
    pbf_passes_count_minus1: List[int] = field(default_factory=list)
    pbf_filter_size_minus1: List[int] = field(default_factory=list)

    payload_type = SeiPayloadType.OCCUPANCY_SYNTHESIS

    @classmethod
    def parse(cls, bs: Bitstream) -> "SeiOccupancySynthesis":
        sei = cls(
            persistence_flag=bs.read(1) != 0,
            reset_flag=bs.read(1) != 0,
            instances_updated=bs.read(8),
        )
        n = sei.instances_updated
        sei.instance_index = [0] * n
        sei.instance_cancel_flag = [False] * n
        sei.method_type = [0] * n
        sei.pbf_log2_threshold_minus1 = [0] * n
        sei.pbf_passes_count_minus1 = [0] * n
        sei.pbf_filter_size_minus1 = [0] * n
        # fields stored by LOOP index (like SeiAttributeSmoothing): this
        # payload is a framework extension with no reference parity
        # constraint, and instance_index is a free u8 that may exceed
        # instances_updated (the geometry-smoothing parser's k-indexing
        # is deliberate parity with reader.rs:1452-1505 instead)
        for i in range(n):
            sei.instance_index[i] = bs.read(8)
            sei.instance_cancel_flag[i] = bs.read(1) != 0
            if sei.instance_cancel_flag[i]:
                continue
            sei.method_type[i] = bs.read_uvlc()
            if sei.method_type[i] == 1:
                sei.pbf_log2_threshold_minus1[i] = bs.read(2)
                sei.pbf_passes_count_minus1[i] = bs.read(2)
                sei.pbf_filter_size_minus1[i] = bs.read(3)
        return sei


@dataclass
class SeiDecodedAtlasInformationHash:
    """H.20.2.8 decoded atlas information hash SEI (suffix).

    FRAMEWORK EXTENSION: the reference skips hash SEI wholesale
    (``lib.rs:100`` — "skip decoded atlas hash md5"). Here the payload
    parses and the decoder VERIFIES it against hashes recomputed from
    its own decoded state (``atlas/atlas_hash.py``) — the first internal
    integrity check independent of the test oracle. ``hash_type``:
    0 = MD5 (16 B), 1 = CRC-16 (2 B), 2 = checksum (4 B)."""

    cancel_flag: bool = False
    persistence_flag: bool = False
    hash_type: int = 0
    high_level_present: bool = False
    atlas_present: bool = False
    b2p_present: bool = False
    tiles_present: bool = False
    tiles_b2p_present: bool = False
    high_level_hash: bytes = b""
    atlas_hash: bytes = b""
    b2p_hash: bytes = b""
    tile_ids: List[int] = field(default_factory=list)
    tiles_hash: List[bytes] = field(default_factory=list)
    tiles_b2p_hash: List[bytes] = field(default_factory=list)

    payload_type = SeiPayloadType.DECODED_ATLAS_INFORMATION_HASH

    _HASH_BYTES = {0: 16, 1: 2, 2: 4}

    @classmethod
    def _read_hash(cls, bs: Bitstream, hash_type: int) -> bytes:
        n = cls._HASH_BYTES.get(hash_type)
        if n is None:
            raise UnsupportedFeature(
                f"decoded-atlas-hash SEI hash type {hash_type}"
            )
        return bytes(bs.read(8) for _ in range(n))

    @classmethod
    def parse(cls, bs: Bitstream) -> "SeiDecodedAtlasInformationHash":
        sei = cls(cancel_flag=bs.read(1) != 0)
        if sei.cancel_flag:
            return sei
        sei.persistence_flag = bs.read(1) != 0
        sei.hash_type = bs.read(8)
        sei.high_level_present = bs.read(1) != 0
        sei.atlas_present = bs.read(1) != 0
        sei.b2p_present = bs.read(1) != 0
        sei.tiles_present = bs.read(1) != 0
        sei.tiles_b2p_present = bs.read(1) != 0
        bs.byte_align()
        if sei.high_level_present:
            sei.high_level_hash = cls._read_hash(bs, sei.hash_type)
        if sei.atlas_present:
            sei.atlas_hash = cls._read_hash(bs, sei.hash_type)
        if sei.b2p_present:
            sei.b2p_hash = cls._read_hash(bs, sei.hash_type)
        if sei.tiles_present or sei.tiles_b2p_present:
            num_tiles = bs.read_uvlc() + 1
            id_len = bs.read_uvlc() + 1
            sei.tile_ids = [bs.read(id_len) for _ in range(num_tiles)]
            bs.byte_align()
            for _ in range(num_tiles):
                if sei.tiles_present:
                    sei.tiles_hash.append(cls._read_hash(bs, sei.hash_type))
                if sei.tiles_b2p_present:
                    sei.tiles_b2p_hash.append(
                        cls._read_hash(bs, sei.hash_type)
                    )
        return sei


@dataclass
class SeiUnknown:
    """An unrecognized prefix SEI payload, recorded but not interpreted.

    Framework extension: the reference panics on any payload it does not
    implement (``reader.rs:1402-1412``), which would abort the whole
    stream; NAL units are sized, so skipping is always safe (the demuxer
    reseeks to the unit boundary) and presence queries keep working."""

    payload_type: int = int(SeiPayloadType.RESERVED_SEI_MESSAGE)
    payload_size: int = 0


@dataclass
class SeiMessage:
    """An SEI RBSP holding parsed prefix/suffix payloads (``reader.rs:1331-1435``)."""

    sei_prefix: List[object] = field(default_factory=list)
    sei_suffix: List[object] = field(default_factory=list)

    @classmethod
    def parse(
        cls, bs: Bitstream, nal_unit_type: NalUnitType, end_byte: int = -1
    ) -> "SeiMessage":
        msg = cls()
        if nal_unit_type.is_suffix_sei:
            # Record-and-skip: suffix SEI payloads (decoded-atlas hashes
            # and the like) are advisory — nothing the rec0 reconstruction
            # consumes. The reference panics on every suffix SEI NAL
            # (``reader.rs:813-815``); here every sei_message() in the
            # RBSP is skipped by its coded size and recorded so
            # ``is_sei_present`` keeps working. An SEI RBSP may carry
            # several payloads; with ``end_byte`` (the sized-NAL
            # boundary) known, loop until only the rbsp_trailing_bits
            # byte remains.
            while True:
                payload_type, payload_size = cls._read_payload_header(bs)
                payload_end = bs.byte_pos + payload_size
                if payload_end > len(bs.data):
                    # a declared size past the buffer is corruption, not
                    # skippable padding (the former byte-wise skip raised
                    # here too)
                    raise BitstreamError(
                        f"suffix SEI payload size {payload_size} overruns "
                        f"the bitstream ({payload_end} > {len(bs.data)})"
                    )
                if payload_type == SeiPayloadType.DECODED_ATLAS_INFORMATION_HASH:
                    # parsed AND verified (pipeline.prepare_gof recomputes
                    # the hashes from decoded state; atlas/atlas_hash.py).
                    # Reserved hash types are ignorable — nothing to
                    # verify — so they fall back to record-and-skip.
                    try:
                        daih = SeiDecodedAtlasInformationHash.parse(bs)
                    except UnsupportedFeature:
                        daih = SeiUnknown(
                            payload_type=payload_type,
                            payload_size=payload_size,
                        )
                    msg.sei_suffix.append(daih)
                    if bs.byte_pos > payload_end:
                        raise BitstreamError(
                            "decoded-atlas-hash SEI over-read: "
                            f"{bs.byte_pos} > {payload_end}"
                        )
                    bs.seek((payload_end, 0))
                else:
                    for _ in range(payload_size):
                        bs.read(8)
                    msg.sei_suffix.append(
                        SeiUnknown(
                            payload_type=payload_type,
                            payload_size=payload_size,
                        )
                    )
                if end_byte < 0 or end_byte - bs.byte_pos <= 1:
                    break
            return msg
        payload_type, payload_size = cls._read_payload_header(bs)
        # the reference panics on any payload but geometry smoothing
        # (``reader.rs:1402-1412``); attribute smoothing and occupancy
        # synthesis are parsed here, and anything else is recorded and
        # skipped by its coded size (NAL units are sized, so the demuxer
        # reseeks to the unit boundary regardless) — framework extension
        if payload_type == SeiPayloadType.GEOMETRY_SMOOTHING:
            msg.sei_prefix.append(SeiGeometrySmoothing.parse(bs))
        elif payload_type == SeiPayloadType.ATTRIBUTE_SMOOTHING:
            msg.sei_prefix.append(SeiAttributeSmoothing.parse(bs))
        elif payload_type == SeiPayloadType.OCCUPANCY_SYNTHESIS:
            msg.sei_prefix.append(SeiOccupancySynthesis.parse(bs))
        else:
            for _ in range(payload_size):
                bs.read(8)
            msg.sei_prefix.append(
                SeiUnknown(payload_type=payload_type, payload_size=payload_size)
            )
            # no byte_align/trailing-byte here: that framing is a TMC2
            # convention for payloads it writes; the sized-NAL reseek in
            # the demuxer makes any remainder harmless
            return msg
        bs.byte_align()
        # TMC2 consumes one extra trailing byte after prefix SEI payloads;
        # replicated from the reference hack (``reader.rs:1414-1417``).
        # That hack makes multi-payload prefix NALs unframeable, so one
        # parsed payload per prefix NAL is assumed (as in the reference).
        bs.read(8)
        return msg

    @staticmethod
    def _read_payload_header(bs: Bitstream):
        """The 0xFF-extended payload type/size varints (``reader.rs:1378-1395``)."""
        payload_type = 0
        while True:
            byte = bs.read(8)
            payload_type += byte
            if byte != 0xFF:
                break
        payload_size = 0
        while True:
            byte = bs.read(8)
            payload_size += byte
            if byte != 0xFF:
                break
        return payload_type, payload_size

    def is_sei_present(self, nal_unit_type: NalUnitType, payload_type: SeiPayloadType) -> bool:
        if not (nal_unit_type.is_prefix_sei or nal_unit_type.is_suffix_sei):
            return False
        seis = self.sei_prefix if nal_unit_type.is_prefix_sei else self.sei_suffix
        return any(s.payload_type == payload_type for s in seis)


# ---------------------------------------------------------------------------
# Atlas tile layer: header + patch data units
# ---------------------------------------------------------------------------


@dataclass
class AtlasTileHeader:
    """8.3.6.11 atlas tile header (``reader.rs:1544-1690``)."""

    no_output_of_prior_atlas_frames_flag: bool = False
    frame_index: int = 0
    atlas_frame_parameter_set_id: int = 0
    atlas_adaptation_parameter_set_id: int = 0
    id: int = 0
    tile_type: TileType = TileType.P
    atlas_output_flag: bool = False
    atlas_frame_order_count_lsb: int = 0
    ref_atlas_frame_list_sps_flag: bool = False
    ref_atlas_frame_list_idx: int = 0
    additional_afoc_lsb_present_flag: List[bool] = field(default_factory=list)
    additional_afoc_lsb_val: List[int] = field(default_factory=list)
    pos_min_d_quantizer: int = 0
    pos_delta_max_d_quantizer: int = 0
    patch_size_info_quantizer: Tuple[int, int] = (0, 0)
    raw_3d_offset_axis_bitcount_minus1: int = 0
    num_ref_idx_active_override_flag: bool = False
    num_ref_idx_active_minus1: int = 0
    ref_list_struct: RefListStruct = field(default_factory=RefListStruct)
    tile_nalu_type_info: int = 0

    @classmethod
    def parse(cls, bs: Bitstream, context, nal_unit_type: NalUnitType) -> "AtlasTileHeader":
        ath = cls()
        if NalUnitType.BLA_W_LP <= nal_unit_type <= NalUnitType.GCRA:
            ath.no_output_of_prior_atlas_frames_flag = bs.read(1) != 0
        if nal_unit_type == NalUnitType.TRAIL_R:
            ath.tile_nalu_type_info = 1
        elif nal_unit_type == NalUnitType.TRAIL_N:
            ath.tile_nalu_type_info = 2
        ath.atlas_frame_parameter_set_id = bs.read_uvlc()
        ath.atlas_adaptation_parameter_set_id = bs.read_uvlc()
        afps = context.get_afps(ath.atlas_frame_parameter_set_id)
        asps = context.get_asps(afps.atlas_sequence_parameter_set_id)
        afti = afps.atlas_frame_tile_information
        if afti.signalled_tile_id_flag:
            ath.id = bs.read(afti.signalled_tile_id_length_minus1 + 1)
        elif afti.num_tiles_in_atlas_frame_minus1 != 0:
            ath.id = bs.read(ceil_log2(afti.num_tiles_in_atlas_frame_minus1 + 1))
        else:
            ath.id = 0
        ath.tile_type = TileType(bs.read_uvlc())
        if afps.output_flag_present_flag:
            ath.atlas_output_flag = bs.read(1) != 0
        ath.atlas_frame_order_count_lsb = bs.read(
            asps.log2_max_atlas_frame_order_cnt_lsb_minus_4 + 4
        )
        if asps.num_ref_atlas_frame_lists_in_asps > 0:
            ath.ref_atlas_frame_list_sps_flag = bs.read(1) != 0
        ath.ref_atlas_frame_list_idx = 0
        if not ath.ref_atlas_frame_list_sps_flag:
            ath.ref_list_struct = RefListStruct.parse(
                bs,
                asps.long_term_ref_atlas_frames_flag,
                asps.log2_max_atlas_frame_order_cnt_lsb_minus_4 + 4,
            )
        else:
            ath.ref_list_struct = asps.ref_list_struct[ath.ref_atlas_frame_list_idx]
        if asps.num_ref_atlas_frame_lists_in_asps > 1:
            ath.ref_atlas_frame_list_idx = bs.read(
                ceil_log2(asps.num_ref_atlas_frame_lists_in_asps)
            )
        ref_list = (
            asps.ref_list_struct[ath.ref_atlas_frame_list_idx]
            if ath.ref_atlas_frame_list_sps_flag
            else ath.ref_list_struct
        )
        num_ltr = sum(1 for st in ref_list.st_ref_atlas_frame_flag if not st)
        for j in range(num_ltr):
            ath.additional_afoc_lsb_present_flag.append(bs.read(1) != 0)
            if ath.additional_afoc_lsb_present_flag[j]:
                ath.additional_afoc_lsb_val.append(bs.read(afps.additional_lt_afoc_lsb_len))
        if ath.tile_type != TileType.SKIP:
            if asps.normal_axis_limits_quantization_enabled_flag:
                ath.pos_min_d_quantizer = bs.read(5)
                ath.pos_delta_max_d_quantizer = bs.read(5)
            if asps.patch_size_quantizer_present_flag:
                ath.patch_size_info_quantizer = (bs.read(3), bs.read(3))
            if afps.raw_3d_offset_bitcount_explicit_mode_flag:
                bit_count = floor_log2(asps.geometry_3d_bitdepth_minus1 + 1)
                ath.raw_3d_offset_axis_bitcount_minus1 = bs.read(bit_count)
            else:
                # The reference computes max(0, g3d_m1 - g2d_m1) - 1 in u8
                # arithmetic (``reader.rs:1675-1678``), which wraps to 255
                # when the bitdepths are equal. Only used by raw patches
                # (unsupported); replicate the wrapping semantics.
                ath.raw_3d_offset_axis_bitcount_minus1 = (
                    max(0, asps.geometry_3d_bitdepth_minus1 - asps.geometry_2d_bitdepth_minus1)
                    - 1
                ) % 256
            if ath.tile_type == TileType.P and ref_list.num_ref_entries > 1:
                ath.num_ref_idx_active_override_flag = bs.read(1) != 0
                if ath.num_ref_idx_active_override_flag:
                    ath.num_ref_idx_active_minus1 = bs.read_uvlc()
        bs.byte_align()
        return ath


@dataclass
class IntraPatchDataUnit:
    """8.3.7.3 intra patch data unit (``reader.rs:1852-1923``)."""

    projection_id: int = 0
    orientation_index: PatchOrientation = PatchOrientation.DEFAULT
    lod_enabled_flag: bool = False
    lod_scale_x_minus1: int = 0
    lod_scale_y_idc: int = 0
    # one PlrData per map (None where plri_map_present_flag is 0);
    # empty when asps_plr_enabled_flag is 0
    plr_data: List[Optional["PlrData"]] = field(default_factory=list)
    pos_2d: Tuple[int, int] = (0, 0)
    size_2d_minus1: Tuple[int, int] = (0, 0)
    pos_3d_offset: Tuple[int, int] = (0, 0)
    pos_3d_offset_d: int = 0
    pos_3d_range_d: int = 0

    @classmethod
    def parse(cls, bs: Bitstream, context, ath: AtlasTileHeader,
              plr_size_state=None) -> "IntraPatchDataUnit":
        afps = context.get_afps(ath.atlas_frame_parameter_set_id)
        asps = context.get_asps(afps.atlas_sequence_parameter_set_id)
        bitcount_uv = asps.geometry_3d_bitdepth_minus1 + 1
        bitcount_d = asps.geometry_3d_bitdepth_minus1 - ath.pos_min_d_quantizer + 1
        pdu = cls()
        pdu.pos_2d = (bs.read_uvlc(), bs.read_uvlc())
        pdu.size_2d_minus1 = (bs.read_uvlc(), bs.read_uvlc())
        if plr_size_state is not None:
            # TMC2 parse-time size accumulator: intra sets it absolute
            # (inter/merge plrd block counts build on it)
            plr_size_state[0] = pdu.size_2d_minus1[0] + 1
            plr_size_state[1] = pdu.size_2d_minus1[1] + 1
        pdu.pos_3d_offset = (bs.read(bitcount_uv), bs.read(bitcount_uv))
        pdu.pos_3d_offset_d = bs.read(bitcount_d)
        if asps.normal_axis_max_delta_value_enabled_flag:
            bitcount_max_depth = (
                min(asps.geometry_2d_bitdepth_minus1, asps.geometry_3d_bitdepth_minus1)
                + 1
                - ath.pos_delta_max_d_quantizer
            )
            pdu.pos_3d_range_d = bs.read(bitcount_max_depth)
        pdu.projection_id = bs.read(ceil_log2(asps.max_number_projections_minus1 + 1))
        if pdu.projection_id > asps.max_number_projections_minus1:
            # views 6..17 are the 45-degree additional planes (framework
            # extension — the reference asserts id <= 5, ``reader.rs:1907``);
            # the ASPS's own ceiling still bounds every stream (<= 17,
            # pinned at the ASPS parse)
            raise UnsupportedFeature(
                f"projection_id {pdu.projection_id} beyond the ASPS's "
                f"{asps.max_number_projections_minus1 + 1} projections"
            )
        pdu.orientation_index = PatchOrientation(
            bs.read(3 if asps.use_eight_orientations_flag else 1)
        )
        if afps.lod_mode_enable_flag:
            # FRAMEWORK EXTENSION: LoD-scaled patches (23090-5 8.3.7.3;
            # the reference `unimplemented!`s here, ``reader.rs:1915``).
            # The whole reconstruction stack already carries
            # level_of_detail (G_LODX/G_LODY in the group tables, the
            # oracle's generate_point) — only this parse was missing.
            pdu.lod_enabled_flag = bs.read(1) != 0
            if pdu.lod_enabled_flag:
                pdu.lod_scale_x_minus1 = bs.read_uvlc()
                pdu.lod_scale_y_idc = bs.read_uvlc()
        if asps.plr_enabled_flag:
            # FRAMEWORK EXTENSION: 8.3.7.9 plr_data, one per
            # PLR-present map (``reconstruction/plr_points.py``; the
            # reference panics on the ASPS flag, ``reader.rs:1082``)
            block_count = (pdu.size_2d_minus1[0] + 1) * (
                pdu.size_2d_minus1[1] + 1
            )
            pdu.plr_data = [
                PlrData.parse(bs, plri, block_count)
                if plri.map_present_flag
                else None
                for plri in asps.plr_information
            ]
        return pdu


@dataclass
class PlrData:
    """8.3.7.9 point-local-reconstruction data, one per PLR-present map
    (FRAMEWORK EXTENSION — the reference panics on the ASPS flag before
    any PDU could carry this, ``reader.rs:1082``). ``*_mode_minus1``
    indexes the map's :class:`PlrInformation` mode list (0-based);
    a cleared present flag means no PLR points for the patch/block."""

    level_flag: bool = True  # True: one patch-level mode; False: per-block
    present_flag: bool = False
    mode_minus1: int = 0
    block_present_flag: List[bool] = field(default_factory=list)
    block_mode_minus1: List[int] = field(default_factory=list)

    @classmethod
    def parse(cls, bs: Bitstream, plri: PlrInformation, block_count: int) -> "PlrData":
        d = cls()
        if block_count > plri.block_threshold_per_patch_minus1 + 1:
            d.level_flag = bs.read(1) != 0
        mode_bits = ceil_log2(plri.number_of_modes)
        if d.level_flag:
            d.present_flag = bs.read(1) != 0
            if d.present_flag:
                d.mode_minus1 = bs.read(mode_bits)
        else:
            for _ in range(block_count):
                p = bs.read(1) != 0
                d.block_present_flag.append(p)
                d.block_mode_minus1.append(bs.read(mode_bits) if p else 0)
        return d


@dataclass
class InterPatchDataUnit:
    """8.3.7.6 inter patch data unit (``reader.rs:1925-1972``).

    The reference parses this but panics on reconstruction
    (``decoder.rs:487-489``); this framework implements the TMC2 v18
    derivation (``atlas.patches._derive_inter_patch``), exceeding
    reference parity.
    """

    ref_index: int = 0
    ref_patch_index: int = 0
    pos_2d: Tuple[int, int] = (0, 0)
    delta_2d_size: Tuple[int, int] = (0, 0)
    pos_3d_offset: Tuple[int, int] = (0, 0)
    pos_3d_offset_d: int = 0
    pos_3d_range_d: int = 0
    # FRAMEWORK EXTENSION: one PlrData per map, like the intra PDU's
    plr_data: List[Optional["PlrData"]] = field(default_factory=list)

    @classmethod
    def parse(cls, bs: Bitstream, context, ath: AtlasTileHeader,
              plr_size_state=None) -> "InterPatchDataUnit":
        afps = context.get_afps(ath.atlas_frame_parameter_set_id)
        asps = context.get_asps(afps.atlas_sequence_parameter_set_id)
        if asps.patch_size_quantizer_present_flag:
            # inter size deltas are coded in quantized units and the
            # pixel-extent trim would need per-patch extent tracking
            # across frames — quantized patches decode on I-tiles only
            raise UnsupportedFeature(
                "patch size quantizer with inter patches"
            )
        num_ref_idx_active = context.get_num_ref_idx_active(ath)
        pdu = cls()
        pdu.ref_index = bs.read_uvlc() if num_ref_idx_active > 1 else 0
        pdu.ref_patch_index = bs.read_svlc()
        pdu.pos_2d = (bs.read_svlc(), bs.read_svlc())
        pdu.delta_2d_size = (bs.read_svlc(), bs.read_svlc())
        pdu.pos_3d_offset = (bs.read_svlc(), bs.read_svlc())
        pdu.pos_3d_offset_d = bs.read_svlc()
        if asps.normal_axis_max_delta_value_enabled_flag:
            # FRAMEWORK EXTENSION: ipdu_3d_range_d (23090-5 8.3.7.6), a
            # signed delta against the reference patch's quantized depth
            # range — the reference `unimplemented!`s here
            # (``reader.rs:1963-1965``) though its commented-out struct
            # sketch carries the field
            pdu.pos_3d_range_d = bs.read_svlc()
        if asps.plr_enabled_flag:
            # FRAMEWORK EXTENSION: P-tile PLR (the reference panics on
            # the ASPS flag, ``reader.rs:1082``). The plrd block count
            # uses TMC2's parse-time size accumulator (prevPatchSizeU/V
            # plus this PDU's deltas — the reader cannot resolve the
            # reference patch, and TMC2's writer uses the same state,
            # so the coding is self-consistent).
            pdu.plr_data = _parse_plrd_with_state(
                bs, asps, plr_size_state, pdu.delta_2d_size
            )
        elif plr_size_state is not None:
            plr_size_state[0] += pdu.delta_2d_size[0]
            plr_size_state[1] += pdu.delta_2d_size[1]
        return pdu


@dataclass
class MergePatchDataUnit:
    """8.3.7.5 merge patch data unit (``reader.rs:1974-2037``)."""

    override_2d_params_flag: bool = False
    override_3d_params_flag: bool = False
    ref_index: int = 0
    pos_2d: Tuple[int, int] = (0, 0)
    delta_2d_size: Tuple[int, int] = (0, 0)
    pos_3d_offset: Tuple[int, int] = (0, 0)
    pos_3d_offset_d: int = 0
    # None when normal_axis_max_delta is disabled (the field is not in
    # the bitstream); the derivation leaves size_d inherited then
    pos_3d_range_d: Optional[int] = None
    # FRAMEWORK EXTENSION: mpdu_override_plr_flag (coded only inside
    # the 2D-override branch when the ASPS enables PLR); plrd follows
    # when set, else the reference patch's modes are inherited
    override_plr_flag: bool = False
    plr_data: List[Optional["PlrData"]] = field(default_factory=list)

    @classmethod
    def parse(cls, bs: Bitstream, context, ath: AtlasTileHeader,
              plr_size_state=None) -> "MergePatchDataUnit":
        afps = context.get_afps(ath.atlas_frame_parameter_set_id)
        asps = context.get_asps(afps.atlas_sequence_parameter_set_id)
        if asps.patch_size_quantizer_present_flag:
            # same envelope as inter patches: quantized sizes stay
            # I-tile-only
            raise UnsupportedFeature(
                "patch size quantizer with merge patches"
            )
        num_ref_idx_active = context.get_num_ref_idx_active(ath)
        pdu = cls()
        if num_ref_idx_active > 1:
            pdu.ref_index = bs.read_uvlc()
        pdu.override_2d_params_flag = bs.read(1) != 0
        if pdu.override_2d_params_flag:
            pdu.pos_2d = (bs.read_svlc(), bs.read_svlc())
            pdu.delta_2d_size = (bs.read_svlc(), bs.read_svlc())
            if asps.plr_enabled_flag:
                # FRAMEWORK EXTENSION: mpdu_override_plr_flag (23090-5
                # 8.3.7.5 — only a 2D override can invalidate the
                # inherited per-block modes)
                pdu.override_plr_flag = bs.read(1) != 0
        else:
            pdu.override_3d_params_flag = bs.read(1) != 0
            pdu.pos_3d_offset = (bs.read_svlc(), bs.read_svlc())
            pdu.pos_3d_offset_d = bs.read_svlc()
            if asps.normal_axis_max_delta_value_enabled_flag:
                # FRAMEWORK EXTENSION: mpdu_3d_range_d (23090-5 8.3.7.5)
                # — the reference's commented-out line at
                # ``reader.rs:2025-2027`` shows the svlc placement
                pdu.pos_3d_range_d = bs.read_svlc()
        if asps.plr_enabled_flag and pdu.override_plr_flag:
            pdu.plr_data = _parse_plrd_with_state(
                bs, asps, plr_size_state, pdu.delta_2d_size
            )
        elif plr_size_state is not None:
            plr_size_state[0] += pdu.delta_2d_size[0]
            plr_size_state[1] += pdu.delta_2d_size[1]
        return pdu


def _parse_plrd_with_state(bs, asps, plr_size_state, delta_2d_size):
    """Parse one plrd per PLR-present map for an inter/merge PDU, sizing
    the block count with TMC2's parse-time accumulator: the previously
    parsed patch's size plus this PDU's deltas (FRAMEWORK EXTENSION —
    the reference panics on the ASPS flag, ``reader.rs:1082``)."""
    if plr_size_state is None:
        raise UnsupportedFeature(
            "inter/merge PLR data needs the tile-level size state "
            "(direct PDU parse outside a tile layer)"
        )
    plr_size_state[0] += delta_2d_size[0]
    plr_size_state[1] += delta_2d_size[1]
    block_count = plr_size_state[0] * plr_size_state[1]
    if not 0 < block_count <= (1 << 22):
        raise UnsupportedFeature(
            f"inter/merge PLR block count {block_count} outside (0, 2^22]"
        )
    return [
        PlrData.parse(bs, plri, block_count)
        if plri.map_present_flag
        else None
        for plri in asps.plr_information
    ]


@dataclass
class SkipPatchDataUnit:
    pass


@dataclass
class RawPatchDataUnit:
    """8.3.7.7 raw patch data unit (23090-5).

    FRAMEWORK EXTENSION: the reference comments this struct out and
    asserts the ASPS flag false (``reader.rs:2042-2057``, ``:1068``).
    2D position/size are in patch-packing-block units, like the intra
    PDU's; the 3D offsets are coded with
    ``ath.raw_3d_offset_axis_bitcount_minus1 + 1`` bits. The reference's
    commented-out sketch also lists a ``pos_3d_range_d`` field, but
    23090-5 (and TMC2's working RawPatchDataUnit) carry no range for
    raw patches — the spec form is used here."""

    patch_in_auxiliary_video_flag: bool = False
    pos_2d: Tuple[int, int] = (0, 0)
    size_2d_minus1: Tuple[int, int] = (0, 0)
    pos_3d_offset_u: int = 0
    pos_3d_offset_v: int = 0
    pos_3d_offset_d: int = 0
    raw_points_minus1: int = 0

    @classmethod
    def parse(cls, bs: Bitstream, context, ath: "AtlasTileHeader") -> "RawPatchDataUnit":
        afps = context.get_afps(ath.atlas_frame_parameter_set_id)
        asps = context.get_asps(afps.atlas_sequence_parameter_set_id)
        pdu = cls()
        if asps.auxiliary_video_enabled_flag:
            # routes the patch's runs/colors to the auxiliary video
            # (framework extension; reconstruction/raw_points.py)
            pdu.patch_in_auxiliary_video_flag = bs.read(1) != 0
        pdu.pos_2d = (bs.read_uvlc(), bs.read_uvlc())
        pdu.size_2d_minus1 = (bs.read_uvlc(), bs.read_uvlc())
        bitcount = ath.raw_3d_offset_axis_bitcount_minus1 + 1
        if bitcount > 32:
            # the implicit bitcount derivation wraps mod 256 when the 2D
            # and 3D geometry bitdepths are equal (the reference's u8
            # arithmetic quirk, ``reader.rs:1675-1678``) — a stream
            # coding raw patches that way is unreadable; real encoders
            # use the explicit AFPS mode
            raise UnsupportedFeature(
                f"raw 3D offset bitcount {bitcount} (wrapped implicit "
                f"derivation; use afps raw_3d_offset explicit mode)"
            )
        pdu.pos_3d_offset_u = bs.read(bitcount)
        pdu.pos_3d_offset_v = bs.read(bitcount)
        pdu.pos_3d_offset_d = bs.read(bitcount)
        pdu.raw_points_minus1 = bs.read_uvlc()
        return pdu


@dataclass
class EomPatchDataUnit:
    """8.3.7.8 EOM patch data unit (23090-5).

    FRAMEWORK EXTENSION: the reference comments the struct out and
    panics on the enabling ASPS flag (``reader.rs:2059-2076``,
    ``:1069``) and on the patch mode (``decoder.rs:499-501``). 2D
    position/size are in patch-packing-block units like the intra
    PDU's; the unit lists the regular patches whose in-between
    (EOM-coded) points take their attribute samples from this patch's
    2D region, with the per-patch point counts. See
    ``reconstruction/eom_points.py`` for the decode."""

    patch_in_auxiliary_video_flag: bool = False
    pos_2d: Tuple[int, int] = (0, 0)
    size_2d_minus1: Tuple[int, int] = (0, 0)
    associated_patch_idx: List[int] = field(default_factory=list)
    points: List[int] = field(default_factory=list)

    @classmethod
    def parse(cls, bs: Bitstream, context, ath: "AtlasTileHeader") -> "EomPatchDataUnit":
        afps = context.get_afps(ath.atlas_frame_parameter_set_id)
        asps = context.get_asps(afps.atlas_sequence_parameter_set_id)
        pdu = cls()
        if asps.auxiliary_video_enabled_flag:
            # routes the patch's attribute region to the auxiliary video
            # (framework extension; reconstruction/eom_points.py)
            pdu.patch_in_auxiliary_video_flag = bs.read(1) != 0
        pdu.pos_2d = (bs.read_uvlc(), bs.read_uvlc())
        pdu.size_2d_minus1 = (bs.read_uvlc(), bs.read_uvlc())
        patch_count = bs.read_uvlc() + 1
        if patch_count > 1 << 16:
            # a corrupt count must not drive the parse loop unbounded
            raise BitstreamError(f"EOM member patch count {patch_count}")
        for _ in range(patch_count):
            pdu.associated_patch_idx.append(bs.read_uvlc())
            pdu.points.append(bs.read_uvlc())
        return pdu


@dataclass
class PatchInformationData:
    """8.3.7.2 patch information data (``reader.rs:1775-1849``)."""

    patch_mode: int = 0
    patch_data_unit: object = None

    @classmethod
    def parse(cls, bs: Bitstream, context, ath: AtlasTileHeader,
              plr_size_state=None) -> Optional["PatchInformationData"]:
        """Returns None at the End patch mode. ``plr_size_state``: the
        tile's mutable [u, v] parse-time patch-size accumulator for
        inter/merge plrd block counts (TMC2 prevPatchSizeU_/V_)."""
        patch_mode = bs.read_uvlc()
        if ath.tile_type == TileType.P:
            mode = PatchModePTile(patch_mode)
            if mode == PatchModePTile.END:
                return None
            unit = {
                PatchModePTile.MERGE: MergePatchDataUnit,
                PatchModePTile.INTER: InterPatchDataUnit,
                PatchModePTile.INTRA: IntraPatchDataUnit,
                PatchModePTile.SKIP: SkipPatchDataUnit,
                PatchModePTile.RAW: RawPatchDataUnit,
                PatchModePTile.EOM: EomPatchDataUnit,
            }[mode]
            if unit is SkipPatchDataUnit:
                pdu = SkipPatchDataUnit()
            elif unit in (RawPatchDataUnit, EomPatchDataUnit):
                pdu = unit.parse(bs, context, ath)
            else:
                pdu = unit.parse(bs, context, ath, plr_size_state)
            return cls(patch_mode=patch_mode, patch_data_unit=pdu)
        if ath.tile_type == TileType.I:
            mode = PatchModeITile(patch_mode)
            if mode == PatchModeITile.END:
                return None
            unit = {
                PatchModeITile.RAW: RawPatchDataUnit,
                PatchModeITile.EOM: EomPatchDataUnit,
            }.get(mode, IntraPatchDataUnit)
            pdu = (
                unit.parse(bs, context, ath, plr_size_state)
                if unit is IntraPatchDataUnit
                else unit.parse(bs, context, ath)
            )
            return cls(patch_mode=patch_mode, patch_data_unit=pdu)
        raise UnsupportedFeature("patch data in SKIP tile")


@dataclass
class AtlasTileLayer:
    """8.3.6.9 atlas tile layer RBSP (``reader.rs:1507-1542``)."""

    header: AtlasTileHeader = field(default_factory=AtlasTileHeader)
    patch_information_data: List[PatchInformationData] = field(default_factory=list)
    atlas_frame_order_count_val: int = 0
    atlas_frame_order_count_msb: int = 0
    sei: Optional[SeiMessage] = None

    @classmethod
    def parse(cls, bs: Bitstream, context, nal_unit_type: NalUnitType) -> "AtlasTileLayer":
        header = AtlasTileHeader.parse(bs, context, nal_unit_type)
        atl = cls(header=header)
        if header.tile_type != TileType.SKIP:
            # TMC2 prevPatchSizeU_/V_ twin: parse-time patch-size
            # accumulator for inter/merge plrd block counts
            plr_size_state = [0, 0]
            while True:
                pid = PatchInformationData.parse(
                    bs, context, header, plr_size_state
                )
                if pid is None:
                    break
                atl.patch_information_data.append(pid)
        bs.byte_align()
        return atl
