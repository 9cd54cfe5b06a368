"""Parsed-syntax store for one GOF (group of frames).

Parity reference: ``tmc2-rs src/common/context.rs`` (C12 in SURVEY.md).
Holds the VPS, per-unit-type V3C unit headers, atlas parameter sets, tile
layers and the raw video sub-bitstreams collected while demuxing one GOF.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .syntax import (
    AtlasFrameParameterSet,
    AtlasSequenceParameterSet,
    AtlasTileHeader,
    AtlasTileLayer,
    NalUnitType,
    SeiPayloadType,
    TileType,
    V3CParameterSet,
    V3CUnitType,
    VideoType,
)
from ..bitio import BitstreamError


def _checked_set(sets, set_id: int, name: str):
    """Index a parameter-set list, surfacing a corrupted id as a clean
    parse error (a raw IndexError leaked through the fuzz sweep)."""
    if not 0 <= set_id < len(sets):
        raise BitstreamError(
            f"{name} id {set_id} references a missing parameter set "
            f"({len(sets)} parsed)"
        )
    return sets[set_id]


@dataclass
class V3CUnitHeader:
    """4-byte V3C unit header fields (``reader.rs:146-161``)."""

    sequence_parameter_set_id: int = 0
    atlas_id: int = 0
    attribute_index: int = 0
    attribute_dimension_index: int = 0
    map_index: int = 0
    auxiliary_video_flag: bool = False


@dataclass
class VideoBitstream:
    """Raw video sub-bitstream payload of one OVD/GVD/AVD unit
    (``src/bitstream.rs:192-207``).

    ``attr_index``: the AVD unit header's vuh_attribute_index
    (FRAMEWORK EXTENSION — the reference's container has no per-index
    storage because it asserts a single attribute everywhere; here
    multi-attribute streams demux one sub-stream family per index)."""

    data: bytes
    video_type: VideoType
    attr_index: int = 0

    def __len__(self) -> int:
        return len(self.data)


@dataclass
class AtlasHighLevelSyntax:
    """``context.rs:222-284``."""

    video_bitstreams: List[VideoBitstream] = field(default_factory=list)
    atlas_sequence_parameter_set: List[AtlasSequenceParameterSet] = field(default_factory=list)
    atlas_frame_parameter_set: List[AtlasFrameParameterSet] = field(default_factory=list)
    atlas_tile_layer: List[AtlasTileLayer] = field(default_factory=list)

    def get_video_bitstream(
        self, video_type: VideoType, attr_index: int = 0
    ) -> Optional[VideoBitstream]:
        """Returns the *last* pushed bitstream of the type (``context.rs:262-267``)."""
        for vbs in reversed(self.video_bitstreams):
            if vbs.video_type == video_type and vbs.attr_index == attr_index:
                return vbs
        return None


class Context:
    """Per-GOF decode context (``context.rs:16-220``)."""

    def __init__(self):
        self.v3c_unit_headers: Dict[V3CUnitType, V3CUnitHeader] = {}
        self.vps: Optional[V3CParameterSet] = None
        self.atlas_hls = AtlasHighLevelSyntax()

    # -- V3C unit headers --------------------------------------------------

    def get_v3c_unit_header(self, unit_type: V3CUnitType) -> Optional[V3CUnitHeader]:
        return self.v3c_unit_headers.get(unit_type)

    def set_v3c_unit_header(self, unit_type: V3CUnitType, header: V3CUnitHeader) -> None:
        self.v3c_unit_headers[unit_type] = header

    # -- parameter sets ----------------------------------------------------

    def add_vps(self, vps: V3CParameterSet) -> None:
        if self.vps is not None:
            raise ValueError("context already has a VPS (one VPS per GOF)")
        self.vps = vps

    def get_vps(self) -> V3CParameterSet:
        if self.vps is None:
            raise ValueError("VPS not found")
        return self.vps

    def add_asps(self, asps: AtlasSequenceParameterSet) -> None:
        self.atlas_hls.atlas_sequence_parameter_set.append(asps)

    def get_asps(self, set_id: int) -> AtlasSequenceParameterSet:
        return _checked_set(
            self.atlas_hls.atlas_sequence_parameter_set, set_id, "ASPS"
        )

    def add_afps(self, afps: AtlasFrameParameterSet) -> None:
        self.atlas_hls.atlas_frame_parameter_set.append(afps)

    def get_afps(self, set_id: int) -> AtlasFrameParameterSet:
        return _checked_set(
            self.atlas_hls.atlas_frame_parameter_set, set_id, "AFPS"
        )

    # -- tile layers -------------------------------------------------------

    def add_atlas_tile_layer(self, atl: AtlasTileLayer) -> None:
        self.atlas_hls.atlas_tile_layer.append(atl)

    def atlas_tile_layer_len(self) -> int:
        return len(self.atlas_hls.atlas_tile_layer)

    def get_atlas_tile_layer(self, index: int) -> AtlasTileLayer:
        return self.atlas_hls.atlas_tile_layer[index]

    # -- video bitstreams --------------------------------------------------

    def add_video_bitstream(self, vbs: VideoBitstream) -> None:
        self.atlas_hls.video_bitstreams.append(vbs)

    def get_video_bitstream(
        self, video_type: VideoType, attr_index: int = 0
    ) -> Optional[VideoBitstream]:
        return self.atlas_hls.get_video_bitstream(video_type, attr_index)

    # -- derivations -------------------------------------------------------

    def derive_afoc_val(self, atgl_index: int):
        """8.4.3.1 atlas frame order count derivation with lsb wraparound.

        Returns (afoc_msb, afoc_val). Parity: ``context.rs:142-172``.
        """
        atgh = self.get_atlas_tile_layer(atgl_index).header
        afoc_lsb = atgh.atlas_frame_order_count_lsb
        if atgl_index == 0:
            return 0, afoc_lsb
        afps = self.get_afps(atgh.atlas_frame_parameter_set_id)
        asps = self.get_asps(afps.atlas_sequence_parameter_set_id)
        max_afoc_lsb = 1 << (asps.log2_max_atlas_frame_order_cnt_lsb_minus_4 + 4)
        prev = self.get_atlas_tile_layer(atgl_index - 1)
        prev_lsb = prev.header.atlas_frame_order_count_lsb
        prev_msb = prev.atlas_frame_order_count_msb
        if afoc_lsb < prev_lsb and prev_lsb - afoc_lsb >= max_afoc_lsb // 2:
            afoc_msb = prev_msb + max_afoc_lsb
        elif afoc_lsb > prev_lsb and afoc_lsb - prev_lsb > max_afoc_lsb // 2:
            afoc_msb = prev_msb - max_afoc_lsb
        else:
            afoc_msb = prev_msb
        return afoc_msb, afoc_msb + afoc_lsb

    def get_num_ref_idx_active(self, ath: AtlasTileHeader) -> int:
        """``context.rs:234-259``."""
        afps = self.get_afps(ath.atlas_frame_parameter_set_id)
        if ath.tile_type == TileType.I:
            return 0
        if ath.num_ref_idx_active_override_flag:
            return ath.num_ref_idx_active_minus1 + 1
        asps = self.get_asps(afps.atlas_sequence_parameter_set_id)
        ref_list = (
            asps.ref_list_struct[ath.ref_atlas_frame_list_idx]
            if ath.ref_atlas_frame_list_sps_flag
            else ath.ref_list_struct
        )
        return min(ref_list.num_ref_entries, afps.num_ref_idx_default_active_minus1 + 1)

    def is_sei_present(
        self,
        nal_unit_type: NalUnitType,
        payload_type: SeiPayloadType,
        atgl_index: int,
    ) -> bool:
        """SEI presence scan over this and earlier tile layers
        (``context.rs:193-219``)."""
        for i in range(atgl_index, -1, -1):
            sei = self.get_atlas_tile_layer(i).sei
            if sei is not None and sei.is_sei_present(nal_unit_type, payload_type):
                return True
        return False
