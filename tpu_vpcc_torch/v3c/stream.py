"""V3C sample-stream demuxing: file → V3C units → per-GOF Context.

Parity reference: ``tmc2-rs src/bitstream/reader.rs`` C3/C4/C6:
sample-stream header + sized V3C units (``reader.rs:623-713``), the V3C
unit header/payload decode (``reader.rs:17-143``), and the atlas NAL
sample stream (``reader.rs:715-820``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List, Optional

from ..bitio import Bitstream, BitstreamError
from .context import Context, V3CUnitHeader, VideoBitstream
from .syntax import (
    TILE_NAL_TYPES,
    AtlasFrameParameterSet,
    AtlasSequenceParameterSet,
    AtlasTileLayer,
    NalUnitType,
    SeiMessage,
    UnsupportedFeature,
    V3CParameterSet,
    V3CUnitType,
    VideoType,
)

log = logging.getLogger(__name__)


@dataclass
class V3CUnit:
    """One sized unit of the V3C sample stream (``reader.rs:10-15``)."""

    unit_type: V3CUnitType
    data: bytes  # includes the 4-byte unit header

    @property
    def size(self) -> int:
        return len(self.data)

    def decode(self, context: Context) -> V3CUnitType:
        """Parse header + payload into the context (``reader.rs:23-143``)."""
        bs = Bitstream(self.data)
        unit_type = self._decode_header(bs, context)
        if unit_type != self.unit_type:
            raise ValueError(f"unit type mismatch: {unit_type} != {self.unit_type}")
        self._decode_payload(bs, context)
        return unit_type

    def _decode_header(self, bs: Bitstream, context: Context) -> V3CUnitType:
        """4-byte V3C unit header (``reader.rs:35-79``)."""
        unit_type = V3CUnitType(bs.read(5))
        header = context.get_v3c_unit_header(unit_type) or V3CUnitHeader()
        if unit_type != V3CUnitType.VPS:
            header.sequence_parameter_set_id = bs.read(4)
            header.atlas_id = bs.read(6)
            if header.atlas_id != 0:
                raise UnsupportedFeature("V3C only has a single atlas")
        if unit_type == V3CUnitType.AVD:
            header.attribute_index = bs.read(7)
            header.attribute_dimension_index = bs.read(5)
            header.map_index = bs.read(4)
            header.auxiliary_video_flag = bs.read(1) != 0
        elif unit_type == V3CUnitType.GVD:
            header.map_index = bs.read(4)
            header.auxiliary_video_flag = bs.read(1) != 0
            bs.read(12)
        elif unit_type in (V3CUnitType.OVD, V3CUnitType.AD):
            bs.read(17)
        else:
            bs.read(27)
        # FRAMEWORK EXTENSION: aux-flagged GVD/AVD units demux to the
        # auxiliary raw-patch videos (the reference asserts the flag
        # false, ``reader.rs:74``); the payload router below branches
        # on the header
        context.set_v3c_unit_header(unit_type, header)
        return unit_type

    def _decode_payload(self, bs: Bitstream, context: Context) -> None:
        """``reader.rs:82-143``. The video payload size is unit size minus
        the 4-byte header."""
        if self.unit_type == V3CUnitType.VPS:
            vps = V3CParameterSet.parse(bs)
            context.add_vps(vps)
        elif self.unit_type == V3CUnitType.AD:
            parse_nal_sample_stream(context, bs)
        elif self.unit_type == V3CUnitType.OVD:
            context.add_video_bitstream(
                VideoBitstream(bs.read_slice(self.size - 4), VideoType.OCCUPANCY)
            )
        elif self.unit_type == V3CUnitType.GVD:
            vps = context.get_vps()
            vtype = VideoType.GEOMETRY
            vuh_g = context.get_v3c_unit_header(V3CUnitType.GVD)
            if vuh_g is not None and vuh_g.auxiliary_video_flag:
                # FRAMEWORK EXTENSION: the auxiliary geometry video
                # (raw/EOM patch samples; one frame per atlas frame)
                context.add_video_bitstream(
                    VideoBitstream(
                        bs.read_slice(self.size - 4),
                        VideoType.GEOMETRY_RAW,
                    )
                )
                return
            if vps.map_count_minus1 > 0 and vps.multiple_map_streams_present_flag:
                # FRAMEWORK EXTENSION: per-map geometry sub-streams (the
                # reference panics, ``reader.rs:278-283``); every
                # declared map demuxes (D0..D15 per the reference's own
                # reserved enum, ``bitstream.rs:295-335``)
                vuh = context.get_v3c_unit_header(V3CUnitType.GVD)
                if vuh.map_index > vps.map_count_minus1:
                    raise UnsupportedFeature(
                        f"GVD map_index {vuh.map_index} but the VPS "
                        f"declares {vps.map_count_minus1 + 1} map(s)"
                    )
                vtype = VideoType(VideoType.GEOMETRY_D0 + vuh.map_index)
            context.add_video_bitstream(
                VideoBitstream(bs.read_slice(self.size - 4), vtype)
            )
        elif self.unit_type == V3CUnitType.AVD:
            vps = context.get_vps()
            ai = vps.attribute_information
            if ai.attribute_count == 0:
                return
            vuh = context.get_v3c_unit_header(V3CUnitType.AVD)
            if vuh.attribute_dimension_index != 0:
                raise UnsupportedFeature("attribute_dimension_index > 0")
            # FRAMEWORK EXTENSION: multi-attribute streams demux one
            # sub-stream family per vuh_attribute_index (the reference
            # only ever reads attribute 0, ``reader.rs:412-482`` arrays
            # are indexed [0] downstream)
            if vuh.attribute_index >= ai.attribute_count:
                raise UnsupportedFeature(
                    f"AVD attribute_index {vuh.attribute_index} but the "
                    f"VPS declares {ai.attribute_count} attribute(s)"
                )
            vtype = VideoType.ATTRIBUTE
            if vuh.auxiliary_video_flag:
                # one auxiliary family per attribute index (the VPS
                # declares ai_auxiliary_attribute_codec_id per
                # attribute)
                context.add_video_bitstream(
                    VideoBitstream(
                        bs.read_slice(self.size - 4),
                        VideoType.ATTRIBUTE_RAW,
                        attr_index=vuh.attribute_index,
                    )
                )
                return
            if vps.map_count_minus1 > 0 and vps.multiple_map_streams_present_flag:
                if vuh.map_index > vps.map_count_minus1:
                    raise UnsupportedFeature(
                        f"AVD map_index {vuh.map_index} but the VPS "
                        f"declares {vps.map_count_minus1 + 1} map(s)"
                    )
                vtype = VideoType(VideoType.ATTRIBUTE_T0 + vuh.map_index)
            context.add_video_bitstream(
                VideoBitstream(
                    bs.read_slice(self.size - 4), vtype,
                    attr_index=vuh.attribute_index,
                )
            )


@dataclass
class SampleStreamV3CUnit:
    """The whole file split into sized V3C units (``reader.rs:615-713``)."""

    units: List[V3CUnit] = field(default_factory=list)
    ssvh_unit_size_precision_bytes_minus1: int = 0

    @classmethod
    def from_bitstream(cls, bs: Bitstream) -> "SampleStreamV3CUnit":
        precision_minus1 = bs.read(3)
        bs.read(5)  # reserved
        ssvu = cls(ssvh_unit_size_precision_bytes_minus1=precision_minus1)
        precision = precision_minus1 + 1
        while bs.more_data():
            size = bs.read(8 * precision)
            if size == 0:
                raise BitstreamError("empty V3C unit")
            data = bs.read_slice(size)
            unit_type = V3CUnitType(data[0] >> 3)
            ssvu.units.append(V3CUnit(unit_type=unit_type, data=data))
            log.debug("v3c_unit size=%d type=%s", size, unit_type.name)
        return ssvu

    def decode_gof(self, context: Context) -> None:
        """Consume units for one GOF — until the *second* VPS is seen
        (``reader.rs:672-700``)."""
        num_vps = 0
        while self.units:
            unit = self.units[0]
            if unit.unit_type == V3CUnitType.VPS:
                num_vps += 1
                if num_vps > 1:
                    break
            unit.decode(context)
            self.units.pop(0)

    def get_v3c_unit_count(self) -> int:
        return len(self.units)


# NAL types carrying nothing the rec0 reconstruction consumes; skipped
# with a debug log (the reference panics on every one of them)
_SKIPPABLE_NAL_TYPES = frozenset(
    {
        NalUnitType.RSV_ACL_N12,
        NalUnitType.RSV_ACL_R13,
        NalUnitType.RSV_ACL_N14,
        NalUnitType.RSV_ACL_R15,
        NalUnitType.RSV_IRAP_ACL_28,
        NalUnitType.RSV_IRAP_ACL_29,
        NalUnitType.RSV_ACL_30,
        NalUnitType.RSV_ACL_31,
        NalUnitType.RSV_ACL_32,
        NalUnitType.RSV_ACL_33,
        NalUnitType.RSV_ACL_34,
        NalUnitType.RSV_ACL_35,
        NalUnitType.AUD,
        NalUnitType.V3C_AUD,
        NalUnitType.EOS,
        NalUnitType.EOB,
        NalUnitType.FD,
        NalUnitType.AAPS,
    }
)


def parse_nal_sample_stream(context: Context, bs: Bitstream) -> None:
    """Atlas-data payload: sample-stream NAL header + sized NAL units
    (``reader.rs:715-820``). Prefix SEI messages are held and attached to
    the following tile layer, as in the reference."""
    precision = bs.read(3) + 1
    bs.read(5)  # reserved
    prefix_sei: Optional[SeiMessage] = None
    while bs.more_data():
        nalu_size = bs.read(8 * precision)
        end_pos = bs.byte_pos + nalu_size
        bs.read(1)  # forbidden zero bit
        raw_type = bs.read(6)
        try:
            unit_type = NalUnitType(raw_type)
        except ValueError:
            # 48-63: unspecified non-ACL NAL types — a conforming decoder
            # ignores them; the unit is sized so skipping is safe (the
            # reference's FromPrimitive cast panics here instead)
            log.debug("skipping unspecified NAL unit type %d", raw_type)
            bs.seek((end_pos, 0))
            continue
        _layer_id = bs.read(6)
        _temporal_id_plus1 = bs.read(3)
        if unit_type == NalUnitType.ASPS:
            context.add_asps(AtlasSequenceParameterSet.parse(bs))
        elif unit_type == NalUnitType.AFPS:
            context.add_afps(AtlasFrameParameterSet.parse(bs, context))
        elif unit_type in TILE_NAL_TYPES:
            atl = AtlasTileLayer.parse(bs, context, unit_type)
            atl.sei = prefix_sei
            context.add_atlas_tile_layer(atl)
        elif unit_type.is_prefix_sei:
            prefix_sei = SeiMessage.parse(bs, unit_type)
        elif unit_type.is_suffix_sei:
            # Suffix SEI follows the tile layer it annotates; attach its
            # recorded payloads there so presence queries work. The
            # reference panics on every suffix SEI (``reader.rs:813-815``);
            # record-and-skip is the framework's robustness model.
            suffix = SeiMessage.parse(bs, unit_type, end_byte=end_pos)
            if context.atlas_tile_layer_len() > 0:
                atl = context.get_atlas_tile_layer(context.atlas_tile_layer_len() - 1)
                if atl.sei is None:
                    atl.sei = suffix
                else:
                    # a pending prefix SeiMessage is SHARED by every tile
                    # layer after it (Rc-clone parity, reader.rs:806-811);
                    # copy-on-write so the suffix lands only on this layer
                    atl.sei = SeiMessage(
                        sei_prefix=list(atl.sei.sei_prefix),
                        sei_suffix=list(atl.sei.sei_suffix) + suffix.sei_suffix,
                    )
            else:
                log.debug("suffix SEI before any tile layer: recorded, unattached")
        elif unit_type in _SKIPPABLE_NAL_TYPES:
            # reserved ACL types, access-unit delimiters, end-of-seq/
            # bitstream, filler, and AAPS (adaptation params — unused in
            # rec0 reconstruction) carry nothing this decoder consumes;
            # the sized-unit reseek below skips them safely (the
            # reference panics on all of these, reader.rs:816-818)
            log.debug("skipping NAL unit type %s", unit_type.name)
        else:
            raise UnsupportedFeature(f"unexpected NAL unit type {unit_type!r}")
        # Defensive resync: the parsers above should land exactly at the
        # unit boundary; tolerate trailing padding inside the sized unit.
        if bs.byte_pos > end_pos:
            raise ValueError(
                f"NAL unit over-read: {unit_type.name} ended at {bs.byte_pos}, "
                f"unit boundary {end_pos}"
            )
        bs.seek((end_pos, 0))
        log.debug("nalu size=%d type=%s", nalu_size, unit_type.name)


def parse_sample_stream(data: bytes) -> SampleStreamV3CUnit:
    """Split a V3C sample-stream file into units (``lib.rs:98-104``)."""
    return SampleStreamV3CUnit.from_bitstream(Bitstream(data))


def decode_gof(ssvu: SampleStreamV3CUnit) -> Context:
    """Decode the next GOF from the unit queue into a fresh Context."""
    context = Context()
    ssvu.decode_gof(context)
    return context
