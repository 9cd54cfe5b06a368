"""Host video layer: HEVC sub-stream decompress (native libavcodec bridge).

Mirrors the reference's ``VideoDecoder::decompress`` flow
(``src/decoder.rs:1035-1084``): sample-stream → Annex-B conversion, then
decode; plus the decode-orchestration invariants from ``Decoder::decode``
(``src/decoder.rs:82-180``): occupancy is 8-bit, geometry/attribute are
10-bit planes read as native-endian u16.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .codec import VideoFrame, decode_annexb, encode_yuv420, encoder_supports  # noqa: F401
from .substream import sample_stream_to_bytestream


def decompress_video(
    data: bytes, codec_id: int, bytestream_video_coder: bool = True, tile: int = 0
) -> List[VideoFrame]:
    """Decompress one V3C video sub-bitstream into YUV frames.

    ``bytestream_video_coder`` is always true in rec0 streams (the unit
    payload uses length-prefixed NALU framing). With ``tile > 0`` planes
    come back block-tiled from the native copy (see ``decode_annexb``)."""
    annexb = (
        sample_stream_to_bytestream(data, codec_id)
        if bytestream_video_coder
        else data
    )
    return decode_annexb(annexb, codec_id, tile=tile)


def occupancy_planes(frames: List[VideoFrame]) -> np.ndarray:
    """Stack occupancy Y planes into (n, h, w) uint8.

    The reference asserts occupancy_2d_bitdepth_minus1 == 7 and no MSB
    alignment (``src/decoder.rs:94-95``); here that manifests as an 8-bit
    decode check.
    """
    if frames and frames[0].bit_depth != 8:
        raise ValueError(f"occupancy video must be 8-bit, got {frames[0].bit_depth}")
    return np.stack([f.planes[0] for f in frames])


def geometry_planes(frames: List[VideoFrame]) -> np.ndarray:
    """Stack geometry Y planes into (n, h, w) uint16.

    Geometry/attribute streams decode as 10-bit planes; the depth consumer
    divides by 4 (reference ``src/codec.rs:532-534``). An 8-bit decode is
    widened with a flag of shift 0 handled downstream.
    """
    return np.stack([f.planes[0].astype(np.uint16, copy=False) for f in frames])


def attribute_planes(frames: List[VideoFrame]) -> List[List[np.ndarray]]:
    """Per-frame [y, u, v] uint16 planes (YUV420) for attribute sampling."""
    return [[p.astype(np.uint16, copy=False) for p in f.planes] for f in frames]
