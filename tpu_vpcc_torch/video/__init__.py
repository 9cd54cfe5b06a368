"""Host video layer: HEVC sub-stream decompress (native libavcodec bridge).

Mirrors the reference's ``VideoDecoder::decompress`` flow
(``src/decoder.rs:1035-1084``): sample-stream → Annex-B conversion, then
decode; plus the decode-orchestration invariants from ``Decoder::decode``
(``src/decoder.rs:82-180``): occupancy is 8-bit, geometry/attribute are
10-bit planes read as native-endian u16.
"""

from __future__ import annotations

from typing import List

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
