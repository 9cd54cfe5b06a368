"""V3C video sub-bitstream framing conversions.

``sample_stream_to_bytestream`` converts the length-prefixed NALU framing
carried inside V3C OVD/GVD/AVD units into an Annex-B start-code bytestream
for the video decoder — parity with the reference converter including its
start-code-length selection per codec (``src/bitstream.rs:216-289``).
"""

from __future__ import annotations

CODEC_H264 = 0
CODEC_H265 = 1
CODEC_H266 = 2


def codec_id_from_v3c(codec_id: int) -> int:
    """Map a V3C codec id octet to a codec family.

    The reference asserts the id is 1 (HEVC Main10 profile group) and
    panics otherwise (``src/decoder.rs:899-910``); same envelope here.
    """
    if codec_id != 1:
        raise ValueError(f"only HEVC (codec id 1) is expected, got {codec_id}")
    return CODEC_H265


def sample_stream_to_bytestream(
    data: bytes, codec_id: int = CODEC_H265, precision: int = 4
) -> bytes:
    """Length-prefixed NALUs → Annex-B with 3/4-byte start codes.

    The first NALU always gets a 4-byte start code; subsequent NALUs get a
    4-byte code iff they start a new frame or carry parameter/SEI NAL types
    (HEVC types 32..40), else 3 bytes — exactly the reference's logic
    (``src/bitstream.rs:227-286``).
    """
    if precision != 4:
        raise ValueError("V3C video sample streams use precision 4")
    out = bytearray()
    size_start_code = 4
    start_index = 0
    new_frame = True
    n = len(data)
    while True:
        nalu_size = int.from_bytes(data[start_index : start_index + precision], "big")
        end_index = start_index + precision + nalu_size
        out += b"\x00" * (size_start_code - 1)
        out.append(1)
        out += data[start_index + precision : end_index]
        start_index = end_index
        if start_index + precision < n:
            new_frame = False
            if codec_id == CODEC_H264:
                use_long = True
            elif codec_id == CODEC_H265:
                nalu_type = (data[start_index + precision] & 126) >> 1
                use_long = new_frame or 32 <= nalu_type < 41
                if nalu_type < 12:
                    new_frame = True
            else:  # H266
                nalu_type = (data[start_index + precision + 1] & 248) >> 3
                use_long = new_frame or 12 <= nalu_type < 20
                if nalu_type < 12:
                    new_frame = True
            size_start_code = 4 if use_long else 3
        if end_index >= n:
            break
    return bytes(out)
