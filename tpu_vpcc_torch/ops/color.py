"""Exact integer YUV10 -> RGB8 colour conversion on tensors.

Counterpart of the device functions of ``tpu_vpcc.ops.color``: three
gathers from the proven offset tables (``color_luts``, shared numpy)
plus int32 arithmetic, bit-equal to the reference f64 BT.709 chain.
``//`` on torch integer tensors floors like numpy, which the negative
numerators here rely on; a truncating division would be wrong.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_vpcc.ops.color import color_luts, g8_from_packed


@functools.lru_cache(maxsize=None)
def _device_luts(device: torch.device):
    s_r, s_b, packed_g = color_luts()
    return tuple(
        torch.from_numpy(np.array(a, dtype=np.int32).reshape(-1)).to(device)
        for a in (s_r, s_b, packed_g)
    )


def rgb8_from_yuv16(col16):
    """(..., 3) integer YUV (10-bit values) -> (..., 3) uint8 RGB."""
    s_r, s_b, packed_g = _device_luts(col16.device)
    c = col16.to(torch.int32)
    y = c[..., 0]
    u = c[..., 1]
    v = c[..., 2]
    y85 = 85 * y
    sr = s_r[v]
    sb = s_b[u]
    pg = packed_g[u * 1024 + v]
    rgb = torch.stack(
        [(y85 - sr) // 341, g8_from_packed(y, pg), (y85 - sb) // 341],
        dim=-1,
    )
    return rgb.clamp(0, 255).to(torch.uint8)


def rgb8_from_rgb16(col16):
    """u16 -> u8 truncation for decoded-RGB (GBR 4:4:4) content."""
    return (col16 & 0xFF).to(torch.uint8)
