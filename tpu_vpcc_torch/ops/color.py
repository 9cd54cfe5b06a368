"""Exact integer YUV10 -> RGB8 colour conversion on tensors.

Counterpart of the device functions of ``tpu_vpcc.ops.color``: three
gathers from the proven offset tables plus int32 arithmetic, bit-equal
to the reference f64 BT.709 chain. The tables (:func:`color_luts`, with
the 45 chain deviations the exhaustive check of ``tools/
verify_color_exact.py`` found), :func:`g8_from_packed` and the numpy
integer form :func:`convert_yuv10_to_rgb8_lut` are copied from
``tpu_vpcc.ops.color``.
``//`` on torch integer tensors floors like numpy, which the negative
numerators here rely on; a truncating division would be wrong.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# the reference's BT.709-derived constants (``src/codec.rs:676-681``)
R_V_COEF = 1.57480
G_U_COEF = 0.18733
G_V_COEF = 0.46813
B_U_COEF = 1.85563

# The f64 chain's own intermediate roundings (~1e-13) land exactly ON a
# g-channel floor boundary for 45 of the 2^30 (y, u, v) triples — found
# by the exhaustive verifier (tools/verify_color_exact.py). At 26 of the
# affected (u, v) cells NO single S reproduces the chain (the boundary
# y's within one cell deviate in different directions), so the S table
# carries per-cell correction masks instead: every deviation is exactly
# ±1 and sits on residue (85y - S) mod 341 == 0 (must subtract 1) or
# == 340 (must add 1), at boundary instance k = y // 341 in [0, 3].
# Key: (y, u, v) -> f64_chain_result - base_S_form_result.
_G_CHAIN_DEVIATIONS = {
    (5, 132, 92): 1,
    (346, 132, 92): 1,
    (107, 145, 159): 1,
    (448, 145, 159): 1,
    (789, 145, 159): 1,
    (550, 158, 226): 1,
    (652, 171, 293): 1,
    (174, 197, 427): 1,
    (515, 197, 427): 1,
    (856, 197, 427): 1,
    (276, 210, 494): 1,
    (617, 210, 494): 1,
    (958, 210, 494): 1,
    (378, 223, 561): -1,
    (139, 236, 628): 1,
    (241, 249, 695): -1,
    (684, 262, 762): 1,
    (888, 288, 896): 1,
    (308, 301, 963): 1,
    (990, 301, 963): 1,
    (309, 421, 43): 1,
    (411, 434, 110): 1,
    (752, 434, 110): 1,
    (172, 447, 177): 1,
    (513, 447, 177): 1,
    (854, 447, 177): 1,
    (615, 460, 244): 1,
    (376, 473, 311): 1,
    (478, 486, 378): 1,
    (819, 486, 378): 1,
    (239, 499, 445): 1,
    (580, 499, 445): 1,
    (443, 525, 579): -1,
    (545, 538, 646): -1,
    (886, 538, 646): -1,
    (306, 551, 713): -1,
    (612, 590, 914): -1,
    (100, 775, 329): 1,
    (202, 788, 396): -1,
    (304, 801, 463): 1,
    (645, 801, 463): 1,
    (508, 827, 597): -1,
    (712, 853, 731): -1,
    (336, 892, 932): -1,
    (337, 1012, 12): -1,
}


def _window_S(ref8: np.ndarray, assert_nonempty: bool = True) -> np.ndarray:
    """Exact S per chroma column from the reference outputs themselves.

    ``ref8``: (1024 y, C chroma) int outputs of the f64 chain. For each
    column, intersect over y the integer windows under which
    clamp(floor((85*y - S)/341)) reproduces ref8[y]:
      1 <= g <= 254:  S in [85y - 341(g+1) + 1, 85y - 341g]
      g == 0:         S >= 85y - 340          (any floor <= 0 clamps to 0)
      g == 255:       S <= 85y - 86955        (any floor >= 255 clamps)
    and return the window's lower end. Exact by construction wherever the
    window is non-empty (asserted)."""
    g = ref8.astype(np.int64)
    y85 = (85 * np.arange(g.shape[0], dtype=np.int64))[:, None]
    big = np.int64(1) << 60
    lo = np.where(g == 255, -big, y85 - 341 * (g + 1) + 1)
    hi = np.where(g == 0, big, y85 - 341 * g)
    s_lo = lo.max(axis=0)
    s_hi = hi.min(axis=0)
    if assert_nonempty and not (s_lo <= s_hi).all():
        bad = np.nonzero(s_lo > s_hi)[0]
        raise AssertionError(f"empty S window at chroma indices {bad[:8]}")
    return s_lo.astype(np.int32)


@functools.lru_cache(maxsize=1)
def color_luts():
    """(S_r[1024], S_b[1024], S_g[1024, 1024]) int32 offset tables.

    r and b (one chroma input each): S derived by exact window
    intersection against the full f64 chain over all 2^20 (y, chroma)
    pairs — exact by construction, ~50 ms once per process.

    g (two chroma inputs — the full window needs 2^30 evals): S = the
    EXACT ceil of 85*(a_u + b_v) via int64 arithmetic. The f64 terms
    a_u, b_v are multiples of 2^-55 (their ulp is >= 2^-55 over the whole
    chroma range), so a*2^55 is exactly integral; a divmod-by-2^55 split
    keeps the 85x product inside int64. Plain f64 ceil is NOT safe here —
    it rounded across an exactly-integer boundary at v=1012 in channel r.
    Residual risk is only where the f64 *chain's* own rounding (~1e-13)
    disagrees with the exact real boundary; the exhaustive verifier hunts
    those, and the 45 found are baked in via ``_G_CHAIN_DEVIATIONS``."""
    yf = np.arange(1024, dtype=np.float64)[:, None]
    d = np.arange(1024, dtype=np.float64) - 512.0

    def rb_ref(coef):
        x = np.floor((yf + coef * d[None, :]) / 1023.0 * 255.0)
        return np.clip(x, 0.0, 255.0).astype(np.int64)

    s_r = _window_S(rb_ref(R_V_COEF))
    s_b = _window_S(rb_ref(B_U_COEF))

    SC = np.int64(1) << 55
    A = (G_U_COEF * d * 2.0**55).astype(np.int64)  # exact: exponent shift
    B = (G_V_COEF * d * 2.0**55).astype(np.int64)
    qa, ra = np.divmod(A, SC)  # floor semantics; ra, rb in [0, 2^55)
    qb, rb = np.divmod(B, SC)
    q = qa[:, None] + qb[None, :]
    r85 = 85 * (ra[:, None] + rb[None, :])  # < 85 * 2^56 < 2^63
    s_g = 85 * q - (-r85 // SC)  # 85*q + ceil(r85/2^55), int64

    # pack: bits 0-15 = S + 32768, bits 16-19 = subtract-1 mask over
    # boundary instance k (residue 0), bits 20-23 = add-1 mask (residue
    # 340) — the 45 chain deviations above
    packed = s_g + 32768
    assert packed.min() >= 0 and packed.max() < 65536
    for (yy, u, v), delta in _G_CHAIN_DEVIATIONS.items():
        k = yy // 341
        packed[u, v] |= 1 << ((16 if delta < 0 else 20) + k)
    packed_g = packed.astype(np.int32)
    s_r.setflags(write=False)
    s_b.setflags(write=False)
    packed_g.setflags(write=False)
    return s_r, s_b, packed_g


def g8_from_packed(y, packed):
    """g channel from the packed S+mask cell (shared numpy/jnp semantics:
    only arithmetic, comparison and shift ops on int32 arrays)."""
    s = (packed & 0xFFFF) - 32768
    num = 85 * y - s
    q = num // 341  # floor division in both numpy and jnp
    r = num - 341 * q
    k = y // 341
    minus = ((packed >> 16) >> k) & 1
    plus = ((packed >> 20) >> k) & 1
    return q - minus * (r == 0) + plus * (r == 340)


def convert_yuv10_to_rgb8_lut(colors16: np.ndarray) -> np.ndarray:
    """NumPy integer-form conversion; equals ``convert_yuv10_to_rgb8``
    (the f64 reference chain) on every input — see the module proof."""
    s_r, s_b, packed_g = color_luts()
    y = colors16[:, 0].astype(np.int32)
    u = colors16[:, 1].astype(np.int32)
    v = colors16[:, 2].astype(np.int32)
    y85 = 85 * y
    out = np.empty((colors16.shape[0], 3), dtype=np.uint8)
    np.clip((y85 - s_r[v]) // 341, 0, 255, out=out[:, 0], casting="unsafe")
    np.clip(g8_from_packed(y, packed_g[u, v]), 0, 255, out=out[:, 1],
            casting="unsafe")
    np.clip((y85 - s_b[u]) // 341, 0, 255, out=out[:, 2], casting="unsafe")
    return out


@functools.lru_cache(maxsize=None)
def _device_luts(device: torch.device):
    s_r, s_b, packed_g = color_luts()
    return tuple(
        torch.from_numpy(np.array(a, dtype=np.int32).reshape(-1)).to(device)
        for a in (s_r, s_b, packed_g)
    )


def rgb8_from_yuv16(col16):
    """(..., 3) integer YUV (u16 sample values) -> (..., 3) uint8 RGB.

    Samples wider than 10 bits (the gather fallback's) index the tables
    as the JAX function's clamped gathers do: ``s_r[min(v, 1023)]``,
    ``s_b[min(u, 1023)]`` and ``packed_g`` at the flat index
    ``min(u*1024 + v, 1024² - 1)``, one clamp and not one per axis. On a
    CUDA tensor an index past a table would be a device fault."""
    s_r, s_b, packed_g = _device_luts(col16.device)
    c = col16.to(torch.int32)
    y = c[..., 0]
    u = c[..., 1]
    v = c[..., 2]
    y85 = 85 * y
    sr = s_r[v.clamp(max=1023)]
    sb = s_b[u.clamp(max=1023)]
    pg = packed_g[(u * 1024 + v).clamp(max=1024 * 1024 - 1)]
    # g8_from_packed reads bits 16 + k and 20 + k of the cell, k = y //
    # 341: from k = 8 on both lie above the cell's 24 bits, where XLA's
    # shift gives 0 (also for k >= 32); so does a cell stripped of its
    # mask bits, whatever a device does with shifts of 32 or more
    pg = torch.where(y < 8 * 341, pg, pg & 0xFFFF)
    rgb = torch.stack(
        [(y85 - sr) // 341, g8_from_packed(y, pg), (y85 - sb) // 341],
        dim=-1,
    )
    return rgb.clamp(0, 255).to(torch.uint8)


def rgb8_from_rgb16(col16):
    """u16 -> u8 truncation for decoded-RGB (GBR 4:4:4) content."""
    return (col16 & 0xFF).to(torch.uint8)
