"""Decoded-atlas-information hash (H.20.2.8 decoded atlas information
hash SEI) — computation and verification.

FRAMEWORK EXTENSION: the reference skips hash SEI entirely
(``src/lib.rs:100`` — "skip decoded atlas hash md5");
this module makes it the first *internal* integrity check that does not
depend on the self-authored oracle: the writer computes hashes from the
AUTHORED patch metadata, the decoder recomputes them from its
independently PARSED + DERIVED state, and any divergence in the atlas
decode path (parse, AFOC, tile rects, patch derivation, block
ownership) surfaces as a clean error.

The exact byte-string derivation of ISO/IEC 23090-5 Annex H is not
available in this environment, so the canonicalization below is
framework-defined (documented here, stable, little-endian); both ends
compute through these functions from independent state, which preserves
the SEI's integrity-check semantics. Three hash kinds are supported,
mirroring the SEI's present flags:

- **atlas hash**: over every tile's decoded patch metadata of a frame
  (regular + raw + EOM patches, tile geometry, precedence).
- **b2p hash**: over the frame's block-to-patch ownership maps, derived
  with the TMC2-parity occupancy walk (``oracle.generate_block_to_patch``,
  ``src/codec.rs:205-250``) — this additionally covers the occupancy
  video decode.
- **high-level hash**: over the re-serialized ASPS/AFPS bytes (the
  writer is the exact inverse of the parser, so serialization is a
  canonical form of the parsed high-level syntax).

Hash types follow the SEI field: 0 = MD5 (16 bytes), 1 = CRC-CCITT
(2 bytes), 2 = 32-bit checksum (4 bytes).
"""

from __future__ import annotations

import hashlib
import struct
from typing import Iterable, List

import numpy as np

from .patches import FrameMeta, Patch


def _crc16(data: bytes) -> int:
    """CRC-16/CCITT-FALSE (the HEVC decoded-picture-hash CRC form)."""
    crc = 0xFFFF
    for b in data + b"\x00\x00":
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021 if crc & 0x8000 else crc << 1) & 0xFFFF
    return crc


def _checksum32(data: bytes) -> int:
    """HEVC-style position-xor checksum, framework-canonical form."""
    s = 0
    for i, b in enumerate(data):
        s = (s + (b ^ (i & 0xFF))) & 0xFFFFFFFF
    return s


def hash_bytes(data: bytes, hash_type: int) -> bytes:
    if hash_type == 0:
        return hashlib.md5(data).digest()
    if hash_type == 1:
        return struct.pack("<H", _crc16(data))
    if hash_type == 2:
        return struct.pack("<I", _checksum32(data))
    raise ValueError(f"unknown hash type {hash_type}")


def patch_byte_string(p: Patch) -> bytes:
    """Canonical serialization of one decoded patch record."""
    parts = [struct.pack(
        "<20i",
        p.uv0[0], p.uv0[1], p.size_uv0[0], p.size_uv0[1],
        p.uv1[0], p.uv1[1], p.size_uv1[0], p.size_uv1[1],
        p.d1, p.size_d,
        p.occupancy_resolution, int(p.patch_orientation),
        p.level_of_detail[0], p.level_of_detail[1],
        p.projection_mode,
        p.axes[0], p.axes[1], p.axes[2],
        p.axis_of_additional_plane,
        -1 if p.plr_modes is None else len(p.plr_modes),
    )]
    if p.plr_modes is not None:
        parts.append(np.asarray(p.plr_modes, np.int32).tobytes())
    if p.size_2d_in_pixel is not None:
        parts.append(struct.pack("<2i", *p.size_2d_in_pixel))
    return b"".join(parts)


def tile_byte_string(meta: FrameMeta) -> bytes:
    """Canonical serialization of one decoded tile's metadata."""
    parts = [struct.pack(
        "<8i",
        meta.tile_index, int(meta.tile_type),
        meta.width, meta.height,
        meta.left_top_in_frame[0], meta.left_top_in_frame[1],
        int(meta.patch_precedence), len(meta.patches),
    )]
    parts += [patch_byte_string(p) for p in meta.patches]
    parts.append(struct.pack("<i", len(meta.raw_patches)))
    for rp in meta.raw_patches:
        parts.append(struct.pack(
            "<11i", rp.u0, rp.v0, rp.size_u0, rp.size_v0, rp.n_points,
            rp.u1, rp.v1, rp.d1, rp.occupancy_resolution,
            int(rp.in_aux_video), rp.aux_band_y,
        ))
    parts.append(struct.pack("<i", len(meta.eom_patches)))
    for ep in meta.eom_patches:
        parts.append(struct.pack(
            "<8i", ep.u0, ep.v0, ep.size_u0, ep.size_v0,
            ep.occupancy_resolution, len(ep.member_patches),
            int(ep.in_aux_video), ep.aux_band_y,
        ))
        for mp, cnt in zip(ep.member_patches, ep.member_points):
            parts.append(struct.pack("<2i", mp, cnt))
    return b"".join(parts)


def frame_atlas_byte_string(metas: Iterable[FrameMeta]) -> bytes:
    """All tiles of one frame, in tile-layer decode order."""
    return b"".join(tile_byte_string(m) for m in metas)


def frame_b2p_byte_string(
    metas: Iterable[FrameMeta],
    occ_plane: np.ndarray,
    occupancy_resolution: int,
    occupancy_precision: int,
) -> bytes:
    """Block-to-patch ownership of every tile, TMC2-parity derivation
    (consumes the decoded occupancy video, so this hash also covers the
    occupancy decode path)."""
    from ..reconstruction.oracle import generate_block_to_patch

    parts: List[bytes] = []
    for m in metas:
        b2p = generate_block_to_patch(
            m, occ_plane, occupancy_resolution, occupancy_precision
        )
        parts.append(struct.pack("<3i", m.tile_index, m.width, m.height))
        parts.append(b2p.astype(np.int32).tobytes())
    return b"".join(parts)


def collect_daih_by_frame(context) -> dict:
    """Frame index -> EVERY decoded-atlas-hash SEI attached to that
    frame's tile layers (suffix SEI), in decode order — a multi-tile
    frame may carry one per tile layer and ALL of them verify. Only
    frames carrying their own payloads verify; ``persistence_flag`` is
    retained as metadata (a persisted hash re-asserts identical atlas
    content, which the general decode cannot assume)."""
    from ..v3c.syntax import SeiDecodedAtlasInformationHash

    out = {}
    for i in range(context.atlas_tile_layer_len()):
        atl = context.get_atlas_tile_layer(i)
        if atl.sei is None:
            continue
        for p in atl.sei.sei_suffix:
            if isinstance(p, SeiDecodedAtlasInformationHash) \
                    and not p.cancel_flag:
                out.setdefault(atl.header.frame_index, []).append(p)
    return out


def verify_frame_hashes(
    sei,
    metas: List[FrameMeta],
    occ_plane: np.ndarray,
    occupancy_resolution: int,
    occupancy_precision: int,
    context,
    frame_index: int,
    high_level_bytes: bytes = None,
) -> None:
    """Recompute every hash the SEI asserts from DECODED state and
    raise ``BitstreamError`` on any mismatch. ``occ_plane`` must be the
    frame's occupancy in raster layout. Tile-level hashes are matched
    by tile index (the framework's coded-id-resolved index).
    ``high_level_bytes`` lets the caller hoist the frame-invariant
    ASPS/AFPS re-serialization out of its per-frame loop."""
    from ..bitio import BitstreamError

    ht = sei.hash_type
    bad = []

    def check(kind, present, expect, data_fn):
        # lazy: canonical byte strings are only built for asserted kinds
        if not present:
            return
        got = hash_bytes(data_fn(), ht)
        if got != expect:
            bad.append(f"{kind} (got {got.hex()}, coded {expect.hex()})")

    check("high-level", sei.high_level_present, sei.high_level_hash,
          lambda: (high_level_bytes if high_level_bytes is not None
                   else high_level_byte_string(context)))
    check("atlas", sei.atlas_present, sei.atlas_hash,
          lambda: frame_atlas_byte_string(metas))
    check("b2p", sei.b2p_present, sei.b2p_hash,
          lambda: frame_b2p_byte_string(
              metas, occ_plane, occupancy_resolution, occupancy_precision
          ))
    if sei.tiles_present or sei.tiles_b2p_present:
        by_tile = {m.tile_index: m for m in metas}
        for t, tid in enumerate(sei.tile_ids):
            m = by_tile.get(tid)
            if m is None:
                bad.append(f"tile id {tid} not decoded")
                continue
            if sei.tiles_present:
                check(f"tile {tid}", True, sei.tiles_hash[t],
                      lambda m=m: tile_byte_string(m))
            if sei.tiles_b2p_present:
                check(f"tile {tid} b2p", True, sei.tiles_b2p_hash[t],
                      lambda m=m: frame_b2p_byte_string(
                          [m], occ_plane,
                          occupancy_resolution, occupancy_precision,
                      ))
    if bad:
        raise BitstreamError(
            f"decoded-atlas-hash SEI mismatch on frame {frame_index}: "
            + "; ".join(bad)
        )


def high_level_byte_string(context) -> bytes:
    """Re-serialized ASPS/AFPS bytes: the writer is the exact inverse of
    the parser, so its output is a canonical form of the parsed
    high-level syntax (VUI included)."""
    from ..v3c.writer import write_afps, write_asps

    parts: List[bytes] = []
    for asps in context.atlas_hls.atlas_sequence_parameter_set:
        parts.append(write_asps(asps))
    for afps in context.atlas_hls.atlas_frame_parameter_set:
        asps = context.get_asps(afps.atlas_sequence_parameter_set_id)
        parts.append(write_afps(afps, asps))
    return b"".join(parts)
