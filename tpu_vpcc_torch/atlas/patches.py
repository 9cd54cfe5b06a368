"""Patch-frame construction: tile layers → per-frame patch metadata.

Host-side port of the reference's ``create_patch_frame`` orchestration
(``src/decoder.rs:320-587``) and the ``Patch`` geometry math
(``src/decoder.rs:694-889``): view-id → axes table, the 9-orientation
canvas transform, and depth → 3D point generation. The per-pixel versions
of these transforms live in ``tpu_vpcc.ops`` as whole-frame device kernels;
this module is the scalar/metadata source of truth.

Beyond reference parity: inter/merge/skip patch derivation for P- and
SKIP-tiles (random-access streams) is implemented per TMC2 v18 /
ISO 23090-5 §9.2.6 — the reference panics at those sites
(``decoder.rs:403-407,487-501``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

import numpy as np

from ..v3c.context import Context
from ..v3c.syntax import (
    IntraPatchDataUnit,
    PatchModeITile,
    PatchModePTile,
    PatchOrientation,
    TileType,
    UnsupportedFeature,
)

log = logging.getLogger(__name__)


# FRAMEWORK EXTENSION: 45-degree (additional-plane) projections.
#
# The reference decodes the full 18-view table (``decoder.rs:788-814``)
# but its reconstruction is ``unimplemented!`` for any additional plane
# (``codec.rs:429-440``), so there is no reference behavior to mirror;
# this framework defines the coordinate convention and implements it on
# every path (oracle + device kernels + fixtures, all bit-identical).
#
# Patches on an additional plane live in a ROTATED coordinate frame:
# the pair of axes the plane mixes (plane 1: x/z, plane 2: z/y,
# plane 3: y/x — the third axis is untouched) relates to the true
# coordinates by the integer 45-degree map
#
#     r_s = s + d                 (sum axis)
#     r_d = d - s + shift         (difference axis, re-centered)
#     shift = 2^(bitdepth-1) - 1
#
# whose exact inverse — applied per decoded point, after duplicate
# suppression and before smoothing — is
#
#     s = (r_s - r_d + shift) >> 1
#     d = (r_s + r_d - shift) >> 1
#
# (arithmetic shift = floor; exact whenever the rotated pair came from
# integer true coordinates, floor-rounded otherwise, e.g. lossy geometry).
# The device twin is ``ops.reconstruct.apply_inverse_rot45``.

# plane -> (sum axis, difference axis) of the mixed pair
_ROT45_PAIRS = {1: (0, 2), 2: (2, 1), 3: (1, 0)}


def inverse_rotate_45(plane: int, bitdepth: int, point):
    """Scalar inverse 45-degree rotation for the NumPy oracle: maps a
    rotated-frame (x, y, z) triple to true coordinates (u16-masked).
    ``point`` is any length-3 integer sequence; returns a list."""
    s_ax, d_ax = _ROT45_PAIRS[plane]
    shift = (1 << (bitdepth - 1)) - 1
    out = [int(point[0]), int(point[1]), int(point[2])]
    rs, rd = out[s_ax], out[d_ax]
    out[s_ax] = (rs - rd + shift) >> 1
    out[d_ax] = (rs + rd - shift) >> 1
    return [c & 0xFFFF for c in out]


def inverse_rotate_45_np(plane: int, bitdepth: int, pos: np.ndarray):
    """Vectorized twin of :func:`inverse_rotate_45` for (N, 3) integer
    arrays (the host PLR/EOM tails); returns uint16."""
    s_ax, d_ax = _ROT45_PAIRS[plane]
    shift = (1 << (bitdepth - 1)) - 1
    p = pos.astype(np.int64)
    rs, rd = p[:, s_ax].copy(), p[:, d_ax].copy()
    p[:, s_ax] = (rs - rd + shift) >> 1
    p[:, d_ax] = (rs + rd - shift) >> 1
    return (p & 0xFFFF).astype(np.uint16)


@dataclass
class Patch:
    """Decoded patch record (``src/decoder.rs:711-783``)."""

    uv0: Tuple[int, int] = (0, 0)  # canvas block coords
    size_uv0: Tuple[int, int] = (0, 0)  # size in blocks
    uv1: Tuple[int, int] = (0, 0)  # tangential/bitangential shift
    size_uv1: Tuple[int, int] = (0, 0)
    d1: int = 0  # depth shift
    size_d: int = 0
    occupancy_resolution: int = 16
    level_of_detail: Tuple[int, int] = (1, 1)
    projection_mode: int = 0  # 0: min-depth, 1: max-depth
    axes: Tuple[int, int, int] = (0, 2, 1)  # (normal, tangent, bitangent)
    axis_of_additional_plane: int = 0
    patch_orientation: PatchOrientation = PatchOrientation.DEFAULT
    # FRAMEWORK EXTENSION (PLR, single-map streams): per-block mode
    # index into the map's PlrInformation mode list, -1 where absent;
    # patch-block raster order (v0 * size_u0 + u0). None: no PLR.
    plr_modes: Optional[List[int]] = None
    # FRAMEWORK EXTENSION (patch size quantizer): the patch's exact
    # extent in patch-space pixels, (size_2d_minus1+1) * 2^quantizer
    # per axis; occupied pixels at or past it emit no point. None when
    # the ASPS quantizer flag is off (sizes are block-exact then).
    size_2d_in_pixel: Optional[Tuple[int, int]] = None

    # -- view id ----------------------------------------------------------

    _VIEW_TABLE = {
        # view_id: (additional_plane, normal, tangent, bitangent, mode)
        0: (0, 0, 2, 1, 0),
        1: (0, 1, 2, 0, 0),
        2: (0, 2, 0, 1, 0),
        3: (0, 0, 2, 1, 1),
        4: (0, 1, 2, 0, 1),
        5: (0, 2, 0, 1, 1),
        6: (1, 0, 2, 1, 0),
        7: (1, 2, 0, 1, 0),
        8: (1, 0, 2, 1, 1),
        9: (1, 2, 0, 1, 1),
        10: (2, 2, 0, 1, 0),
        11: (2, 1, 2, 0, 0),
        12: (2, 2, 0, 1, 1),
        13: (2, 1, 2, 0, 1),
        14: (3, 1, 2, 0, 0),
        15: (3, 0, 2, 1, 0),
        16: (3, 1, 2, 0, 1),
        17: (3, 0, 2, 1, 1),
    }

    def set_view_id(self, view_id: int) -> None:
        """``src/decoder.rs:788-814`` (only 0..=5 reachable in rec0)."""
        plane, normal, tangent, bitangent, mode = self._VIEW_TABLE[view_id]
        self.axis_of_additional_plane = plane
        self.axes = (normal, tangent, bitangent)
        self.projection_mode = mode

    # -- orientation transform --------------------------------------------

    def patch_to_canvas_helper(self, u: int, v: int, resolution: int) -> Tuple[int, int]:
        """9-case orientation transform (``src/decoder.rs:853-867``)."""
        u0 = self.uv0[0] * resolution
        v0 = self.uv0[1] * resolution
        su0, sv0 = self.size_uv0
        o = self.patch_orientation
        if o == PatchOrientation.DEFAULT:
            return u + u0, v + v0
        if o == PatchOrientation.ROT90:
            return sv0 - 1 - v + u0, u + v0
        if o == PatchOrientation.ROT180:
            return su0 - 1 - u + u0, sv0 - 1 - v + v0
        if o == PatchOrientation.ROT270:
            return v + u0, su0 - 1 - u + v0
        if o == PatchOrientation.MIRROR:
            return su0 - 1 - u + u0, v + v0
        if o == PatchOrientation.MROT90:
            return sv0 - 1 - v + u0, su0 - 1 - u + v0
        if o == PatchOrientation.MROT180:
            return u + u0, sv0 - 1 - v + v0
        if o in (PatchOrientation.MROT270, PatchOrientation.SWAP):
            return v + u0, u + v0
        raise ValueError(f"unknown orientation {o}")

    def patch_block_to_canvas_block(
        self, u_blk: int, v_blk: int, stride_blk: int, height_blk: int
    ) -> int:
        x, y = self.patch_to_canvas_helper(u_blk, v_blk, 1)
        # lower bounds too: negative coords would Python-wrap into valid
        # indices where the Rust usize arithmetic panics
        assert 0 <= x < stride_blk and 0 <= y < height_blk
        return y * stride_blk + x

    def patch_to_canvas(
        self, u: int, v: int, canvas_stride: int, canvas_height: int
    ) -> Tuple[int, int]:
        x, y = self.patch_to_canvas_helper(u, v, self.occupancy_resolution)
        assert 0 <= x < canvas_stride and 0 <= y < canvas_height
        return x, y

    def orientation_coeffs(self, resolution: int):
        """Affine coefficients (a, b, cx, c, d, cy) with
        x = a*u + b*v + cx and y = c*u + d*v + cy at the given resolution.

        Per-patch constants used by the device kernels to express the
        orientation transform as a gather. NOTE: the size terms stay in
        *block* units regardless of resolution — this replicates the
        tmc2-rs helper exactly (``src/decoder.rs:853-867``), which unlike
        TMC2 C++ does not scale size_uv0 by the resolution; rec0 parity is
        against the Rust reference.
        """
        u0 = self.uv0[0] * resolution
        v0 = self.uv0[1] * resolution
        su = self.size_uv0[0]  # block units, see docstring
        sv = self.size_uv0[1]
        o = self.patch_orientation
        # (a, b, cx, c, d, cy)
        table = {
            PatchOrientation.DEFAULT: (1, 0, u0, 0, 1, v0),
            PatchOrientation.ROT90: (0, -1, sv - 1 + u0, 1, 0, v0),
            PatchOrientation.ROT180: (-1, 0, su - 1 + u0, 0, -1, sv - 1 + v0),
            PatchOrientation.ROT270: (0, 1, u0, -1, 0, su - 1 + v0),
            PatchOrientation.MIRROR: (-1, 0, su - 1 + u0, 0, 1, v0),
            PatchOrientation.MROT90: (0, -1, sv - 1 + u0, -1, 0, su - 1 + v0),
            PatchOrientation.MROT180: (1, 0, u0, 0, -1, sv - 1 + v0),
            PatchOrientation.MROT270: (0, 1, u0, 1, 0, v0),
            PatchOrientation.SWAP: (0, 1, u0, 1, 0, v0),
        }
        return table[o]

    # -- point generation --------------------------------------------------

    def generate_normal_coordinate(self, depth: int) -> int:
        """``src/decoder.rs:881-888``."""
        if self.projection_mode == 0:
            return depth + self.d1
        return max(self.d1, depth) - depth

    def generate_point(self, u: int, v: int, depth: int) -> np.ndarray:
        """``src/decoder.rs:871-878``; u16 truncation semantics preserved."""
        point = np.zeros(3, dtype=np.uint16)
        normal, tangent, bitangent = self.axes
        point[normal] = np.uint16(self.generate_normal_coordinate(depth) & 0xFFFF)
        point[tangent] = np.uint16((u * self.level_of_detail[0] + self.uv1[0]) & 0xFFFF)
        point[bitangent] = np.uint16((v * self.level_of_detail[1] + self.uv1[1]) & 0xFFFF)
        return point


@dataclass
class RawPatch:
    """Decoded raw-patch record (framework extension; 23090-5 §8.3.7.7).

    The reference comments the struct out and panics on the ASPS flag
    (``reader.rs:2042-2057``). Region coordinates are in patch-packing-
    block units (pixels = value * occupancy_resolution). ``n_points``
    raw points are stored IN the geometry video over the region's pixel
    raster as three consecutive runs (all x values, then all y, then
    all z); attributes carry one pixel per point from the region origin.
    See ``reconstruction/raw_points.py`` for the read-back."""

    u0: int = 0
    v0: int = 0
    size_u0: int = 0  # blocks
    size_v0: int = 0
    u1: int = 0  # 3D offsets added to the decoded values
    v1: int = 0
    d1: int = 0
    n_points: int = 0
    occupancy_resolution: int = 16
    # FRAMEWORK EXTENSION: region lives in the auxiliary video
    # sub-stream (rpdu_patch_in_auxiliary_video_flag) instead of the
    # main geometry/attribute videos
    in_aux_video: bool = False
    # pixel offset of the owning tile's aux-video band (AFTI aux tile
    # rows, 23090-5: afti_auxiliary_video_tile_row_height in units of
    # 64 samples); u0/v0 are band-relative, so the reconstruction reads
    # the aux planes at v0*res + aux_band_y
    aux_band_y: int = 0


@dataclass
class EomPatch:
    """Decoded EOM-patch record (framework extension; 23090-5 §8.3.7.8).

    The reference comments the struct out and panics on the ASPS flag
    and the patch mode (``reader.rs:2059-2076``, ``decoder.rs:499-501``).
    Region coordinates are in patch-packing-block units. The region of
    the ATTRIBUTE video holds the colors of the member patches' EOM
    (in-between) points, one pixel per point over the region's pixel
    raster, in EOM emission order (member patches in list order, each
    patch's pixels in its block-major emission order, codeword bits
    ascending). See ``reconstruction/eom_points.py`` for the decode and
    the occupancy codeword convention."""

    u0: int = 0
    v0: int = 0
    size_u0: int = 0  # blocks
    size_v0: int = 0
    member_patches: List[int] = field(default_factory=list)
    member_points: List[int] = field(default_factory=list)
    occupancy_resolution: int = 16
    # FRAMEWORK EXTENSION: the attribute region lives in the auxiliary
    # video sub-stream (epdu_patch_in_auxiliary_video_flag)
    in_aux_video: bool = False
    # owning tile's aux-video band origin in pixels (see RawPatch)
    aux_band_y: int = 0


@dataclass
class FrameMeta:
    """Per-frame (single-tile) reconstruction metadata — the distilled
    ``TileContext`` (``context.rs:394-439``)."""

    frame_index: int = 0
    tile_index: int = 0
    atl_index: int = 0
    width: int = 0
    height: int = 0
    left_top_in_frame: Tuple[int, int] = (0, 0)
    patches: List[Patch] = field(default_factory=list)
    tile_type: TileType = TileType.I
    # framework extension: raw patches (the reference panics on them);
    # kept OUT of `patches` so block-to-patch ownership, group tables,
    # and inter/merge patch indexing see only regular patches
    raw_patches: List[RawPatch] = field(default_factory=list)
    # framework extension: EOM patches (same reasoning as raw_patches)
    eom_patches: List[EomPatch] = field(default_factory=list)
    # FRAMEWORK EXTENSION (asps_patch_precedence_order_flag; the
    # reference asserts it false, ``codec.rs:340-347``): when True,
    # patch precedence is the DECODING order (23090-5) — earlier
    # patches win contested blocks, so block-ownership passes iterate
    # patches in reverse so earlier ones overwrite. Emission order is
    # unchanged (patches ascending, owned blocks in patch raster).
    patch_precedence: bool = False


def _patch_type(tile_type: TileType, patch_mode: int) -> str:
    """``src/decoder.rs:676-692`` (+ the raw modes the reference omits)."""
    if tile_type == TileType.SKIP:
        return "skip"
    if tile_type == TileType.P:
        return {
            int(PatchModePTile.INTRA): "intra",
            int(PatchModePTile.INTER): "inter",
            int(PatchModePTile.MERGE): "merge",
            int(PatchModePTile.SKIP): "skip",
            int(PatchModePTile.RAW): "raw",
            int(PatchModePTile.EOM): "eom",
        }.get(patch_mode, "error")
    if tile_type == TileType.I:
        return {
            int(PatchModeITile.INTRA): "intra",
            int(PatchModeITile.RAW): "raw",
            int(PatchModeITile.EOM): "eom",
        }.get(patch_mode, "error")
    return "error"


def _check_orientation_in_range(patch: Patch, width: int, height: int) -> None:
    """Exact success gate for the reference's orientation transform.

    The tmc2-rs pixel-level helper (``src/decoder.rs:853-867``) subtracts
    pixel indices from BLOCK-unit sizes (unlike TMC2 C++, it never scales
    ``size_uv0`` by the resolution). In the release build (overflow checks
    off) the arithmetic is evaluated mod 2^64 and the decoder panics
    exactly when a final coordinate leaves the canvas (the ``assert!`` at
    ``:848-850``, hit for every patch pixel during block-to-patch,
    ``src/codec.rs:217-247``). So the reference succeeds iff the quirked
    affine stays in-canvas over the patch's whole pixel domain — always
    true for DEFAULT/SWAP/MROT270, and for EVERY orientation when
    ``occupancy_resolution == 1`` (pixel units == block units). This gate
    replicates that condition per patch: decode whatever the reference
    decodes, raise exactly where it panics.

    TWO asserts are replicated, because the reference evaluates the
    helper twice per block: at BLOCK units (``patch_block_to_canvas_block``,
    resolution 1 — the un-quirked transform, asserted against block
    dims, ``decoder.rs:835``) and at PIXEL units (``patch_to_canvas``,
    asserted against the canvas, ``:848``). Either one out of range
    panics the reference; a pixel-in-range but block-out-of-range patch
    exists (e.g. ROT90 near the right canvas edge), so both are checked.

    Zero-size patches (possible via inter/merge signed size deltas) are
    exempt: the reference's per-block loops never execute, no assert is
    hit, and the patch contributes zero points."""
    res = patch.occupancy_resolution
    su0, sv0 = patch.size_uv0
    if su0 < 0 or sv0 < 0:
        # a negative derived size wraps to a huge usize in the reference
        # (release build) and panics at the canvas assert
        raise UnsupportedFeature(
            f"negative derived patch size {patch.size_uv0} (the reference's "
            f"usize arithmetic wraps and panics here)"
        )
    if su0 == 0 or sv0 == 0:
        return

    def corners(coeffs, mu, mv):
        a, b, cx, c, d, cy = coeffs
        xs = (cx, a * mu + cx, b * mv + cx, a * mu + b * mv + cx)
        ys = (cy, c * mu + cy, d * mv + cy, c * mu + d * mv + cy)
        return xs, ys

    checks = (
        ("block", corners(patch.orientation_coeffs(1), su0 - 1, sv0 - 1),
         width // res, height // res),
        ("pixel", corners(patch.orientation_coeffs(res), su0 * res - 1,
                          sv0 * res - 1), width, height),
    )
    for unit, (xs, ys), w_lim, h_lim in checks:
        if min(xs) < 0 or max(xs) >= w_lim or min(ys) < 0 or max(ys) >= h_lim:
            raise UnsupportedFeature(
                f"patch orientation {patch.patch_orientation!r} at "
                f"resolution {res}: the reference's unscaled orientation "
                f"helper drives {unit} coords out of range here and panics "
                f"(tmc2-rs size quirk, src/decoder.rs:835,848,853-867; "
                f"x range {min(xs)}..{max(xs)}, y range {min(ys)}..{max(ys)}, "
                f"limit {w_lim}x{h_lim})"
            )


def ref_afoc_list(context: Context, ath, cur_afoc: int) -> List[int]:
    """Active reference-AFOC list for a tile (23090-5 §8.4.3.2).

    Short-term entry j: RefAfoc = CurrAfoc - DeltaAfocSt where
    DeltaAfocSt = abs_delta_afoc_st * (+1 if sign flag else -1) — sign
    flag 1 means the delta is non-negative, so the common (delta=1,
    sign=1) entry references the previous frame. Long-term entries carry
    the target AFOC lsb; when the tile header signals
    additional_afoc_lsb_val (afps.additional_lt_afoc_lsb_len bits) the
    full AFOC is ``(additional << lsb_bits) + lsb`` — without it, lsb
    values are only unambiguous below MaxAtlasFrmOrderCntLsb. The active
    list is re-resolved from the FINAL ref_atlas_frame_list_idx (the
    header parser stores the index-0 struct before reading the index,
    mirroring the reference's read order, ``reader.rs:1608-1631``).
    """
    afps = context.get_afps(ath.atlas_frame_parameter_set_id)
    asps = context.get_asps(afps.atlas_sequence_parameter_set_id)
    rls = (
        asps.ref_list_struct[ath.ref_atlas_frame_list_idx]
        if ath.ref_atlas_frame_list_sps_flag
        else ath.ref_list_struct
    )
    lsb_bits = asps.log2_max_atlas_frame_order_cnt_lsb_minus_4 + 4
    cur = cur_afoc
    out: List[int] = []
    st_i = lt_i = 0
    add_i = 0  # additional-afoc VALUES are stored compactly (present only)
    for j in range(rls.num_ref_entries):
        if rls.st_ref_atlas_frame_flag[j]:
            delta = rls.abs_delta_afoc_st[st_i]
            if not rls.strpf_entry_sign_flag[st_i]:
                delta = -delta
            st_i += 1
            out.append(cur - delta)
        else:
            afoc = rls.afoc_lsb_lt[lt_i]
            if (
                lt_i < len(ath.additional_afoc_lsb_present_flag)
                and ath.additional_afoc_lsb_present_flag[lt_i]
            ):
                afoc += ath.additional_afoc_lsb_val[add_i] << lsb_bits
                add_i += 1
            lt_i += 1
            out.append(afoc)
    return out


def _derive_inter_patch(
    pdu, ref: Patch, min_level: int, geometry_bitdepth_3d: int,
    packing_block_size: int,
) -> Patch:
    """Inter patch derivation (TMC2 v18 ``PCCDecoder`` PATCH_MODE_P_INTER;
    the reference panics here, ``decoder.rs:487-489`` — this framework
    implements the derivation, exceeding reference parity).

    All 2D/3D position fields are signed deltas against the reference
    patch; orientation, axes, projection mode and LoD are inherited.
    """
    patch = Patch(
        occupancy_resolution=packing_block_size,
        uv0=(ref.uv0[0] + pdu.pos_2d[0], ref.uv0[1] + pdu.pos_2d[1]),
        size_uv0=(
            ref.size_uv0[0] + pdu.delta_2d_size[0],
            ref.size_uv0[1] + pdu.delta_2d_size[1],
        ),
        uv1=(
            ref.uv1[0] + pdu.pos_3d_offset[0],
            ref.uv1[1] + pdu.pos_3d_offset[1],
        ),
        level_of_detail=ref.level_of_detail,
        projection_mode=ref.projection_mode,
        axes=ref.axes,
        axis_of_additional_plane=ref.axis_of_additional_plane,
        patch_orientation=ref.patch_orientation,
    )
    max3d = 1 << geometry_bitdepth_3d
    if ref.projection_mode == 0:
        patch.d1 = (pdu.pos_3d_offset_d + ref.d1 // min_level) * min_level
    else:
        patch.d1 = max3d - (
            pdu.pos_3d_offset_d + (max3d - ref.d1) // min_level
        ) * min_level
    # sizeD per TMC2 (not consumed by the rec0 reconstruction math):
    # quantized previous range + coded delta, clamped at 255
    prev_dd = -(-ref.size_d // min_level)  # ceil
    patch.size_d = min((pdu.pos_3d_range_d + prev_dd) * min_level, 255)
    return patch


def _derive_merge_patch(
    pdu, ref: Patch, min_level: int, geometry_bitdepth_3d: int,
    packing_block_size: int,
) -> Patch:
    """Merge patch derivation (TMC2 v18 PATCH_MODE_P_MERGE): start from
    the same-index patch of the reference tile and override the 2D or 3D
    parameter group. Note the bitstream layout carries the 3D fields even
    when override_3d_params_flag is 0 (mirroring the reference parser,
    ``reader.rs:2019-2024``); they are applied only when the flag is set,
    per 23090-5 §9.2.6."""
    patch = replace(ref, occupancy_resolution=packing_block_size)
    if pdu.override_2d_params_flag:
        patch.uv0 = (ref.uv0[0] + pdu.pos_2d[0], ref.uv0[1] + pdu.pos_2d[1])
        patch.size_uv0 = (
            ref.size_uv0[0] + pdu.delta_2d_size[0],
            ref.size_uv0[1] + pdu.delta_2d_size[1],
        )
    elif pdu.override_3d_params_flag:
        patch.uv1 = (
            ref.uv1[0] + pdu.pos_3d_offset[0],
            ref.uv1[1] + pdu.pos_3d_offset[1],
        )
        max3d = 1 << geometry_bitdepth_3d
        if ref.projection_mode == 0:
            patch.d1 = (pdu.pos_3d_offset_d + ref.d1 // min_level) * min_level
        else:
            patch.d1 = max3d - (
                pdu.pos_3d_offset_d + (max3d - ref.d1) // min_level
            ) * min_level
        if pdu.pos_3d_range_d is not None:
            # normal_axis_max_delta coded (mpdu_3d_range_d): the same
            # quantized-range delta the inter derivation applies; None
            # (ASPS flag off) keeps the inherited size_d
            prev_dd = -(-ref.size_d // min_level)  # ceil
            patch.size_d = min(
                (pdu.pos_3d_range_d + prev_dd) * min_level, 255
            )
    return patch


def _plr_modes_from_plrd(plr_data, asps, block_count: int):
    """Normalize 8.3.7.9 plr_data to a per-block mode list (single-map
    envelope: one present map), or None when no map carries data.
    FRAMEWORK EXTENSION — the reference panics on the ASPS flag
    (``reader.rs:1082``)."""
    d = next((x for x in plr_data if x is not None), None)
    plri = next(
        (p for p in asps.plr_information if p.map_present_flag), None
    )
    if d is None or plri is None:
        return None
    if d.level_flag:
        mode = d.mode_minus1 if d.present_flag else -1
        modes = [mode] * block_count
    else:
        modes = [
            m if p else -1
            for p, m in zip(d.block_present_flag, d.block_mode_minus1)
        ]
        if len(modes) != block_count:
            # inter/merge plrd block counts come from TMC2's parse-time
            # size accumulator, which can drift from the DERIVED
            # footprint when patches don't chain in coding order
            raise UnsupportedFeature(
                f"plr_data block list ({len(modes)}) does not match "
                f"the derived patch footprint ({block_count} blocks)"
            )
    if max(modes, default=-1) >= plri.number_of_modes:
        raise UnsupportedFeature(
            f"PLR mode {max(modes)} beyond the "
            f"{plri.number_of_modes}-entry mode table"
        )
    return modes


def create_patch_frames(context: Context) -> List[FrameMeta]:
    """Build per-frame patch metadata from all tile layers in the context.

    Parity: ``Decoder::create_patch_frame`` (``src/decoder.rs:320-517``).
    Also derives AFOC for every tile layer (msb/val stored on the layer).
    """
    vps = context.get_vps()
    frames: List[FrameMeta] = []

    # AFOC derivation pass (``decoder.rs:328-335``)
    frame_count = 0
    for i in range(context.atlas_tile_layer_len()):
        msb, val = context.derive_afoc_val(i)
        atl = context.get_atlas_tile_layer(i)
        atl.atlas_frame_order_count_msb = msb
        atl.atlas_frame_order_count_val = val
        atl.header.frame_index = val & 0xFF  # u8 cast in the reference
        frame_count = max(frame_count, val + 1)

    # decoded tiles by (AFOC val, tile index), for inter/merge/skip refs
    # — tiles predict only from the SAME tile of earlier frames
    by_afoc = {}
    canvas_dims = {}  # frame_index -> (atlas frame width, height)
    seen_block_sizes = set()  # one packing block size per GOF (ASPS const)

    for atgl_idx in range(context.atlas_tile_layer_len()):
        atl = context.get_atlas_tile_layer(atgl_idx)
        ath = atl.header
        afps = context.get_afps(ath.atlas_frame_parameter_set_id)
        asps = context.get_asps(afps.atlas_sequence_parameter_set_id)
        geometry_bitdepth_3d = asps.geometry_3d_bitdepth_minus1 + 1
        frame_index = ath.frame_index

        # FRAMEWORK EXTENSION (atlas frame partitioning; the reference
        # is single-tile only, ``reader.rs:1266-1270``): each tile layer
        # derives against its TILE rect — patch coordinates, orientation
        # range checks, and ownership are tile-local — and the per-frame
        # merge below folds tiles onto the atlas canvas.
        afti = afps.atlas_frame_tile_information
        tile_idx = afti.tile_index_of(ath.id)
        tx, ty, tw, th = afti.tile_rect(
            tile_idx, asps.frame_width, asps.frame_height
        )
        # this tile's auxiliary-video band origin: the AFTI stacks one
        # aux tile row per tile, heights in units of 64 samples
        # (framework extension — the reference never demuxes an aux
        # video, ``reader.rs:74``)
        aux_band_y = 64 * sum(
            afti.auxiliary_video_tile_row_height[:tile_idx]
        )
        aux_band_h = 64 * (
            afti.auxiliary_video_tile_row_height[tile_idx]
            if tile_idx < len(afti.auxiliary_video_tile_row_height)
            else 0
        )

        def check_aux_band(kind: str, y0: int, h_pix: int) -> None:
            # band-relative coordinates must stay inside the tile's
            # declared aux band — straddling would read another
            # tile's rows
            if y0 + h_pix > aux_band_h:
                raise UnsupportedFeature(
                    f"aux {kind} patch rows [{y0},{y0 + h_pix}) leaves "
                    f"the tile's {aux_band_h}-row aux band"
                )
        canvas_dims[frame_index] = (asps.frame_width, asps.frame_height)
        meta = FrameMeta(
            frame_index=frame_index,
            tile_index=tile_idx,
            atl_index=atgl_idx,
            width=tw,
            height=th,
            left_top_in_frame=(tx, ty),
            tile_type=ath.tile_type,
            # FRAMEWORK EXTENSION: decoding-order patch precedence
            # (the reference asserts the flag false, codec.rs:340-347)
            patch_precedence=asps.patch_precedence_order_flag,
        )

        min_level = 1 << ath.pos_min_d_quantizer
        packing_block_size = 1 << asps.log2_patch_packing_block_size
        # the device group tables (and the GOF batch config) assume one
        # packing block size per GOF; surface a mix as a clean envelope
        # raise here rather than a ValueError deep in table building
        seen_block_sizes.add(packing_block_size)
        if len(seen_block_sizes) > 1:
            raise UnsupportedFeature(
                f"mixed patch packing block sizes in one GOF: "
                f"{sorted(seen_block_sizes)}"
            )

        def ref_frame(ref_index: int) -> FrameMeta:
            afocs = ref_afoc_list(context, ath, atl.atlas_frame_order_count_val)
            if ref_index >= len(afocs):
                raise UnsupportedFeature(
                    f"ref index {ref_index} beyond the active ref list"
                )
            afoc = afocs[ref_index]
            if (afoc, tile_idx) not in by_afoc:
                raise UnsupportedFeature(
                    f"reference tile afoc={afoc} tile={tile_idx} not "
                    f"decoded (GOFs are independent; refs cannot cross "
                    f"a GOF boundary)"
                )
            return by_afoc[(afoc, tile_idx)]

        if ath.tile_type == TileType.SKIP:
            # SKIP tile: the whole patch list replicates the first
            # reference frame's (TMC2 v18; the reference decoder panics
            # on non-I tiles, ``decoder.rs:403-407``)
            ref = ref_frame(0)
            meta.patches = [replace(p) for p in ref.patches]
            meta.raw_patches = [replace(p) for p in ref.raw_patches]
            meta.eom_patches = [
                replace(
                    p,
                    member_patches=list(p.member_patches),
                    member_points=list(p.member_points),
                )
                for p in ref.eom_patches
            ]
            by_afoc[(atl.atlas_frame_order_count_val, tile_idx)] = meta
            frames.append(meta)
            continue

        pred_index = 0  # inter-patch index predictor (TMC2 predIndex)
        for cur_idx, pid in enumerate(atl.patch_information_data):
            ptype = _patch_type(ath.tile_type, pid.patch_mode)
            # merge/skip copy the same-index REGULAR patch of the
            # reference frame; raw patches live in a separate list
            # (as in TMC2) so the index is the regular-patch count
            reg_idx = len(meta.patches)
            if ptype == "raw":
                pdu = pid.patch_data_unit
                rp = RawPatch(
                    u0=pdu.pos_2d[0],
                    v0=pdu.pos_2d[1],
                    size_u0=pdu.size_2d_minus1[0] + 1,
                    size_v0=pdu.size_2d_minus1[1] + 1,
                    u1=pdu.pos_3d_offset_u,
                    v1=pdu.pos_3d_offset_v,
                    d1=pdu.pos_3d_offset_d,
                    n_points=pdu.raw_points_minus1 + 1,
                    occupancy_resolution=packing_block_size,
                    in_aux_video=pdu.patch_in_auxiliary_video_flag,
                    aux_band_y=(
                        aux_band_y
                        if pdu.patch_in_auxiliary_video_flag else 0
                    ),
                )
                res = packing_block_size
                w_pix = rp.size_u0 * res
                h_pix = rp.size_v0 * res
                if rp.in_aux_video:
                    check_aux_band("raw", rp.v0 * res, h_pix)
                if not rp.in_aux_video and (
                    rp.u0 * res + w_pix > meta.width
                    or rp.v0 * res + h_pix > meta.height
                ):
                    raise UnsupportedFeature(
                        f"raw patch region {rp.size_u0}x{rp.size_v0} at "
                        f"({rp.u0},{rp.v0}) blocks leaves the "
                        f"{meta.width}x{meta.height} canvas"
                    )
                if 3 * rp.n_points > w_pix * h_pix:
                    raise UnsupportedFeature(
                        f"raw patch carries {rp.n_points} points but its "
                        f"{w_pix}x{h_pix} region holds only "
                        f"{w_pix * h_pix} geometry samples (need 3/point)"
                    )
                meta.raw_patches.append(rp)
                if log.isEnabledFor(logging.DEBUG):
                    log.debug(
                        "frame %d patch %d/raw: u0v0=(%d,%d) size=(%d,%d) "
                        "offsets=(%d,%d,%d) n=%d",
                        frame_index, cur_idx, rp.u0, rp.v0, rp.size_u0,
                        rp.size_v0, rp.u1, rp.v1, rp.d1, rp.n_points,
                    )
                continue
            if ptype == "eom":
                pdu = pid.patch_data_unit
                ep = EomPatch(
                    u0=pdu.pos_2d[0],
                    v0=pdu.pos_2d[1],
                    size_u0=pdu.size_2d_minus1[0] + 1,
                    size_v0=pdu.size_2d_minus1[1] + 1,
                    member_patches=list(pdu.associated_patch_idx),
                    member_points=list(pdu.points),
                    occupancy_resolution=packing_block_size,
                    in_aux_video=pdu.patch_in_auxiliary_video_flag,
                    aux_band_y=(
                        aux_band_y
                        if pdu.patch_in_auxiliary_video_flag else 0
                    ),
                )
                res = packing_block_size
                w_pix = ep.size_u0 * res
                h_pix = ep.size_v0 * res
                if ep.in_aux_video:
                    check_aux_band("EOM", ep.v0 * res, h_pix)
                if not ep.in_aux_video and (
                    ep.u0 * res + w_pix > meta.width
                    or ep.v0 * res + h_pix > meta.height
                ):
                    raise UnsupportedFeature(
                        f"EOM patch region {ep.size_u0}x{ep.size_v0} at "
                        f"({ep.u0},{ep.v0}) blocks leaves the "
                        f"{meta.width}x{meta.height} canvas"
                    )
                if sum(ep.member_points) > w_pix * h_pix:
                    raise UnsupportedFeature(
                        f"EOM patch declares {sum(ep.member_points)} "
                        f"points but its {w_pix}x{h_pix} region holds "
                        f"only {w_pix * h_pix} attribute samples"
                    )
                meta.eom_patches.append(ep)
                if log.isEnabledFor(logging.DEBUG):
                    log.debug(
                        "frame %d patch %d/eom: u0v0=(%d,%d) size=(%d,%d) "
                        "members=%s points=%s",
                        frame_index, cur_idx, ep.u0, ep.v0, ep.size_u0,
                        ep.size_v0, ep.member_patches, ep.member_points,
                    )
                continue
            if ptype == "intra":
                pdu: IntraPatchDataUnit = pid.patch_data_unit
                if asps.patch_size_quantizer_present_flag:
                    # FRAMEWORK EXTENSION: quantized patch sizes (the
                    # reference's derivation sketch is dead code behind
                    # its ASPS assert, ``decoder.rs:442-460``). The
                    # coded size is in 2^quantizer pixel units; the
                    # block footprint rounds it up and the exact pixel
                    # extent gates point emission (TMC2 v18
                    # enableSizeQuantization).
                    qx = 1 << ath.patch_size_info_quantizer[0]
                    qy = 1 << ath.patch_size_info_quantizer[1]
                    px = (pdu.size_2d_minus1[0] + 1) * qx
                    py = (pdu.size_2d_minus1[1] + 1) * qy
                    size_uv0 = (
                        -(-px // packing_block_size),
                        -(-py // packing_block_size),
                    )
                    size_pix = (px, py)
                else:
                    size_uv0 = (
                        pdu.size_2d_minus1[0] + 1,
                        pdu.size_2d_minus1[1] + 1,
                    )
                    size_pix = None
                patch = Patch(
                    occupancy_resolution=packing_block_size,
                    uv0=pdu.pos_2d,
                    uv1=pdu.pos_3d_offset,
                    size_d=(
                        0
                        if pdu.pos_3d_range_d == 0
                        else pdu.pos_3d_range_d * min_level - 1
                    ),
                    size_uv0=size_uv0,
                    size_2d_in_pixel=size_pix,
                    patch_orientation=pdu.orientation_index,
                )
                patch.set_view_id(pdu.projection_id)
                if pdu.lod_enabled_flag:
                    # LoDScaleY floor is 2 when LoDScaleX stays 1: the
                    # (1,1) identity is never coded with the flag on
                    # (23090-5 §9.2.5 derivation, TMC2 v18 setLodScaleY)
                    sx = pdu.lod_scale_x_minus1 + 1
                    sy = pdu.lod_scale_y_idc + (1 if sx > 1 else 2)
                    patch.level_of_detail = (sx, sy)
                if pdu.plr_data:
                    patch.plr_modes = _plr_modes_from_plrd(
                        pdu.plr_data, asps,
                        patch.size_uv0[0] * patch.size_uv0[1],
                    )
                if patch.projection_mode == 0:
                    patch.d1 = pdu.pos_3d_offset_d * min_level
                else:
                    patch.d1 = (1 << geometry_bitdepth_3d) - pdu.pos_3d_offset_d * min_level
                if patch.axes not in ((0, 2, 1), (1, 2, 0), (2, 0, 1)):
                    raise UnsupportedFeature(f"unexpected axes {patch.axes}")
                _check_orientation_in_range(patch, meta.width, meta.height)
                meta.patches.append(patch)
            elif ptype == "inter":
                pdu = pid.patch_data_unit
                ref = ref_frame(pdu.ref_index)
                ref_patch_idx = pred_index + pdu.ref_patch_index
                if not 0 <= ref_patch_idx < len(ref.patches):
                    raise UnsupportedFeature(
                        f"inter ref patch index {ref_patch_idx} out of range"
                    )
                pred_index = ref_patch_idx + 1
                patch = _derive_inter_patch(
                    pdu, ref.patches[ref_patch_idx], min_level,
                    geometry_bitdepth_3d, packing_block_size,
                )
                if pdu.plr_data:
                    # FRAMEWORK EXTENSION: P-tile PLR — inter patches
                    # code plrd fresh (never inherited)
                    patch.plr_modes = _plr_modes_from_plrd(
                        pdu.plr_data, asps,
                        patch.size_uv0[0] * patch.size_uv0[1],
                    )
                # deltas may move/resize the footprint (orientation is
                # inherited, but the in-range condition is geometric)
                _check_orientation_in_range(patch, meta.width, meta.height)
                meta.patches.append(patch)
            elif ptype == "merge":
                pdu = pid.patch_data_unit
                ref = ref_frame(pdu.ref_index)
                if reg_idx >= len(ref.patches):
                    raise UnsupportedFeature(
                        f"merge patch index {reg_idx} beyond reference list"
                    )
                patch = _derive_merge_patch(
                    pdu, ref.patches[reg_idx], min_level,
                    geometry_bitdepth_3d, packing_block_size,
                )
                if pdu.override_plr_flag and pdu.plr_data:
                    # FRAMEWORK EXTENSION: P-tile PLR — fresh plrd on
                    # 2D override
                    patch.plr_modes = _plr_modes_from_plrd(
                        pdu.plr_data, asps,
                        patch.size_uv0[0] * patch.size_uv0[1],
                    )
                elif patch.plr_modes is not None:
                    # inherited modes must still tile the (possibly
                    # resized) footprint; copy so frames don't alias
                    bc = patch.size_uv0[0] * patch.size_uv0[1]
                    if len(patch.plr_modes) != bc:
                        raise UnsupportedFeature(
                            "merge patch resized without a PLR override "
                            f"({len(patch.plr_modes)} inherited modes, "
                            f"{bc} blocks)"
                        )
                    patch.plr_modes = list(patch.plr_modes)
                _check_orientation_in_range(patch, meta.width, meta.height)
                meta.patches.append(patch)
            elif ptype == "skip":
                # P_SKIP: verbatim copy of the same-index reference patch
                ref = ref_frame(0)
                if reg_idx >= len(ref.patches):
                    raise UnsupportedFeature(
                        f"skip patch index {reg_idx} beyond reference list"
                    )
                meta.patches.append(
                    replace(
                        ref.patches[reg_idx],
                        occupancy_resolution=packing_block_size,
                    )
                )
            else:
                raise UnsupportedFeature(f"unknown patch mode {pid.patch_mode}")
            if log.isEnabledFor(logging.DEBUG):
                # patch dump mirroring the reference's trace
                # (``src/decoder.rs:480``), for cross-decoder diffing
                p = meta.patches[-1]
                log.debug(
                    "frame %d patch %d/%s: u0v0=%s size_uv0=%s uv1=%s d1=%d "
                    "axes=%s mode=%d orient=%s",
                    frame_index, cur_idx, ptype, p.uv0, p.size_uv0, p.uv1,
                    p.d1, p.axes, p.projection_mode, p.patch_orientation.name,
                )
        # EOM member indices may forward-reference regular patches, so
        # validate against the tile's FINAL regular-patch list
        for ep in meta.eom_patches:
            for m in ep.member_patches:
                if not 0 <= m < len(meta.patches):
                    raise UnsupportedFeature(
                        f"EOM member patch index {m} out of range "
                        f"(tile has {len(meta.patches)} regular patches)"
                    )
        by_afoc[(atl.atlas_frame_order_count_val, tile_idx)] = meta
        frames.append(meta)

    return _merge_tile_frames(frames, canvas_dims)


def _merge_tile_frames(
    frames: List[FrameMeta], canvas_dims
) -> List[FrameMeta]:
    """Fold each frame's tile metas onto the atlas canvas (FRAMEWORK
    EXTENSION, atlas frame partitioning — the reference is single-tile
    only, ``reader.rs:1266-1270``).

    Tiles are disjoint canvas rects, so offsetting every patch by its
    tile's block origin preserves ownership (contests only happen
    within a tile) and reproduces TMC2's reconstruction order (tiles
    ascending, patches in tile order). Downstream — oracle, group
    tables, device kernels, raw/EOM/PLR — then sees ONE frame-sized
    meta and needs no tile awareness."""
    by_frame: dict = {}
    order: List[int] = []
    for m in frames:
        if m.frame_index not in by_frame:
            order.append(m.frame_index)
            by_frame[m.frame_index] = []
        by_frame[m.frame_index].append(m)

    out: List[FrameMeta] = []
    for fi in order:
        tiles = by_frame[fi]
        if (
            len(tiles) == 1
            and tiles[0].left_top_in_frame == (0, 0)
            and (tiles[0].width, tiles[0].height) == canvas_dims[fi]
        ):
            # single tile covering the canvas: dims already match
            out.append(tiles[0])
            continue
        seen = [t.tile_index for t in tiles]
        if len(set(seen)) != len(seen):
            raise UnsupportedFeature(
                f"frame {fi} carries duplicate tile layers {sorted(seen)}"
            )
        tiles = sorted(tiles, key=lambda t: t.tile_index)
        cw, ch = canvas_dims[fi]
        merged = FrameMeta(
            frame_index=fi,
            tile_index=0,
            atl_index=tiles[0].atl_index,
            width=cw,
            height=ch,
            tile_type=tiles[0].tile_type,
            patch_precedence=tiles[0].patch_precedence,
        )
        for t in tiles:
            tx, ty = t.left_top_in_frame
            res = (
                t.patches[0].occupancy_resolution if t.patches
                else t.raw_patches[0].occupancy_resolution if t.raw_patches
                else t.eom_patches[0].occupancy_resolution if t.eom_patches
                else None
            )
            if res is None:
                continue  # empty tile contributes nothing
            if tx % res != 0 or ty % res != 0:
                raise UnsupportedFeature(
                    f"tile origin ({tx},{ty}) px not aligned to the "
                    f"{res}-px packing block (cannot fold tiles onto "
                    f"the canvas block grid)"
                )
            bx0, by0 = tx // res, ty // res
            base = len(merged.patches)
            for p in t.patches:
                merged.patches.append(
                    replace(p, uv0=(p.uv0[0] + bx0, p.uv0[1] + by0))
                )
            # aux-video coordinates stay BAND-relative (the tile's
            # band origin rides ``aux_band_y``); only main-canvas
            # regions fold onto the atlas block grid
            for rp in t.raw_patches:
                merged.raw_patches.append(
                    replace(
                        rp,
                        u0=rp.u0 if rp.in_aux_video else rp.u0 + bx0,
                        v0=rp.v0 if rp.in_aux_video else rp.v0 + by0,
                    )
                )
            for ep in t.eom_patches:
                merged.eom_patches.append(
                    replace(
                        ep,
                        u0=ep.u0 if ep.in_aux_video else ep.u0 + bx0,
                        v0=ep.v0 if ep.in_aux_video else ep.v0 + by0,
                        member_patches=[
                            m + base for m in ep.member_patches
                        ],
                        member_points=list(ep.member_points),
                    )
                )
        out.append(merged)
    return out
