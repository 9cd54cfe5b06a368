"""NumPy scalar oracle for point-cloud reconstruction.

A faithful, loop-for-loop port of the reference reconstruction kernels
(``src/codec.rs:205-658``): block-to-patch map, occupancy upsampling,
per-pixel point generation from the D0/D1 depth maps, duplicate
suppression, emission order, and YUV420 attribute transfer. This is the
bit-exactness baseline every device kernel in ``tpu_vpcc.ops`` is
diff-tested against. It is intentionally scalar and slow — use the JAX
pipeline for real decoding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..atlas.patches import FrameMeta, Patch, inverse_rotate_45
from .pointset import PointSet3


@dataclass
class GeneratePointCloudParams:
    """Distilled reconstruction parameters (``src/codec.rs:140-170``)."""

    occupancy_resolution: int = 16
    occupancy_precision: int = 4
    absolute_d1: bool = True
    map_count_minus1: int = 1
    multiple_streams: bool = False
    geometry_bitdepth_3d: int = 10
    attribute_count: int = 1
    # depth = sample >> geo_shift: the reference divides by 4 because
    # libavcodec yields 10-bit planes (``src/codec.rs:532-534``);
    # generalized to the decoded bit depth like the device kernels
    geo_shift: int = 2


def generate_block_to_patch(
    meta: FrameMeta,
    occ_plane: np.ndarray,
    occupancy_resolution: int,
    occupancy_precision: int,
) -> np.ndarray:
    """``generate_block_to_patch_from_occupancy_map_video``
    (``src/codec.rs:205-250``). Later patches overwrite earlier ones —
    reversed under decoding-order precedence (``meta.patch_precedence``,
    framework extension)."""
    bw = meta.width // occupancy_resolution
    bh = meta.height // occupancy_resolution
    block_to_patch = np.zeros(bw * bh, dtype=np.int64)
    lt_x, lt_y = meta.left_top_in_frame
    order = (
        range(len(meta.patches) - 1, -1, -1)
        if meta.patch_precedence else range(len(meta.patches))
    )
    for patch_index in order:
        patch = meta.patches[patch_index]
        for v0 in range(patch.size_uv0[1]):
            for u0 in range(patch.size_uv0[0]):
                block_index = patch.patch_block_to_canvas_block(u0, v0, bw, bh)
                non_zero = 0
                for v1 in range(patch.occupancy_resolution):
                    v = v0 * patch.occupancy_resolution + v1
                    for u1 in range(patch.occupancy_resolution):
                        u = u0 * patch.occupancy_resolution + u1
                        x, y = patch.patch_to_canvas(u, v, meta.width, meta.height)
                        x += lt_x
                        y += lt_y
                        non_zero += int(
                            occ_plane[y // occupancy_precision, x // occupancy_precision]
                        )
                if non_zero > 0:
                    block_to_patch[block_index] = patch_index + 1
    return block_to_patch


def upsample_occupancy(
    meta: FrameMeta, occ_plane: np.ndarray, occupancy_precision: int
) -> np.ndarray:
    """Nearest-neighbour occupancy upscale (``src/codec.rs:288-301``)."""
    h, w = meta.height, meta.width
    lt_x, lt_y = meta.left_top_in_frame
    ys = (lt_y + np.arange(h)) // occupancy_precision
    xs = (lt_x + np.arange(w)) // occupancy_precision
    return occ_plane[np.ix_(ys, xs)]


def _generate_points(
    params: GeneratePointCloudParams,
    patch: Patch,
    geo_frame0: np.ndarray,
    geo_frame1: Optional[np.ndarray],
    u: int,
    v: int,
    x: int,
    y: int,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """``generate_points`` (``src/codec.rs:517-565``).

    Depth is the Y sample divided by 4: libavcodec yields 10-bit planes
    where TMC2's video decode path yields 8-bit (``src/codec.rs:532-534``).
    """
    point0 = patch.generate_point(u, v, int(geo_frame0[y, x]) >> params.geo_shift)
    point1 = None
    if params.map_count_minus1 > 0:
        d1 = int(geo_frame1[y, x]) >> params.geo_shift
        if params.absolute_d1:
            point1 = patch.generate_point(u, v, d1)
        else:
            point1 = point0.copy()
            normal = patch.axes[0]
            if patch.projection_mode == 0:
                point1[normal] = np.uint16((int(point1[normal]) + d1) & 0xFFFF)
            else:
                point1[normal] = np.uint16((int(point1[normal]) - d1) & 0xFFFF)
    return point0, point1


def generate_point_cloud(
    meta: FrameMeta,
    params: GeneratePointCloudParams,
    occ_plane: np.ndarray,
    geo_planes: List[np.ndarray],
    attr_videos: Optional[List[List[List[np.ndarray]]]] = None,
) -> Tuple[PointSet3, List[int], List[Tuple[int, int, int]]]:
    """``generate_point_cloud`` (``src/codec.rs:256-514``).

    geo_planes: the geometry video's Y planes, indexed
    ``frame_index * map_count + map`` (``src/codec.rs:317``).
    attr_videos: per attribute, per video frame, [y, u, v] planes.

    Returns (point set, per-point patch partition, point_to_pixel).
    """
    occupancy_map = upsample_occupancy(meta, occ_plane, params.occupancy_precision)
    block_to_patch = generate_block_to_patch(
        meta, occ_plane, params.occupancy_resolution, params.occupancy_precision
    )
    bw = meta.width // params.occupancy_resolution
    bh = meta.height // params.occupancy_resolution
    map_count = params.map_count_minus1 + 1
    video_frame_index = meta.frame_index * map_count

    positions: List[np.ndarray] = []
    partition: List[int] = []
    point_to_pixel: List[Tuple[int, int, int]] = []
    # FRAMEWORK EXTENSION (>2 maps): maps beyond the first pair append
    # as trailing surface layers, per map, in the same patch/block/pixel
    # order — map m's point is suppressed iff equal to map m-1's point
    # (the m=1 rule of ``codec.rs:421-427`` applied pairwise). Buffered
    # here during the single iteration, appended after the main points.
    layers: List[Tuple[List[np.ndarray], List[int],
                       List[Tuple[int, int, int]]]] = [
        ([], [], []) for _ in range(max(0, map_count - 2))
    ]

    for patch_index, patch in enumerate(meta.patches):
        for v0 in range(patch.size_uv0[1]):
            for u0 in range(patch.size_uv0[0]):
                block_index = patch.patch_block_to_canvas_block(u0, v0, bw, bh)
                if block_to_patch[block_index] != patch_index + 1:
                    continue
                for v1 in range(patch.occupancy_resolution):
                    v = v0 * patch.occupancy_resolution + v1
                    for u1 in range(patch.occupancy_resolution):
                        u = u0 * patch.occupancy_resolution + u1
                        x, y = patch.patch_to_canvas(u, v, meta.width, meta.height)
                        if occupancy_map[y, x] == 0:
                            continue
                        if patch.size_2d_in_pixel is not None and (
                            u >= patch.size_2d_in_pixel[0]
                            or v >= patch.size_2d_in_pixel[1]
                        ):
                            # FRAMEWORK EXTENSION (patch size quantizer,
                            # TMC2 v18 enableSizeQuantization): the block
                            # footprint rounds the quantized size up;
                            # occupied pixels past the exact pixel
                            # extent are not patch content
                            continue
                        x_vid = x + meta.left_top_in_frame[0]
                        y_vid = y + meta.left_top_in_frame[1]
                        point0, point1 = _generate_points(
                            params,
                            patch,
                            geo_planes[video_frame_index],
                            geo_planes[video_frame_index + 1]
                            if map_count > 1
                            else None,
                            u,
                            v,
                            x_vid,
                            y_vid,
                        )
                        created = [point0] + ([point1] if point1 is not None else [])

                        def emit(point, z, pos_l, part_l, p2p_l):
                            if patch.axis_of_additional_plane != 0:
                                # FRAMEWORK EXTENSION: 45-degree views —
                                # the reference is ``unimplemented!`` here
                                # (``src/codec.rs:429-440``); see the
                                # convention note in atlas.patches
                                point = np.array(
                                    inverse_rotate_45(
                                        patch.axis_of_additional_plane,
                                        params.geometry_bitdepth_3d,
                                        point,
                                    ),
                                    dtype=np.uint16,
                                )
                            pos_l.append(point)
                            part_l.append(patch_index)
                            p2p_l.append((x, y, z))

                        for i, point in enumerate(created):
                            # Duplicate suppression: D1 point equal to the
                            # D0 point is skipped (``src/codec.rs:421-427``).
                            if i != 0 and np.array_equal(point, created[0]):
                                continue
                            emit(point, i, positions, partition, point_to_pixel)
                        # trailing layers: map m vs map m-1, both
                        # absolute (gated upstream), pre-rotation values
                        prev = point1
                        for m in range(2, map_count):
                            d_m = (
                                int(geo_planes[video_frame_index + m][y_vid, x_vid])
                                >> params.geo_shift
                            )
                            point_m = patch.generate_point(u, v, d_m)
                            if not np.array_equal(point_m, prev):
                                emit(point_m, m, *layers[m - 2])
                            prev = point_m

    for pos_l, part_l, p2p_l in layers:
        positions += pos_l
        partition += part_l
        point_to_pixel += p2p_l

    ps = PointSet3(
        positions=(
            np.stack(positions) if positions else np.empty((0, 3), dtype=np.uint16)
        ),
        with_colors=params.attribute_count > 0,
    )
    n = ps.point_count
    ps.colors = np.full((n, 3), 127, dtype=np.uint8)
    ps.colors16bit = np.zeros((n, 3), dtype=np.uint16)

    if attr_videos is not None:
        for attr_video in attr_videos[: params.attribute_count]:
            color_point_cloud(ps, meta, params, attr_video, point_to_pixel)

    return ps, partition, point_to_pixel


def color_point_cloud(
    ps: PointSet3,
    meta: FrameMeta,
    params: GeneratePointCloudParams,
    attr_video: List[List[np.ndarray]],
    point_to_pixel: List[Tuple[int, int, int]],
) -> None:
    """``color_point_cloud`` (``src/codec.rs:568-658``): per point, sample
    YUV420 at the recorded pixel from the map-selected attribute frame."""
    if ps.point_count == 0:
        return
    map_count = params.map_count_minus1 + 1
    shift = meta.frame_index * map_count
    lt_x, lt_y = meta.left_top_in_frame
    for i, (px, py, z) in enumerate(point_to_pixel):
        x = px + lt_x
        y = py + lt_y
        if z < map_count:
            planes = attr_video[z + shift]
            ps.colors16bit[i, 0] = planes[0][y, x]
            # format-driven chroma indexing (``src/decoder.rs:973-980``):
            # half-res planes are 4:2:0, full-res are 4:4:4
            csh = 0 if planes[1].shape == planes[0].shape else 1
            ps.colors16bit[i, 1] = planes[1][y >> csh, x >> csh]
            ps.colors16bit[i, 2] = planes[2][y >> csh, x >> csh]
        else:
            raise NotImplementedError("intermediate layer color transfer")
