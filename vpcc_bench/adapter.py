"""The program's input objects, built from the benchmark's plain arrays.

Each GOF is what the program's ``runtime.pipeline.prepare_gof`` hands to
the reconstruction after the V3C parse and the HEVC decode: a
``GofData`` with the geometry and attribute planes block-tiled (the
layout the native video bridge emits), occupancy raster, 10-bit 4:2:0
attributes, and the smoothing configurations as the applied SEIs set
them. The types are the program's API; this module is the only one of
the benchmark's that names them, apart from ``run.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .gen import (P_D1, P_ORIENT, P_SIZE_D, P_SU0, P_SV0, P_U0, P_U1, P_V0,
                  P_V1, P_VIEW, SWAP, FramePlain)


@dataclass
class StagedGof:
    """A pool GOF's planes in the layout the program takes, made once at
    set-up; :func:`gof_data` wraps them in fresh objects per hand-over."""

    frames: List[FramePlain]
    occ: np.ndarray
    geo: List[np.ndarray]
    attr: List[List[np.ndarray]]


def _tile(plane: np.ndarray, t: int) -> np.ndarray:
    """(H, W) -> (H/t * W/t, t, t), blocks in raster order."""
    H, W = plane.shape
    x = plane.reshape(H // t, t, W // t, t).swapaxes(1, 2)
    return np.ascontiguousarray(x.reshape(-1, t, t))


def stage(frames: List[FramePlain], config: dict) -> StagedGof:
    res = config["occupancy_resolution"]
    geo, attr = [], []
    for f in frames:
        for m in range(config["map_count"]):
            geo.append(_tile(f.geo[m], res))
            y, u, v = f.attr[m]
            attr.append([_tile(y, res), _tile(u, res // 2),
                         _tile(v, res // 2)])
    return StagedGof(frames=frames, occ=np.stack([f.occ for f in frames]),
                     geo=geo, attr=attr)


def _metas(frames: List[FramePlain], config: dict):
    from tpu_vpcc_torch.atlas.patches import FrameMeta, Patch
    from tpu_vpcc_torch.v3c.syntax import PatchOrientation

    res = config["occupancy_resolution"]
    metas = []
    for k, f in enumerate(frames):
        patches = []
        for p in f.patches.tolist():
            patch = Patch(
                uv0=(p[P_U0], p[P_V0]), size_uv0=(p[P_SU0], p[P_SV0]),
                uv1=(p[P_U1], p[P_V1]), occupancy_resolution=res,
                patch_orientation=(PatchOrientation.SWAP
                                   if p[P_ORIENT] == SWAP
                                   else PatchOrientation.DEFAULT),
            )
            patch.set_view_id(p[P_VIEW])
            patch.d1 = p[P_D1]
            patch.size_d = p[P_SIZE_D]
            patches.append(patch)
        metas.append(FrameMeta(frame_index=k, width=config["width"],
                               height=config["height"], patches=patches))
    return metas


def smoothing_configs(config: dict):
    """The program's smoothing configurations for ``config`` (None where
    the deployment decodes without that smoothing)."""
    from tpu_vpcc_torch.ops.smoothing import (AttrSmoothingConfig,
                                              SmoothingConfig)

    g, a = config.get("geo_smoothing"), config.get("attr_smoothing")
    bits = config["geometry_bitdepth_3d"]
    return (
        SmoothingConfig(grid_size=g["grid_size"], threshold=g["threshold"],
                        geometry_bitdepth_3d=bits) if g else None,
        AttrSmoothingConfig(a["grid_size"], a["threshold_variation"],
                            a["threshold_difference"], bits) if a else None,
    )


def gof_data(staged: StagedGof, config: dict, tiled: bool = True):
    """A fresh ``GofData`` (and fresh patch and frame objects) over the
    staged planes; ``tiled=False`` gives the raster planes the program's
    numpy oracle reads."""
    from tpu_vpcc_torch.runtime.host import GofData

    res = config["occupancy_resolution"]
    geo_sm, attr_sm = smoothing_configs(config)
    if tiled:
        geo, attr = staged.geo, staged.attr
    else:
        geo = [f.geo[m] for f in staged.frames
               for m in range(config["map_count"])]
        attr = [list(f.attr[m]) for f in staged.frames
                for m in range(config["map_count"])]
    return GofData(
        metas=_metas(staged.frames, config),
        occ_planes=staged.occ,
        geo_planes=list(geo),
        attr_planes=[list(a) for a in attr],
        map_count=config["map_count"],
        occupancy_precision=config["occupancy_precision"],
        occupancy_resolution=res,
        absolute_d1=True,
        geo_shift=config["geo_shift"],
        attribute_count=1,
        frame_count=len(staged.frames),
        tiled=tiled,
        tile_size=res if tiled else 0,
        geo_smoothing=geo_sm,
        attr_smoothing=attr_sm,
        packed10_ok=True,
        geometry_bitdepth_3d=config["geometry_bitdepth_3d"],
    )
