"""Flagship configuration: the 1280^2 two-map decode (BASELINE config 1).

Counterpart of ``tpu_vpcc.models.flagship``: the configuration plus
synthetic inputs shaped like a real 8iVFB frame (random content made
from a seed; about 0.95M points per frame at the defaults). "Model" is
the decoder's reconstruction graph; there are no trainable parameters.

The wide path's features at this shape: ``example_gof`` takes geometry
and colour smoothing configs (BASELINE config 4's feature set;
:data:`GEO_SMOOTHING` and :data:`ATTR_SMOOTHING` are the values of
``bench.py``'s smoothing family), and ``example_frames`` can put a share
of the patches on 45-degree views, as ``bench.py``'s proj45 family sets
them. The gather fallback's: ``example_frames`` can turn a share of the
patches to rotated orientations (:data:`ROTATED`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Tuple

import numpy as np

from ..atlas import groups as G
from ..atlas.patches import Patch, _check_orientation_in_range
from ..v3c.syntax import PatchOrientation, UnsupportedFeature
from ..ops.reconstruct import FrameConfig, make_config
from ..ops.smoothing import AttrSmoothingConfig, SmoothingConfig
from ..ops.tiled import tile_plane
from ..runtime.host import GofData
from ..utils.synthetic import SyntheticFrame, make_synthetic_frame


@dataclass
class FlagshipConfig:
    """8iVFB-class single-stream configuration (BASELINE.json config 1)."""

    width: int = 1280
    height: int = 1280
    occupancy_resolution: int = 16
    occupancy_precision: int = 4
    map_count: int = 2
    batch: int = 4  # frames per example batch

    def frame_config(self) -> FrameConfig:
        return make_config(
            width=self.width,
            height=self.height,
            occupancy_resolution=self.occupancy_resolution,
            occupancy_precision=self.occupancy_precision,
            map_count=self.map_count,
        )


#: geometry smoothing of bench.py's smoothing family: SEI (8, 16)
GEO_SMOOTHING = SmoothingConfig(grid_size=8, threshold=16)
#: colour smoothing of bench.py's smoothing family: SEI (8, 255, 1)
ATTR_SMOOTHING = AttrSmoothingConfig(8, 255, 1)


def set_45_degree_views(sf: SyntheticFrame, share: float, seed: int) -> int:
    """Put about ``share`` of the frame's patches on 45-degree views, in
    place: the chosen patches (drawn from ``seed``) take, in turn,
    additional planes 1, 2 and 3 with their projection mode kept, as
    ``bench.py``'s proj45 family sets them. Returns how many moved."""
    patches = sf.meta.patches
    n = int(round(share * len(patches)))
    chosen = np.random.default_rng(seed).choice(len(patches), n, replace=False)
    for j, i in enumerate(sorted(chosen)):
        p = patches[i]
        plane = 1 + j % 3
        p.set_view_id(next(
            v for v, r in Patch._VIEW_TABLE.items()
            if r[0] == plane and r[4] == p.projection_mode
        ))
    return n


#: the orientations that leave block alignment at resolution > 1 (the
#: tmc2-rs size quirk), so their frames take the gather fallback
ROTATED = (
    PatchOrientation.ROT90, PatchOrientation.ROT180, PatchOrientation.ROT270,
    PatchOrientation.MIRROR, PatchOrientation.MROT90,
    PatchOrientation.MROT180,
)


def rotate_patches(patches: List[Patch], share: float, seed: int,
                   width: int, height: int) -> Tuple[List[Patch], int]:
    """About ``share`` of ``patches`` (drawn from ``seed``) turned to an
    orientation of :data:`ROTATED`, each the first of a random order of
    them that the reference's range gate admits on a ``width`` x
    ``height`` canvas (a patch none fits keeps its own). Returns the new
    list and how many patches turned."""
    rng = np.random.default_rng(seed)
    out = list(patches)
    n = int(round(share * len(out)))
    turned = 0
    for i in sorted(rng.choice(len(out), n, replace=False)):
        for o in rng.permutation(len(ROTATED)):
            p = replace(out[i], patch_orientation=ROTATED[o])
            try:
                _check_orientation_in_range(p, width, height)
            except UnsupportedFeature:
                continue
            out[i] = p
            turned += 1
            break
    return out, turned


def example_frames(cfg: FlagshipConfig, seed: int = 0, n_patches: int = 48,
                   occupancy_fill: float = 0.7, views45: float = 0.0,
                   rotated: float = 0.0) -> List[SyntheticFrame]:
    """``cfg.batch`` synthetic frames (frame k from seed ``seed + k``);
    ``views45`` is the share of each frame's patches put on 45-degree
    views (:func:`set_45_degree_views`), ``rotated`` the share turned to
    rotated orientations (:func:`rotate_patches`), whose planes are then
    made anew for the turned footprints."""

    def frame(k, patches=None):
        return make_synthetic_frame(
            np.random.default_rng(seed + k),
            width=cfg.width,
            height=cfg.height,
            occupancy_resolution=cfg.occupancy_resolution,
            occupancy_precision=cfg.occupancy_precision,
            map_count=cfg.map_count,
            n_patches=n_patches,
            occupancy_fill=occupancy_fill,
            frame_index=k,
            patches=patches,
        )

    frames = [frame(k) for k in range(cfg.batch)]
    if rotated:
        frames = [
            frame(k, rotate_patches(sf.meta.patches, rotated, seed + k,
                                    cfg.width, cfg.height)[0])
            for k, sf in enumerate(frames)
        ]
    if views45:
        for k, sf in enumerate(frames):
            set_45_degree_views(sf, views45, seed=seed + k)
    return frames


def example_batch_inputs(cfg: FlagshipConfig, seed: int = 0, frames=None,
                         **kw) -> Tuple:
    """Batched raster inputs ``(fields, occ, geo0, geo1, ay, au, av)``,
    each with a leading frame axis (attributes with a map axis next)."""
    frames = example_frames(cfg, seed=seed, **kw) if frames is None else frames

    tables, _ = G.build_group_tables([sf.meta for sf in frames])

    def one(sf, table):
        return (
            table.fields,
            sf.occ_plane,
            sf.geo_planes[0],
            sf.geo_planes[1] if cfg.map_count > 1 else sf.geo_planes[0],
            np.stack([p[0] for p in sf.attr_planes]),
            np.stack([p[1] for p in sf.attr_planes]),
            np.stack([p[2] for p in sf.attr_planes]),
        )

    per = [one(sf, t) for sf, t in zip(frames, tables)]
    return tuple(np.stack([f[i] for f in per]) for i in range(7))


def example_pretiled_batch_inputs(cfg: FlagshipConfig, seed: int = 0, **kw) -> Tuple:
    """Batched inputs in the block-tiled layout the staging packs."""
    raw = example_batch_inputs(cfg, seed=seed, **kw)
    res = cfg.occupancy_resolution
    return (
        raw[0],
        tile_plane(raw[1], res // cfg.occupancy_precision),
        tile_plane(raw[2], res),
        tile_plane(raw[3], res),
        tile_plane(raw[4], res),
        tile_plane(raw[5], res // 2),
        tile_plane(raw[6], res // 2),
    )


def bucket_flagship_inputs(raw, fcfg: FrameConfig):
    """Apply the pipeline's group-axis bucketing and pack30 gating to
    flagship example inputs. Returns ``(raw_bucketed, fcfg', g_bucket,
    n_live)``."""
    n_live = int(raw[0][:, :, G.G_VALID].sum(axis=1).max())
    g_bucket = G.bucket_group_count(n_live, raw[0].shape[1])
    raw = (np.ascontiguousarray(raw[0][:, :g_bucket]),) + tuple(raw[1:])
    pack30 = all(
        G.coords_fit_10bit(
            raw[0][k], g_bucket, fcfg.occupancy_resolution, fcfg.geo_shift,
            fcfg.absolute_d1,
        )
        for k in range(raw[0].shape[0])
    )
    return raw, replace(fcfg, pack30=pack30), g_bucket, n_live


def example_gof(cfg: FlagshipConfig, frames: List[SyntheticFrame],
                tiled: bool = True, geo_smoothing=None,
                attr_smoothing=None, geometry_bits: int = 10) -> GofData:
    """A decoded GOF as ``prepare_gof`` hands it to the reconstruction:
    geometry and attribute planes block-tiled (the layout the native
    video bridge emits; raster for the oracle path when ``tiled`` is
    false), occupancy raster, 10-bit 4:2:0 YUV attributes, and the
    smoothing configs as the applied SEIs would set them (None = off).
    ``geometry_bits`` > 10 widens the geometry samples (scaled by
    ``2**(geometry_bits - 10)`` and read with as much more ``geo_shift``,
    so the points stay those of the 10-bit GOF); such a GOF is not
    10-bit packable and takes the gather fallback.
    ``frames[k].meta.frame_index`` must be ``k``."""
    res = cfg.occupancy_resolution
    mc = cfg.map_count
    wider = geometry_bits - 10

    def lay(plane, t):
        return tile_plane(plane, t) if tiled else plane

    geo, attr = [], []
    for sf in frames:
        for m in range(mc):
            geo.append(lay(sf.geo_planes[m] << wider, res))
            y, u, v = sf.attr_planes[m]
            attr.append([lay(y, res), lay(u, res // 2), lay(v, res // 2)])
    return GofData(
        metas=[sf.meta for sf in frames],
        occ_planes=np.stack([sf.occ_plane for sf in frames]),
        geo_planes=geo,
        attr_planes=attr,
        map_count=mc,
        occupancy_precision=cfg.occupancy_precision,
        occupancy_resolution=res,
        absolute_d1=True,
        geo_shift=2 + wider,
        attribute_count=1,
        frame_count=len(frames),
        tiled=tiled,
        tile_size=res if tiled else 0,
        geo_smoothing=geo_smoothing,
        attr_smoothing=attr_smoothing,
        packed10_ok=geometry_bits <= 10,
    )
