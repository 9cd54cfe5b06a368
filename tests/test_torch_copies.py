"""The port's own copies of tpu_vpcc's host layers against the originals.

``tpu_vpcc_torch`` keeps its own copies of the jax-free host modules
(``bitio``, ``v3c``, ``atlas``, ``video``, ``reconstruction``, ``utils``,
the smoothing configs and numpy oracle, the colour tables, the host half
of the pipeline). Each copy must compute what its original computes:
the same stream bytes parse to the same patch frames, the same group
tables, the same oracle point clouds and the same PLY bytes, over the
fixture families of ``test_torch_e2e``; the synthetic scenes and the
flagship GOF made from one seed are equal array for array.
"""

from __future__ import annotations

import dataclasses
import enum
import functools

import numpy as np
import pytest

from test_torch_e2e import STREAM_PARAMS, STREAMS, needs_encoder
from tpu_vpcc.atlas import groups as ref_groups
from tpu_vpcc.atlas.patches import create_patch_frames as ref_create_patch_frames
from tpu_vpcc.bitio import Bitstream as RefBitstream
from tpu_vpcc.ops import color as ref_color
from tpu_vpcc.ops import smoothing as ref_smoothing
from tpu_vpcc.ops.tiled import tile_plane as ref_tile_plane
from tpu_vpcc.runtime import pipeline as ref_pipeline
from tpu_vpcc.utils import ply as ref_ply
from tpu_vpcc.utils.synthetic import make_synthetic_frame as ref_make_synthetic_frame
from tpu_vpcc.v3c.context import Context as RefContext
from tpu_vpcc.v3c.stream import SampleStreamV3CUnit as RefSSVU
from tpu_vpcc_torch.atlas import groups as port_groups
from tpu_vpcc_torch.atlas.patches import create_patch_frames
from tpu_vpcc_torch.bitio import Bitstream
from tpu_vpcc_torch.models import flagship as port_flagship
from tpu_vpcc_torch.ops import color as port_color
from tpu_vpcc_torch.ops import smoothing_np as port_smoothing_np
from tpu_vpcc_torch.runtime import host as port_host
from tpu_vpcc_torch.runtime.pipeline import prepare_gof
from tpu_vpcc_torch.utils import ply as port_ply
from tpu_vpcc_torch.utils.synthetic import make_synthetic_frame
from tpu_vpcc_torch.v3c.context import Context
from tpu_vpcc_torch.v3c.stream import SampleStreamV3CUnit

FAMILIES = sorted(STREAMS)


def canon(x):
    """A structure of plain values that compares equal across the two
    packages' classes: dataclasses by class name and fields, enums by
    class name and value, arrays by dtype, shape and bytes."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: canon(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    return x


@functools.lru_cache(maxsize=None)
def _stream(name):
    return STREAMS[name]()


def _gof_contexts(ssvu_cls, bitstream_cls, context_cls, data):
    ssvu = ssvu_cls.from_bitstream(bitstream_cls(data))
    contexts = []
    while ssvu.get_v3c_unit_count():
        context = context_cls()
        ssvu.decode_gof(context)
        contexts.append(context)
    return contexts


def _port_gofs(name):
    """The family's GOFs as the port's ``prepare_gof`` hands them to the
    oracle (raster planes)."""
    kw = STREAM_PARAMS.get(name, {})
    return [
        prepare_gof(
            context, tiled=False,
            apply_geo_smoothing=kw.get("apply_geo_smoothing_type", False),
            apply_attr_smoothing=kw.get("apply_attr_smoothing_type", False),
        )
        for context in _gof_contexts(SampleStreamV3CUnit, Bitstream, Context,
                                     _stream(name))
    ]


@needs_encoder
@pytest.mark.parametrize("name", FAMILIES)
def test_parse_matches_reference(name):
    """The same bytes parse to the same patch frames, field for field."""
    data = _stream(name)
    ref = [canon(ref_create_patch_frames(c))
           for c in _gof_contexts(RefSSVU, RefBitstream, RefContext, data)]
    got = [canon(create_patch_frames(c))
           for c in _gof_contexts(SampleStreamV3CUnit, Bitstream, Context,
                                  data)]
    assert len(got) >= 1
    assert got == ref


@needs_encoder
@pytest.mark.parametrize("name", FAMILIES)
def test_group_tables_match_reference(name):
    """``build_group_table`` of both packages on every frame of the
    family, with the occupancy-gated ownership fallback available."""
    n = 0
    for gof in _port_gofs(name):
        for m in gof.metas:
            kw = dict(
                occupancy_resolution=gof.occupancy_resolution,
                occ_provider=lambda m=m: gof.occ_planes[m.frame_index],
                occ_precision=gof.occupancy_precision,
            )
            assert canon(port_groups.build_group_table(m, **kw)) == \
                canon(ref_groups.build_group_table(m, **kw))
            n += 1
    assert n >= 1


@needs_encoder
@pytest.mark.parametrize("name", FAMILIES)
def test_oracle_and_ply_match_reference(name):
    """The numpy oracle decode (with its smoothing, tails and secondary
    attributes) gives the same point clouds in both packages, and both
    packages' ``format_ply`` write them to the same bytes."""
    n = 0
    for gof in _port_gofs(name):
        got = list(port_host._reconstruct_gof_oracle(gof))
        ref = list(ref_pipeline._reconstruct_gof_oracle(gof))
        assert canon(got) == canon(ref)
        for ps in got:
            for fmt in ("ascii", "binary_little_endian"):
                assert port_ply.format_ply(ps, fmt) == \
                    ref_ply.format_ply(ps, fmt)
            n += 1
    assert n >= 1


@pytest.mark.parametrize("kw", [
    dict(map_count=1, occupancy_precision=1, n_patches=3),
    dict(map_count=2, occupancy_precision=4, n_patches=6),
    dict(map_count=3, occupancy_precision=2, n_patches=5, allow_swap=False),
    dict(map_count=2, occupancy_resolution=8, occupancy_precision=2,
         n_patches=4, geometry_bitdepth_3d=11),
], ids=["1map-p1", "2map-p4", "3map-p2-noswap", "res8-bd11"])
def test_synthetic_frame_matches_reference(kw):
    got = make_synthetic_frame(np.random.default_rng(17), frame_index=1, **kw)
    ref = ref_make_synthetic_frame(np.random.default_rng(17), frame_index=1,
                                   **kw)
    assert canon(got) == canon(ref)


def test_color_luts_match_reference():
    for got, ref in zip(port_color.color_luts(), ref_color.color_luts()):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
    y = np.arange(1024, dtype=np.int32)[:, None]
    packed = port_color.color_luts()[2][::37, ::41].reshape(1, -1)
    np.testing.assert_array_equal(port_color.g8_from_packed(y, packed),
                                  ref_color.g8_from_packed(y, packed))


def test_smoothing_oracle_matches_reference():
    rng = np.random.default_rng(5)
    n = 4000
    xs, ys, zs = (rng.integers(0, 256, n) for _ in range(3))
    cy, cu, cv = (rng.integers(0, 1024, n) for _ in range(3))
    valid = rng.random(n) < 0.8
    pid = rng.integers(0, 6, n)
    geo = ref_smoothing.SmoothingConfig(grid_size=8, threshold=4)
    attr = ref_smoothing.AttrSmoothingConfig(8, 255, 1)
    for got, ref in (
        (port_smoothing_np.smooth_slots_np(xs, ys, zs, valid, pid, geo),
         ref_smoothing.smooth_slots_np(xs, ys, zs, valid, pid, geo)),
        (port_smoothing_np.smooth_colors_np(xs, ys, zs, cy, cu, cv, valid,
                                            pid, attr),
         ref_smoothing.smooth_colors_np(xs, ys, zs, cy, cu, cv, valid, pid,
                                        attr)),
    ):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def _ref_example_gof(cfg, frames, tiled, **smoothing):
    """tpu_vpcc's ``GofData`` from tpu_vpcc's synthetic frames, laid out
    as ``prepare_gof`` hands a decoded GOF over (the recipe of the port's
    ``example_gof``, on the reference's classes and tiler)."""
    res, mc = cfg.occupancy_resolution, cfg.map_count

    def lay(plane, t):
        return ref_tile_plane(plane, t) if tiled else plane

    geo, attr = [], []
    for sf in frames:
        for m in range(mc):
            geo.append(lay(sf.geo_planes[m], res))
            y, u, v = sf.attr_planes[m]
            attr.append([lay(y, res), lay(u, res // 2), lay(v, res // 2)])
    return ref_pipeline.GofData(
        metas=[sf.meta for sf in frames],
        occ_planes=np.stack([sf.occ_plane for sf in frames]),
        geo_planes=geo, attr_planes=attr, map_count=mc,
        occupancy_precision=cfg.occupancy_precision,
        occupancy_resolution=res, absolute_d1=True, geo_shift=2,
        attribute_count=1, frame_count=len(frames), tiled=tiled,
        tile_size=res if tiled else 0, **smoothing,
    )


@pytest.mark.parametrize("tiled", [True, False])
def test_flagship_gof_matches_reference(tiled):
    """The port's flagship ``GofData`` from seeds 3 and 4 equals the one
    tpu_vpcc's classes build from tpu_vpcc's synthetic frames of the same
    seeds (the data the chip run decodes crosses by seed)."""
    cfg = port_flagship.FlagshipConfig(width=256, height=256, batch=2)
    frames = port_flagship.example_frames(cfg, seed=3, n_patches=8)
    ref_frames = [
        ref_make_synthetic_frame(
            np.random.default_rng(3 + k), width=256, height=256,
            occupancy_resolution=16, occupancy_precision=4, map_count=2,
            n_patches=8, occupancy_fill=0.7, frame_index=k,
        )
        for k in range(2)
    ]
    smoothing = dict(
        geo_smoothing=ref_smoothing.SmoothingConfig(grid_size=8, threshold=16),
        attr_smoothing=ref_smoothing.AttrSmoothingConfig(8, 255, 1),
    )
    got = port_flagship.example_gof(
        cfg, frames, tiled=tiled, geo_smoothing=port_flagship.GEO_SMOOTHING,
        attr_smoothing=port_flagship.ATTR_SMOOTHING,
    )
    ref = _ref_example_gof(cfg, ref_frames, tiled, **smoothing)
    assert canon(got) == canon(ref)
