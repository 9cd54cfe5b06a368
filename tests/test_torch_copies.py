"""The port's own copies of tpu_vpcc's host layers against the originals.

``tpu_vpcc_torch`` keeps its own copies of the jax-free host modules
(``bitio``, ``v3c`` with the whole writer, ``atlas``, ``video`` with the
libx265 encoder, ``reconstruction``, ``utils`` with
``build_fixture_stream`` and the raw and EOM planting helpers, the
smoothing configs and numpy oracle, the colour tables, the host half of
the pipeline). Each copy must compute what its original computes: the
same stream bytes parse to the same patch frames, the same group tables,
the same oracle point clouds and the same PLY bytes, over the fixture
families of ``test_torch_e2e``; the synthetic scenes, with raw and EOM
patches planted, and the flagship GOF made from one seed are equal
array for array; the writer, ``utils/fixtures.py`` and the synthetic
scenes are copied word for word. ``test_torch_encoder`` holds the encode
side's results.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import importlib
from pathlib import Path

import numpy as np
import pytest

from test_torch_e2e import STREAM_PARAMS, STREAMS, needs_encoder
from tpu_vpcc.atlas import groups as ref_groups
from tpu_vpcc.atlas.patches import create_patch_frames as ref_create_patch_frames
from tpu_vpcc.bitio import Bitstream as RefBitstream
from tpu_vpcc.ops import color as ref_color
from tpu_vpcc.ops import smoothing as ref_smoothing
from tpu_vpcc.ops.tiled import tile_plane as ref_tile_plane
from tpu_vpcc.parallel import mesh as ref_mesh
from tpu_vpcc.parallel import spatial as ref_spatial
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
from tpu_vpcc_torch.parallel import mesh as port_mesh
from tpu_vpcc_torch.parallel import spatial as port_spatial
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


def _planted(package: str, case: str):
    """A synthetic frame of ``package`` (two maps, or one for ``eom1``,
    occupancy precision 1) with a raw or an EOM patch planted on the main
    canvas or in the auxiliary video, from one seed."""
    synthetic = importlib.import_module(f"{package}.utils.synthetic")
    rng = np.random.default_rng(29)
    sf = synthetic.make_synthetic_frame(
        rng, width=64, height=64, occupancy_resolution=8,
        occupancy_precision=1, map_count=1 if case == "eom1" else 2,
        n_patches=2, frame_index=0)
    aux = case.endswith("aux")
    if case.startswith("raw"):
        patch = synthetic.plant_raw_patch(rng, sf, (0, 6, 2, 2), n_points=21,
                                          offsets=(3, 1, 2), aux=aux)
    else:
        patch = synthetic.plant_eom_patch(
            rng, sf, (4, 6, 2, 2), list(range(len(sf.meta.patches))),
            aux=aux, aux_size=(64, 48))
    synthetic.ensure_aux_planes(sf, (16, 16))  # a no-op where planted
    return sf, patch


@pytest.mark.parametrize("case", ["raw", "raw_aux", "eom", "eom_aux", "eom1"])
def test_planted_patches_match_reference(case):
    """``plant_raw_patch``, ``plant_eom_patch`` and ``ensure_aux_planes``
    give equal frames and patches in both packages."""
    got = _planted("tpu_vpcc_torch", case)
    assert canon(got) == canon(_planted("tpu_vpcc", case))
    assert got[1].in_aux_video == case.endswith("aux")


@pytest.mark.parametrize("module", ["v3c/writer.py", "utils/fixtures.py",
                                    "utils/synthetic.py"])
def test_encode_side_copies_are_verbatim(module):
    """The writer, ``utils/fixtures.py`` and the synthetic scenes
    are the reference's modules word for word."""
    root = Path(__file__).resolve().parent.parent
    assert (root / "tpu_vpcc_torch" / module).read_text() == \
        (root / "tpu_vpcc" / module).read_text()


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


@pytest.fixture
def ref_inspect():
    """``tpu_vpcc.runtime.inspect``, imported for this test alone: the
    module binds the ``sys.stdout`` of its first import as ``inspect``'s
    default stream, so a module left behind would write another test's
    ``capsys`` output to this test's stream (tests/test_e2e.py's
    ``test_inspect_tool``). Its ``sys.modules`` entry is restored after."""
    import importlib
    import sys

    name = "tpu_vpcc.runtime.inspect"
    before = sys.modules.pop(name, None)
    try:
        yield importlib.import_module(name)
    finally:
        sys.modules.pop(name, None)
        if before is not None:
            sys.modules[name] = before


@needs_encoder
@pytest.mark.parametrize("name", FAMILIES)
def test_inspect_matches_reference(name, tmp_path, ref_inspect):
    """The port's stream inspector prints the reference's text, verbose
    patch lines included, for the same stream file."""
    import io

    from tpu_vpcc_torch.runtime import inspect as port_inspect

    path = tmp_path / f"{name}.bin"
    path.write_bytes(_stream(name))
    got, ref = io.StringIO(), io.StringIO()
    assert port_inspect.inspect(path, verbose=True, out=got) == 0
    assert ref_inspect.inspect(path, verbose=True, out=ref) == 0
    assert got.getvalue() == ref.getvalue()
    assert "GOF 0:" in got.getvalue()


@needs_encoder
@pytest.mark.parametrize("name", FAMILIES)
def test_metrics_match_reference_on_oracle_clouds(name):
    """``d1_metric`` and ``color_psnr`` of both packages on the family's
    oracle point clouds: the first frame against the last (or, for a
    one-frame family, against itself moved by one along x, with every
    third point dropped so that the colour match goes by neighbours)."""
    from tpu_vpcc.utils import metrics as ref_metrics
    from tpu_vpcc_torch.reconstruction.pointset import PointSet3
    from tpu_vpcc_torch.utils import metrics as port_metrics

    frames = [ps for gof in _port_gofs(name)
              for ps in port_host._reconstruct_gof_oracle(gof)]
    a = frames[0]
    b = frames[-1]
    if len(frames) == 1:
        keep = np.arange(len(a)) % 3 != 0
        b = PointSet3(positions=a.positions[keep] + np.uint16(1),
                      with_colors=True)
        b.colors = a.colors[keep]
    for x, y in ((a, b), (b, a), (a, a)):
        assert dataclasses.astuple(port_metrics.d1_metric(x, y)) == \
            dataclasses.astuple(ref_metrics.d1_metric(x, y))
        assert port_metrics.color_psnr(x, y) == ref_metrics.color_psnr(x, y)


def _metric_cloud(pos, colors=None):
    from tpu_vpcc_torch.reconstruction.pointset import PointSet3

    ps = PointSet3(positions=np.asarray(pos, np.uint16),
                   with_colors=colors is not None)
    if colors is not None:
        ps.colors = np.asarray(colors, np.uint8)
    return ps


def _line(n, step):
    return np.stack([np.arange(0, n * step, step), np.zeros(n),
                     np.zeros(n)], 1)


@pytest.mark.parametrize("case", ["identical", "unit_offset", "cli"])
def test_metrics_match_reference_on_metric_cases(case, tmp_path, capsys):
    """The cases of ``tests/test_metrics.py`` through both packages: the
    same metric values, and the same lines from the metrics CLI on PLY
    files the port writes (ASCII and binary)."""
    from tpu_vpcc.utils import metrics as ref_metrics
    from tpu_vpcc_torch.utils import metrics as port_metrics

    rng = np.random.default_rng(0)
    if case == "identical":
        a = _metric_cloud(rng.integers(0, 1024, (500, 3)),
                          rng.integers(0, 256, (500, 3)))
        b = a
    elif case == "unit_offset":
        a = _metric_cloud(_line(100, 10))
        b = _metric_cloud(_line(100, 10) + [1, 0, 0])
    else:
        a = _metric_cloud(_line(200, 10), np.full((200, 3), 100))
        b = _metric_cloud(_line(200, 10) + [1, 0, 0], np.full((200, 3), 100))
        port_ply.write_ply(a, tmp_path / "a.ply")
        port_ply.write_ply(b, tmp_path / "b.ply", fmt="binary_little_endian")
        args = [str(tmp_path / "a.ply"), str(tmp_path / "b.ply")]
        assert port_metrics.main(args) == 0
        got = capsys.readouterr().out
        assert ref_metrics.main(args) == 0
        assert got == capsys.readouterr().out
        assert "mse=1.000000" in got and "r=inf g=inf b=inf" in got
    m = port_metrics.d1_metric(a, b)
    assert dataclasses.astuple(m) == \
        dataclasses.astuple(ref_metrics.d1_metric(a, b))
    if a.with_colors:
        assert port_metrics.color_psnr(a, b) == ref_metrics.color_psnr(a, b)
    if case == "identical":
        assert m.mse == 0 and m.psnr == float("inf")
    else:
        assert m.mse_ab == m.mse_ba == 1.0


@pytest.mark.parametrize("name", ["pad_batch", "stitch_spatial"])
def test_mesh_host_helpers_are_verbatim_copies(name):
    """``parallel.mesh.pad_batch`` and ``parallel.spatial.stitch_spatial``
    are the reference's, word for word, and compute what it computes."""
    import inspect

    port_mod, ref_mod = {"pad_batch": (port_mesh, ref_mesh),
                         "stitch_spatial": (port_spatial, ref_spatial)}[name]
    got, ref = getattr(port_mod, name), getattr(ref_mod, name)
    assert inspect.getsource(got) == inspect.getsource(ref)
    rng = np.random.default_rng(8)
    if name == "pad_batch":
        a = rng.integers(0, 99, (5, 3, 2)).astype(np.int16)
        for m in (1, 2, 5, 8):
            assert canon(got(a, m)) == canon(ref(a, m))
    else:
        pos = rng.integers(0, 1 << 16, (24, 3)).astype(np.uint16)
        col = rng.integers(0, 1 << 16, (24, 3)).astype(np.uint16)
        for counts in ([3, 0, 6], [8, 8, 8], [0, 0, 0]):
            c = np.asarray(counts, np.int32)
            assert canon(got(pos, col, c, 8)) == canon(ref(pos, col, c, 8))


#: the host helpers copied last, by module: ``video.codec``'s thread
#: query, ``video``'s plane stackers, ``ops.color``'s numpy integer form,
#: and the f64 smoothing oracles (kept in the port's ``ops.smoothing_np``)
HOST_COPIES = [
    ("video.codec", "video.codec", "decoder_thread_info"),
    ("video", "video", "occupancy_planes"),
    ("video", "video", "geometry_planes"),
    ("video", "video", "attribute_planes"),
    ("ops.color", "ops.color", "convert_yuv10_to_rgb8_lut"),
    ("ops.smoothing_np", "ops.smoothing", "smooth_slots_f64"),
    ("ops.smoothing_np", "ops.smoothing", "smooth_colors_f64"),
]


@pytest.mark.parametrize("port_mod,ref_mod,name", HOST_COPIES,
                         ids=[c[2] for c in HOST_COPIES])
def test_host_copies_are_verbatim(port_mod, ref_mod, name):
    """Each function is the reference's, word for word (its citations of
    the upstream decoder's sources name them from the source tree's root,
    as the port's other copies do); for ``decoder_thread_info``, so are
    the ctypes signatures of the two native calls it makes, in the
    bridge's loader."""
    import inspect

    got = getattr(importlib.import_module(f"tpu_vpcc_torch.{port_mod}"), name)
    ref = getattr(importlib.import_module(f"tpu_vpcc.{ref_mod}"), name)
    assert inspect.getsource(got) == \
        inspect.getsource(ref).replace("``/root/reference/src/", "``src/")
    if name == "decoder_thread_info":
        from tpu_vpcc.video import codec as ref_codec
        from tpu_vpcc_torch.video import codec

        port_load = inspect.getsource(codec._load)
        ref_load = inspect.getsource(ref_codec._load)
        for fn in ("vdec_open_threads", "vdec_thread_info"):
            ref_lines = [ln for ln in ref_load.split("        lib.")
                         if ln.startswith(f"{fn}.")]
            assert len(ref_lines) == 2, fn
            for ln in ref_lines:
                assert f"        lib.{ln}" in port_load, (fn, ln)
