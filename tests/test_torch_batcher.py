"""The multi-stream batcher of the PyTorch port
(``tpu_vpcc_torch.parallel.batcher``) on the CPU.

Every stream's frames must be byte-equal (PLY bytes) to tpu_vpcc's
``decode_streams`` (JAX on the CPU) and to the port's single-stream
``Decoder``; frames of several streams must share device dispatches, and
streams whose staged inputs differ in colour mode or group bucket must
not. The cases of ``tests/test_batcher.py`` that use no mesh, eight
concurrent streams (BASELINE config 5 without a mesh), the narrow, wide
and gather paths in one run, prepared GOFs through the batcher's wave
loop, and the several-``-i`` CLI against tpu_vpcc's.
"""

from dataclasses import replace

import numpy as np
import pytest

from test_torch_e2e import SMOOTHING, STREAMS, _gather_gof, needs_encoder
from tpu_vpcc.parallel.batcher import decode_streams as ref_decode_streams
from tpu_vpcc.runtime import cli as ref_cli
from tpu_vpcc.runtime.pipeline import Params as RefParams
from tpu_vpcc.utils.fixtures import build_fixture_stream
from tpu_vpcc.utils.ply import format_ply as ref_format_ply
from tpu_vpcc.utils.synthetic import make_synthetic_frame
from tpu_vpcc_torch.parallel import batcher
from tpu_vpcc_torch.runtime import cli as port_cli
from tpu_vpcc_torch.runtime import pipeline as P
from tpu_vpcc_torch.runtime.pipeline import Decoder, Params
from tpu_vpcc_torch.utils.ply import format_ply


def make_streams(tmp_path, n_streams=3, n_frames=2):
    """``tests/test_batcher.py``'s streams: 64^2, three patches a frame."""
    paths = []
    for s in range(n_streams):
        rng = np.random.default_rng(100 + s)
        frames = [
            make_synthetic_frame(rng, width=64, height=64,
                                 occupancy_resolution=8, occupancy_precision=4,
                                 n_patches=3, frame_index=i)
            for i in range(n_frames)
        ]
        p = tmp_path / f"s{s}.bin"
        p.write_bytes(build_fixture_stream(frames))
        paths.append(p)
    return paths


def _decoder_frames(path, **kw):
    dec = Decoder(Params(path, device="cpu", **kw))
    dec.start()
    return [format_ply(f) for f in dec]


def check_streams(paths, n_frames=None, **kw):
    """The port's batcher on the CPU == tpu_vpcc's batcher == the port's
    ``Decoder`` per stream, PLY bytes frame by frame."""
    got = [[format_ply(f) for f in s] for s in batcher.decode_streams(
        paths, params=Params(device="cpu", **kw))]
    ref = [[ref_format_ply(f) for f in s]
           for s in ref_decode_streams(paths, params=RefParams(**kw))]
    assert got == ref
    for s, path in enumerate(paths):
        seq = _decoder_frames(path, **kw)
        assert len(got[s]) == len(seq) > 0
        if n_frames is not None:
            assert len(seq) == n_frames
        assert got[s] == seq
    return got


def spy_on(monkeypatch, *modules):
    """Record every call of ``_dispatch_device`` made through the name
    in ``modules`` as (n_frames, layout, colour mode, group extent):
    through ``batcher`` the merged inputs, one call each; through
    ``pipeline`` the chunks ``_dispatch_device`` splits a longer input
    into, and the trailing-layer and secondary passes."""
    calls = []
    real = P._dispatch_device

    def spy(di, device, stats=None, mesh=None):
        calls.append((di.n_frames, di.layout, di.color_mode, di.group_cap))
        return real(di, device, stats=stats, mesh=mesh)

    for module in modules:
        monkeypatch.setattr(module, "_dispatch_device", spy)
    return calls


@needs_encoder
def test_multi_stream_matches_sequential(tmp_path):
    check_streams(make_streams(tmp_path))


@needs_encoder
def test_streams_share_device_batches(tmp_path, monkeypatch):
    """Frames from different streams really coalesce into one dispatch."""
    paths = make_streams(tmp_path, n_streams=2, n_frames=1)
    calls = spy_on(monkeypatch, batcher)
    batched = batcher.decode_streams(paths, params=Params(device="cpu"))
    # initial wave: both streams' single-frame GOFs in ONE device call
    assert calls[0][0] == 2, calls
    assert all(len(b) == 1 for b in batched)


@needs_encoder
def test_multi_stream_applies_smoothing_params(tmp_path):
    """A smoothing-SEI stream decoded twice in one batch with the toggle
    set gives the single-stream smoothed output (not the unsmoothed)."""
    rng = np.random.default_rng(6)
    frames = [
        make_synthetic_frame(rng, width=64, height=64, occupancy_resolution=8,
                             occupancy_precision=4, n_patches=4, frame_index=i)
        for i in range(2)
    ]
    p = tmp_path / "sm.bin"
    p.write_bytes(build_fixture_stream(frames, geo_smoothing_sei=(8, 1)))
    smoothed = check_streams([p, p], n_frames=2,
                             apply_geo_smoothing_type=True)
    plain = _decoder_frames(p)
    assert smoothed[0] != plain, "fixture must actually smooth something"


@needs_encoder
def test_batched_streams_append_eom_and_plr_tails(tmp_path):
    """The batcher appends the single-stream decode's host tails (PLR,
    then EOM, then raw): one EOM stream and one PLR stream."""
    from tests.test_eom import make_eom_frame
    from tests.test_plr import MODES, THICKNESS, make_plr_frames

    rng = np.random.default_rng(9)
    p_eom = tmp_path / "eom.bin"
    p_eom.write_bytes(build_fixture_stream(
        [make_eom_frame(rng, frame_index=i) for i in range(2)]
    ))
    p_plr = tmp_path / "plr.bin"
    p_plr.write_bytes(build_fixture_stream(
        make_plr_frames(seed=10), plr=(MODES, THICKNESS)
    ))
    check_streams([p_eom, p_plr], n_frames=2)


@needs_encoder
def test_batched_mixed_map_counts_match_sequential(tmp_path):
    """A 3-map stream batched beside a 2-map stream keeps its trailing
    layer points (the drop_map0 passes of the single-stream decode)."""
    paths = []
    for name, seed, maps in (("a", 60, 3), ("b", 61, 2)):
        rng = np.random.default_rng(seed)
        p = tmp_path / f"{name}.bin"
        p.write_bytes(build_fixture_stream([
            make_synthetic_frame(
                rng, width=64, height=64, occupancy_resolution=8,
                occupancy_precision=4, map_count=maps, n_patches=2,
                frame_index=i,
            )
            for i in range(2)
        ]))
        paths.append(p)
    check_streams(paths, n_frames=2)


@needs_encoder
def test_batched_three_maps_with_secondary_attributes(tmp_path):
    """A 3-map stream with two secondary attributes (reflectance and a
    second texture, as ``test_torch_e2e._stream_raw_eom_secondary`` codes
    them) batched beside a 2-map stream: the trailing layer's points and
    both map pairs' secondary values equal the single-stream decode."""
    paths = []
    for name, seed, maps, sec in (
            ("a", 62, 3, [(3, 1, None), (0, 3, None)]), ("b", 63, 2, None)):
        rng = np.random.default_rng(seed)
        p = tmp_path / f"{name}.bin"
        p.write_bytes(build_fixture_stream([
            make_synthetic_frame(
                rng, width=64, height=64, occupancy_resolution=8,
                occupancy_precision=4, map_count=maps, n_patches=2,
                frame_index=i,
            )
            for i in range(2)
        ], secondary_attrs=sec))
        paths.append(p)
    got = check_streams(paths, n_frames=2)
    # the 3-map frames carry the reflectance and the second texture
    for k, extra in ((0, True), (1, False)):
        for f in got[k]:
            header = f[: f.index(b"end_header")]
            assert (b"reflectance" in header) == extra, header
            assert (b"red2" in header) == extra, header


@needs_encoder
def test_eight_concurrent_streams(tmp_path, monkeypatch):
    """BASELINE config 5's shape without a mesh: 8 concurrent streams,
    the first wave's 16 frames merged into one input and dispatched in
    DEVICE_BATCH chunks; every stream byte-equal."""
    from tpu_vpcc_torch.runtime.pipeline import DEVICE_BATCH

    paths = make_streams(tmp_path, n_streams=8, n_frames=2)
    calls = spy_on(monkeypatch, batcher, P)
    check_streams(paths, n_frames=2)
    # the merged input, then the chunks _dispatch_device splits it into
    merged, chunks = calls[0], calls[1:1 + 16 // DEVICE_BATCH]
    assert merged[0] == 16, calls
    assert [c[0] for c in chunks] == [DEVICE_BATCH] * (16 // DEVICE_BATCH)


@needs_encoder
def test_narrow_wide_and_gather_streams_batched_together(tmp_path,
                                                         monkeypatch):
    """A rotated stream (the gather fallback), a smoothed stream (the wide
    path) and a narrow stream in one batched decode with the smoothing
    toggles on: each path dispatched, every stream byte-equal."""
    paths = []
    for name in ("rotated", "smoothing", "verify"):
        p = tmp_path / f"{name}.bin"
        p.write_bytes(STREAMS[name]())
        paths.append(p)
    calls = spy_on(monkeypatch, batcher)
    check_streams(paths, n_frames=2, **SMOOTHING)
    assert {c[1] for c in calls} == {"gather", "wide", "narrow"}, calls


def _fcfg(width=128, res=16):
    from tpu_vpcc_torch.models.flagship import FlagshipConfig

    return FlagshipConfig(width, width, res, batch=2)


def _prepared_gof(kind, seed, tiled=True):
    """A prepared 128^2 GOF of two frames on the narrow, wide (smoothing)
    or gather (rotated) path."""
    from tpu_vpcc_torch.models.flagship import (
        ATTR_SMOOTHING,
        GEO_SMOOTHING,
        example_frames,
        example_gof,
    )

    if kind == "gather":
        return _gather_gof("rotated", _fcfg(), seed, tiled=tiled)
    frames = example_frames(_fcfg(), seed=seed, n_patches=8)
    kw = (dict(geo_smoothing=GEO_SMOOTHING, attr_smoothing=ATTR_SMOOTHING)
          if kind == "wide" else {})
    return example_gof(_fcfg(), frames, tiled=tiled, **kw)


def _waves(streams, device="cpu", **kw):
    """The batcher's wave loop over prepared GOFs: ``streams`` is a list
    of GOF lists; returns each stream's PLY bytes in order."""
    out = [[] for _ in streams]
    for s, f, ps in batcher._decode_waves(
            [iter(g) for g in streams], lambda it: next(it, None),
            Params(device=device), **kw):
        assert f == len(out[s])
        out[s].append(format_ply(ps))
    return out


def _start_gofs(gofs, **kw):
    dec = Decoder(Params(**kw))
    dec.start_gofs(gofs)
    return [format_ply(f) for f in dec]


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_prepared_mixed_paths(device, monkeypatch):
    """Prepared GOFs of the three paths, two streams each, through the
    wave loop: each stream equals ``Decoder.start_gofs`` on the CPU and
    the oracle; on the card the K1, K2W and K1F launch counters advance
    by exactly the narrow, wide and gather chunks, and K5's by the
    narrow and wide (device-packed) chunks."""
    import torch

    from tpu_vpcc_torch.ops import pack, payload
    from tpu_vpcc_torch.ops import shift_compact as sc

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")
    kinds = ("narrow", "wide", "gather")
    streams = [[_prepared_gof(k, s), _prepared_gof(k, s + 2)]
               for k in kinds for s in (0, 10)]
    calls = spy_on(monkeypatch, batcher, P)
    before = (sc.launches, payload.launches, sc.full_launches,
              pack.launches)
    got = _waves(streams, device=device)
    # the chunks: a merged input longer than DEVICE_BATCH only splits
    n = {k: sum(c[1] == k and c[0] <= P.DEVICE_BATCH for c in calls)
         for k in kinds}
    assert n["narrow"] > 0 and n["wide"] > 0 and n["gather"] > 0, calls
    launched = (sc.launches - before[0], payload.launches - before[1],
                sc.full_launches - before[2], pack.launches - before[3])
    if device == "cuda":
        assert launched == (n["narrow"], n["wide"], n["wide"] + n["gather"],
                            n["narrow"] + n["wide"])
    else:
        assert launched == (0, 0, 0, 0)
    for k, stream in enumerate(streams):
        assert len(got[k]) == 4
        assert got[k] == _start_gofs(stream, device="cpu")
        kind, seed = kinds[k // 2], (0, 10)[k % 2]
        oracle = [_prepared_gof(kind, seed, tiled=False),
                  _prepared_gof(kind, seed + 2, tiled=False)]
        assert got[k] == _start_gofs(oracle, use_device=False)


# each layout's dispatch function, unsharded and on a mesh (where the
# gather falls back to the unsharded dispatch)
ROUTES = {
    "narrow": ("reconstruct_batch_pretiled_packed",
               "reconstruct_gof_spatial_pretiled_packed"),
    "wide": ("reconstruct_batch_pretiled", "reconstruct_gof_spatial_pretiled"),
    "gather": ("reconstruct_batch", "reconstruct_batch"),
}


@pytest.mark.parametrize("kind", list(ROUTES))
def test_layout_names_the_dispatch(kind, monkeypatch):
    """``DeviceInputs.layout`` of a narrow, a smoothed and a rotated GOF
    is "narrow", "wide" and "gather", and ``_dispatch_device`` calls that
    route's function, unsharded and on a CPU mesh of two 'space' shards,
    giving the stats to the wide path only; the frames are the same
    either way."""
    import torch

    from tpu_vpcc_torch.ops import reconstruct, tiled
    from tpu_vpcc_torch.parallel import mesh as port_mesh
    from tpu_vpcc_torch.parallel import spatial
    from tpu_vpcc_torch.utils.stats import GofStats

    gof = _prepared_gof(kind, 0)
    cfg, tables, g_bucket = P._gof_tables_and_bucket(gof, 2)
    di = P._gof_device_inputs(gof, gof.metas, (cfg, tables), g_bucket)
    assert di.layout == kind
    cpu = torch.device("cpu")
    want = P._dispatch_device(di, cpu)

    called = []
    for module in (reconstruct, tiled, spatial):
        for name in {n for pair in ROUTES.values() for n in pair}:
            if hasattr(module, name):
                def spy(*a, _real=getattr(module, name), _name=name, **kw):
                    called.append((_name, "stats" in kw))
                    return _real(*a, **kw)

                monkeypatch.setattr(module, name, spy)
    mesh = port_mesh.make_mesh([cpu] * 2, data=1, space=2)
    for sharded, m in ((0, None), (1, mesh)):
        called.clear()
        got = P._dispatch_device(di, cpu, stats=GofStats(), mesh=m)
        # the first call is the route's; the twins call the kernels below
        assert called[0] == (ROUTES[kind][sharded], kind == "wide"), called
        assert len(got) == len(want) == 2
        for (pos, col), (pos_w, col_w) in zip(got, want):
            assert np.array_equal(pos, pos_w) and np.array_equal(col, col_w)


def _content_gof(seed, n_patches, rgb, tiled=True):
    """A 256^2 GOF (resolution 8: 1,024 blocks, so group buckets above
    the floor of 256 exist) with 4:4:4 attributes, as YUV or RGB content:
    equal frames give equal staged configs, whatever the content."""
    from tpu_vpcc_torch.models.flagship import example_frames, example_gof
    from tpu_vpcc_torch.ops.tiled import tile_plane

    fcfg = _fcfg(256, res=8)
    frames = example_frames(fcfg, seed=seed, n_patches=n_patches)
    gof = example_gof(fcfg, frames, tiled=tiled)
    rng = np.random.default_rng(seed)
    res = fcfg.occupancy_resolution
    attr = []
    for sf in frames:
        for y, _u, _v in sf.attr_planes:
            planes = [y] + [rng.integers(0, 1024, y.shape).astype(np.uint16)
                            for _ in range(2)]
            attr.append([tile_plane(p, res) if tiled else p for p in planes])
    return replace(gof, attr_planes=attr, attr_chroma_shift=0,
                   attr_is_rgb444=rgb)


def test_colour_mode_and_group_bucket_split_dispatches(monkeypatch):
    """Four prepared streams of one 256^2 configuration: A and D (YUV
    4:4:4, six patches a frame) share one merged input; B (A's frames as
    RGB 4:4:4: equal config, other colour mode) and C (YUV, sixty patches:
    equal config, another group bucket) get dispatches of their own. Each stream equals
    ``Decoder.start_gofs`` and the oracle."""
    specs = {"A": (0, 6, False), "B": (0, 6, True), "C": (4, 60, False),
             "D": (4, 6, False)}
    gofs = {k: _content_gof(*v) for k, v in specs.items()}
    staged = {}
    for k, g in gofs.items():
        cfg, tables, g_bucket = P._gof_tables_and_bucket(g)
        staged[k] = P._gof_device_inputs(g, g.metas, (cfg, tables), g_bucket)
    assert staged["A"].cfg == staged["B"].cfg == staged["C"].cfg
    assert staged["A"].batch_key == staged["D"].batch_key
    assert staged["A"].group_cap != staged["C"].group_cap

    merged = spy_on(monkeypatch, batcher)
    got = _waves([[g] for g in gofs.values()])
    cap_a, cap_c = staged["A"].group_cap, staged["C"].group_cap
    assert sorted(merged) == sorted([
        (4, "narrow", "yuv10", cap_a), (2, "narrow", "rgb16", cap_a),
        (2, "narrow", "yuv10", cap_c)]), merged
    for k, (s, n, rgb) in zip(gofs, specs.values()):
        assert got[list(gofs).index(k)] == _start_gofs([gofs[k]],
                                                       device="cpu")
        oracle = _content_gof(s, n, rgb, tiled=False)
        assert got[list(gofs).index(k)] == _start_gofs([oracle],
                                                       use_device=False)
    assert got[0] != got[1]  # the content changes the colours


def test_host_and_device_packed_inputs_never_merge(monkeypatch):
    """Four streams of prepared narrow GOFs with one configuration, the
    GOFs of two of them staged by the host pack
    (``test_torch_dispatch.host_pack_staging``): equal staged configs,
    batch keys that differ only in the staging, and the first wave
    dispatches the host cats and the device pack's planes apart. Every
    stream equals ``Decoder.start_gofs``."""
    from test_torch_dispatch import host_pack_staging

    streams = [[_prepared_gof("narrow", s)] for s in (0, 2, 4, 6)]
    host_packed = {id(streams[1][0]), id(streams[3][0])}
    merged = []
    real = batcher._dispatch_device

    def spy(di, device, stats=None, mesh=None):
        merged.append((di.n_frames, di.staging, len(di.arrays)))
        return real(di, device, stats=stats, mesh=mesh)

    monkeypatch.setattr(batcher, "_dispatch_device", spy)
    with host_pack_staging(only=lambda g: id(g) in host_packed) as restaged:
        staged = []
        for s in (0, 1):
            g = streams[s][0]
            cfg, tables, g_bucket = P._gof_tables_and_bucket(g)
            staged.append(batcher._gof_device_inputs(
                g, g.metas, (cfg, tables), g_bucket))
        got = _waves(streams)
    assert len(restaged) == 3  # stream 1 above, streams 1 and 3 in the wave
    assert staged[0].cfg == staged[1].cfg
    assert [d.staging for d in staged] == ["device_pack", "host_pack"]
    key = [list(d.batch_key) for d in staged]
    assert key[0][1] != key[1][1]
    del key[0][1], key[1][1]
    assert key[0] == key[1]
    assert sorted(merged) == [(4, "device_pack", 8), (4, "host_pack", 2)], (
        merged)
    for k, stream in enumerate(streams):
        assert got[k] == _start_gofs(stream, device="cpu")


@needs_encoder
def test_wave_loop_on_prepared_gofs_equals_stream_path(tmp_path):
    """The batcher's wave loop fed GOFs that the port's ``prepare_gof``
    made from the streams equals ``decode_streams`` on the paths."""
    from tpu_vpcc_torch.bitio import Bitstream
    from tpu_vpcc_torch.runtime.pipeline import prepare_gof
    from tpu_vpcc_torch.v3c.context import Context
    from tpu_vpcc_torch.v3c.stream import SampleStreamV3CUnit

    paths = make_streams(tmp_path, n_streams=3, n_frames=2)
    streams = []
    for p in paths:
        ssvu = SampleStreamV3CUnit.from_bitstream(Bitstream(p.read_bytes()))
        gofs = []
        while ssvu.get_v3c_unit_count():
            context = Context()
            ssvu.decode_gof(context)
            gofs.append(prepare_gof(context))
        streams.append(gofs)
    want = [[format_ply(f) for f in s] for s in batcher.decode_streams(
        paths, params=Params(device="cpu"))]
    assert _waves(streams) == want
    assert _waves(streams, coalesce_initial=False, max_host_workers=1) == want


@needs_encoder
def test_cli_several_inputs_match_reference_cli(tmp_path):
    """Three ``-i`` inputs, two of them with one stem: the port's CLI
    writes the directories and PLY bytes of tpu_vpcc's CLI; a
    %4d-patterned output path is refused with exit 2."""
    src = make_streams(tmp_path, n_streams=3, n_frames=2)
    inputs = []
    for d, p in zip(("a", "b", "."), src):
        (tmp_path / d).mkdir(exist_ok=True)
        target = tmp_path / d / ("s.bin" if d != "." else "c.bin")
        target.write_bytes(p.read_bytes())
        inputs.append(target)
    args = [a for p in inputs for a in ("-i", str(p))]
    assert port_cli.main(args + ["-o", str(tmp_path / "port"),
                                 "--device", "cpu"]) == 0
    assert ref_cli.main(args + ["-o", str(tmp_path / "ref")]) == 0
    tree = sorted(str(p.relative_to(tmp_path / "ref"))
                  for p in (tmp_path / "ref").rglob("*"))
    assert tree == ["c", "c/0000.ply", "c/0001.ply", "s.0", "s.0/0000.ply",
                    "s.0/0001.ply", "s.1", "s.1/0000.ply", "s.1/0001.ply"]
    assert tree == sorted(str(p.relative_to(tmp_path / "port"))
                          for p in (tmp_path / "port").rglob("*"))
    for name in tree:
        if name.endswith(".ply"):
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "ref" / name).read_bytes()
    assert port_cli.main(args + ["-o", str(tmp_path / "x" / "f%4d.ply"),
                                 "--device", "cpu"]) == 2
