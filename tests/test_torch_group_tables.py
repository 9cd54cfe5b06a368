"""The port's vectorised group tables against its per-patch ones.

``tpu_vpcc_torch.atlas.groups.build_group_tables`` builds every frame's
``GroupTable`` in one array pass; ``build_group_table`` (the copy that
``test_torch_copies`` holds to ``tpu_vpcc``) is its oracle. Each case
holds ``fields``, ``n_groups``, ``block_to_patch``, ``tiled_ok`` and
``trim`` byte for byte, the exceptions by type and message, and the
frames that took the occupancy-gated ownership pass by count: over the
fixture families, the benchmark generator's frames, random overlapping
frames (patch precedence, quantized extents, every orientation), an
empty frame, and through ``runtime.pipeline._plan_gof`` with its
``tables_gated_frames`` counter.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from test_torch_copies import FAMILIES, _port_gofs, canon
from test_torch_e2e import needs_encoder
from tpu_vpcc_torch.atlas import groups as G
from tpu_vpcc_torch.atlas.patches import (
    FrameMeta,
    Patch,
    _check_orientation_in_range,
)
from tpu_vpcc_torch.runtime import pipeline as P
from tpu_vpcc_torch.runtime.host import GofData
from tpu_vpcc_torch.utils.stats import GofStats
from tpu_vpcc_torch.v3c.syntax import PatchOrientation, UnsupportedFeature

BENCH_CONFIGS = Path(__file__).resolve().parents[1] / "vpcc_bench" / "configs"
ALIGNED = (PatchOrientation.DEFAULT, PatchOrientation.SWAP,
           PatchOrientation.MROT270)


@pytest.fixture
def gated_calls(monkeypatch):
    """Counts the calls of the occupancy-gated ownership pass, which
    both table functions make through the module's global."""
    calls = []
    real = G._occupancy_gated_owner

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(G, "_occupancy_gated_owner", counted)
    return calls


def _oracle(metas, occ_provider_for=None, **kw):
    return [
        G.build_group_table(
            m, occ_provider=occ_provider_for(m) if occ_provider_for else None,
            **kw)
        for m in metas
    ]


def _assert_same(metas, gated_calls, occ_provider_for=None, **kw):
    """Both table functions on ``metas``: equal tables, and ``gated`` equal to
    the oracle's count of occupancy-gated frames, which it returns."""
    want = _oracle(metas, occ_provider_for, **kw)
    n_oracle = len(gated_calls)
    got, gated = G.build_group_tables(metas,
                                      occ_provider_for=occ_provider_for, **kw)
    assert len(gated_calls) == 2 * n_oracle
    assert gated == n_oracle
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert canon(a) == canon(b), k
    return gated


@needs_encoder
@pytest.mark.parametrize("name", FAMILIES)
def test_fixture_family_tables_match(name, gated_calls):
    """Every frame of every fixture family, as ``_gof_frame_tables``
    calls ``build_group_tables``."""
    n = 0
    for gof in _port_gofs(name):
        _assert_same(
            gof.metas, gated_calls,
            occ_provider_for=lambda m, gof=gof: (
                lambda: gof.occ_planes[m.frame_index]),
            occupancy_resolution=gof.occupancy_resolution,
            occ_precision=gof.occupancy_precision,
        )
        n += len(gof.metas)
    assert n >= 1


@pytest.mark.parametrize("seed", [3123003003, 3100002039, 2**31 + 17])
@pytest.mark.parametrize("config", ["vpcc8i_1280", "vpcc8i_1280_smooth"])
def test_benchmark_frames_match(config, seed, gated_calls):
    """A few frames of the benchmark generator's pool through the
    pipeline's own plan: the tables the cells dispatch, none gated."""
    from vpcc_bench import adapter
    from vpcc_bench.gen import make_pool

    cfg = json.loads((BENCH_CONFIGS / f"{config}.json").read_text())
    gof = adapter.gof_data(adapter.stage(make_pool(seed, cfg, 3), cfg), cfg)
    stats = GofStats()
    plan = P._plan_gof(gof, stats)
    _, tables = plan.prebuilt
    want = _oracle(gof.metas, occupancy_resolution=cfg["occupancy_resolution"])
    assert [canon(t) for t in tables] == [canon(t) for t in want]
    assert sum(t.n_groups for t in tables) > 3 * 1000
    assert stats.counters["tables_gated_frames"] == 0
    assert gated_calls == []


def _random_meta(rng, res, size, orientations, n_patches, precedence=False,
                 quantized=False):
    """A frame of ``n_patches`` overlapping patches on a ``size``² canvas,
    each admitted by the orientation range gate."""
    bw = size // res
    patches = []
    while len(patches) < n_patches:
        su, sv = (int(x) for x in rng.integers(1, min(bw, 6) + 1, 2))
        p = Patch(
            uv0=(int(rng.integers(0, bw)), int(rng.integers(0, bw))),
            size_uv0=(su, sv),
            uv1=(int(rng.integers(0, 300)), int(rng.integers(0, 300))),
            occupancy_resolution=res,
            level_of_detail=(int(rng.integers(1, 3)),
                             int(rng.integers(1, 3))),
            patch_orientation=orientations[
                int(rng.integers(0, len(orientations)))],
        )
        p.set_view_id(int(rng.integers(0, 18)))
        p.d1 = int(rng.integers(0, 900))
        if quantized and rng.random() < 0.6:
            p.size_2d_in_pixel = (
                int(rng.integers((su - 1) * res + 1, su * res + 1)),
                int(rng.integers((sv - 1) * res + 1, sv * res + 1)),
            )
        try:
            _check_orientation_in_range(p, size, size)
        except UnsupportedFeature:
            continue
        c = p.orientation_coeffs(1)
        xs = [c[0] * u + c[1] * v + c[2] for u in (0, su - 1)
              for v in (0, sv - 1)]
        ys = [c[3] * u + c[4] * v + c[5] for u in (0, su - 1)
              for v in (0, sv - 1)]
        if min(xs) < 0 or max(xs) >= bw or min(ys) < 0 or max(ys) >= bw:
            continue
        patches.append(p)
    return FrameMeta(width=size, height=size, patches=patches,
                     patch_precedence=precedence)


def _contested(meta, res) -> bool:
    """Whether two patches of ``meta`` cover one canvas block."""
    cover = np.zeros((meta.height // res, meta.width // res), np.int64)
    for p in meta.patches:
        a, b, cx, c, d, cy = p.orientation_coeffs(1)
        u, v = np.meshgrid(np.arange(p.size_uv0[0]), np.arange(p.size_uv0[1]))
        np.add.at(cover, (c * u + d * v + cy, a * u + b * v + cx), 1)
    return bool((cover >= 2).any())


RANDOM_CASES = [
    # (name, res, canvas, orientations, quantized)
    ("aligned", 16, 128, ALIGNED, False),
    ("aligned_quantized", 16, 128, ALIGNED, True),
    ("every_orientation_res1", 1, 12, tuple(PatchOrientation), False),
    ("every_orientation_quantized", 8, 64, tuple(PatchOrientation), True),
]


@pytest.mark.parametrize("precedence", [False, True],
                         ids=["later_wins", "precedence"])
@pytest.mark.parametrize("case", RANDOM_CASES, ids=[c[0] for c in RANDOM_CASES])
def test_random_overlapping_frames_match(case, precedence, gated_calls):
    """Random frames of heavily overlapping patches, with
    ``meta.patch_precedence`` off and on; quantized extents give
    ``trim``. Rotated patches at res > 1 overlapping others take the
    occupancy-gated owner."""
    name, res, size, orientations, quantized = case
    rng = np.random.default_rng([res, size, int(precedence), int(quantized)])
    metas = [
        _random_meta(rng, res, size, orientations, int(rng.integers(4, 12)),
                     precedence=precedence, quantized=quantized)
        for _ in range(16)
    ]
    for k, m in enumerate(metas):
        m.frame_index = k
    occ = (rng.random((len(metas), size // 2, size // 2)) < 0.5).astype(
        np.uint8)
    gated = _assert_same(
        metas, gated_calls,
        occ_provider_for=lambda m: (lambda: occ[m.frame_index]),
        occupancy_resolution=res, occ_precision=2,
    )
    tables = _oracle(metas, lambda m: (lambda: occ[m.frame_index]),
                     occupancy_resolution=res, occ_precision=2)
    assert sum(_contested(m, res) for m in metas) >= 8
    if quantized:
        assert any(t.trim is not None for t in tables)
    if res > 1 and orientations != ALIGNED:
        assert gated >= 1
        assert not all(t.tiled_ok for t in tables)
    else:
        assert gated == 0


@pytest.mark.parametrize("res", [0, 8, 32])
def test_empty_frame_matches(res, gated_calls):
    """A frame with no patches: the table's size comes from the explicit
    ``occupancy_resolution`` (16 when it is 0)."""
    meta = FrameMeta(width=256, height=128)
    _assert_same([meta], gated_calls, occupancy_resolution=res)
    (t,), _ = G.build_group_tables([meta], occupancy_resolution=res)
    bs = res or 16
    assert t.fields.shape == ((256 // bs) * (128 // bs), G.N_GROUP_FIELDS)
    assert t.block_to_patch.shape == (128 // bs, 256 // bs)


@pytest.mark.parametrize("precedence", [False, True],
                         ids=["later_wins", "precedence"])
def test_a_patch_that_owns_no_block_sets_no_flag(precedence, gated_calls):
    """A quantized ROT90 patch under a DEFAULT one that covers all its
    blocks: ``tiled_ok`` and ``trim`` come only from patches that own
    blocks, so they follow whichever patch the precedence lets win."""
    hidden = Patch(size_uv0=(2, 2), occupancy_resolution=1,
                   patch_orientation=PatchOrientation.ROT90,
                   size_2d_in_pixel=(2, 2))
    over = Patch(size_uv0=(3, 3), occupancy_resolution=1)
    meta = FrameMeta(width=8, height=8, patches=[hidden, over],
                     patch_precedence=precedence)
    _assert_same([meta], gated_calls)
    (t,), _ = G.build_group_tables([meta])
    assert t.tiled_ok is not precedence
    assert (t.trim is not None) is precedence


def _rotated_overlap_metas():
    """Two frames of a 64² canvas at res 16 where a ROT90 patch covers
    blocks of a DEFAULT one (the ownership hazard), then a frame of the
    DEFAULT patch alone."""
    def patch(uv0, size, o):
        p = Patch(uv0=uv0, size_uv0=size, uv1=(10, 20),
                  occupancy_resolution=16, patch_orientation=o)
        p.set_view_id(1)
        p.d1 = 100
        return p

    metas = []
    for k, uv0 in enumerate([(1, 1), (2, 2), (0, 0)]):
        patches = [patch(uv0, (2, 2), PatchOrientation.DEFAULT),
                   patch((2, 1), (2, 2), PatchOrientation.ROT90)]
        for p in patches:
            _check_orientation_in_range(p, 64, 64)
        metas.append(FrameMeta(frame_index=k, width=64, height=64,
                               patches=patches[:1 + (k < 2)]))
    return metas


def test_rotated_overlap_counts_gated_frames(gated_calls):
    """Through ``_plan_gof``: the two hazard frames take the
    occupancy-gated owner, and ``recon_tables`` counts them as
    ``tables_gated_frames``."""
    metas = _rotated_overlap_metas()
    occ = np.random.default_rng(5).integers(0, 2, (3, 16, 16)).astype(
        np.uint8)
    gof = GofData(
        metas=metas, occ_planes=occ, geo_planes=[], attr_planes=[],
        map_count=2, occupancy_precision=4, occupancy_resolution=16,
        absolute_d1=True, geo_shift=0, attribute_count=1, frame_count=3,
    )
    stats = GofStats()
    plan = P._plan_gof(gof, stats)
    assert len(gated_calls) == 2
    assert stats.counters["tables_gated_frames"] == 2
    assert "recon_tables" in stats.stage_seconds
    want = _oracle(metas, lambda m: (lambda: occ[m.frame_index]),
                   occupancy_resolution=16, occ_precision=4)
    assert [canon(t) for t in plan.prebuilt[1]] == [canon(t) for t in want]


def _error_case(name):
    """(metas, keywords) on which both table functions raise."""
    p = Patch(uv0=(3, 0), size_uv0=(2, 2), occupancy_resolution=16)
    if name == "footprint_outside_canvas":
        return [FrameMeta(width=64, height=64,
                          patches=[Patch(occupancy_resolution=16), p])], {}
    if name == "mixed_occupancy_resolution":
        return [FrameMeta(width=64, height=64, patches=[
            Patch(occupancy_resolution=16), Patch(occupancy_resolution=8)])], {}
    if name == "capacity_exceeded":
        return [FrameMeta(width=64, height=64, patches=[
            Patch(size_uv0=(2, 2), occupancy_resolution=16)])], {"g_cap": 3}
    if name == "hazard_without_occupancy":
        return _rotated_overlap_metas()[:1], {}
    if name == "field_out_of_int32":
        return [FrameMeta(width=64, height=64, patches=[
            Patch(size_uv0=(1, 1), occupancy_resolution=16,
                  level_of_detail=(1 << 31, 1))])], {}
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "footprint_outside_canvas", "mixed_occupancy_resolution",
    "capacity_exceeded", "hazard_without_occupancy", "field_out_of_int32",
])
def test_errors_match(name):
    """The same exception type from both table functions, and the same
    message where they check the input themselves (NumPy words the
    out-of-int32 one)."""
    metas, kw = _error_case(name)
    with pytest.raises((ValueError, UnsupportedFeature, OverflowError)) as want:
        G.build_group_table(metas[0], **kw)
    with pytest.raises(want.type) as got:
        G.build_group_tables(metas, **kw)
    assert got.type is want.type
    assert want.type is {"hazard_without_occupancy": UnsupportedFeature,
                         "field_out_of_int32": OverflowError}.get(
                             name, ValueError)
    if want.type is not OverflowError:
        assert str(got.value) == str(want.value)


def test_kernel_times_tables_mode(capsys):
    """``kernel_times --tables`` checks both table functions equal and
    times each, here on two flagship frames on the CPU."""
    from tpu_vpcc_torch.tools import kernel_times

    out = kernel_times.tables_main(2, n_frames=2)
    assert out["frames"] == 2
    for name in ("per_patch", "vectorised"):
        assert len(out["ms_per_frame"][name]) == 2
        assert out["median_ms_per_frame"][name] > 0
    assert "equal frame for frame" in capsys.readouterr().out
