"""The port's device mesh against tpu_vpcc's on its 8 virtual CPU devices.

``tpu_vpcc_torch.parallel.mesh`` and ``parallel.spatial`` shard frames
over the mesh's 'data' axis and the slot axis (group rows, or slot
ranges) over 'space', one loop step per shard; tpu_vpcc does the same
with ``shard_map``. The same inputs, made from numpy seeds as
``tests/test_sharding.py::make_batch`` makes them (64x64, resolution 8,
precision 4, two maps), go through both: counts, totals and stitched
prefixes are integer and must be byte-equal. The smoothing grids'
combine equals the unsharded statistics. A ``Decoder`` and the batcher
with a mesh write the same PLY bytes as the port's meshless decode and
as tpu_vpcc's mesh decode (``tests/test_e2e.py``, ``test_multimap.py``,
``test_batcher.py``). The ``cuda`` twins run the port's side of the same
cases with every shard on the card (``pytest -m cuda``; they skip
without one).
"""

from __future__ import annotations

import logging
from contextlib import nullcontext
from dataclasses import fields as dc_fields
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_sharding import ARGS, make_batch, tile_batch
from test_torch_batcher import _prepared_gof, make_streams
from test_torch_dispatch import count_plain_packs, host_pack_staging
from test_torch_e2e import STREAM_PARAMS, STREAMS, needs_encoder
from test_torch_encoder import no_bridge  # noqa: F401  (a fixture)
from tpu_vpcc.ops import reconstruct as ref_reconstruct
from tpu_vpcc.ops.smoothing import AttrSmoothingConfig as RefAttrSmoothing
from tpu_vpcc.ops.smoothing import SmoothingConfig as RefSmoothing
from tpu_vpcc.parallel import mesh as ref_mesh
from tpu_vpcc.parallel import spatial as ref_spatial
from tpu_vpcc.parallel.batcher import decode_streams as ref_decode_streams
from tpu_vpcc.runtime.pipeline import Decoder as RefDecoder
from tpu_vpcc.runtime.pipeline import Params as RefParams
from tpu_vpcc.runtime.pipeline import _fetch_sharded_packed as ref_fetch_packed
from tpu_vpcc.utils.ply import format_ply
from tpu_vpcc_torch.ops import pack, payload
from tpu_vpcc_torch.ops import reconstruct as R
from tpu_vpcc_torch.ops import shift_compact as sc
from tpu_vpcc_torch.ops import smoothing as S
from tpu_vpcc_torch.ops.tiled import (
    gather_inputs_to_device,
    host_cat_stager,
    stage_cat_inputs,
)
from tpu_vpcc_torch.parallel import batcher
from tpu_vpcc_torch.parallel import mesh as port_mesh
from tpu_vpcc_torch.parallel import spatial
from tpu_vpcc_torch.runtime.pipeline import Decoder, Params, _fetch_sharded_packed

#: the port's side on the CPU, and its twin with every shard on the card
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(device: str) -> torch.device:
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")
        return torch.device("cuda", 0)
    return torch.device("cpu")


def meshes(device: str, data: int, space: int):
    """The port's mesh (one device named ``data * space`` times) and
    tpu_vpcc's over its virtual CPU devices, both ``data x space``."""
    dev = _device(device)
    return (port_mesh.make_mesh([dev] * (data * space), data=data,
                                space=space),
            ref_mesh.make_mesh(data=data, space=space))


def port_cfg(cfg_ref, **kw):
    """The port's FrameConfig of tpu_vpcc's, field by field."""
    return replace(R.FrameConfig(**{
        f.name: getattr(cfg_ref, f.name) for f in dc_fields(R.FrameConfig)
    }), **kw)


def staged(cfg_ref, batch, **kw):
    """The port's staged ``(fields, cat)`` and config of a batch."""
    (fields, cat), cfg = stage_cat_inputs(
        *tile_batch(cfg_ref, batch), port_cfg(cfg_ref, **kw))
    return fields, cat, cfg


def ref_stitched(pos, col, cnt, s_loc):
    pos, col, cnt = np.asarray(pos), np.asarray(col), np.asarray(cnt)
    return [ref_spatial.stitch_spatial(pos[k], col[k], cnt[k], s_loc)
            for k in range(pos.shape[0])]


def assert_frames_equal(got, want):
    assert len(got) == len(want)
    for (gp, gc), (wp, wc) in zip(got, want):
        assert gp.shape[0] == wp.shape[0]
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gc, wc)


def test_make_mesh_matches_reference():
    """Layouts and errors: the grid fills row by row, as the reference's
    ``reshape(data, space)`` does; ``data=0`` takes what is left."""
    import jax

    devs = [torch.device("cuda", i) for i in range(8)]  # names only
    ids = {d.id: k for k, d in enumerate(jax.devices())}
    for data, space in ((8, 1), (4, 2), (2, 4), (0, 2), (0, 1), (1, 8)):
        got = port_mesh.make_mesh(devs, data=data, space=space)
        ref = ref_mesh.make_mesh(data=data, space=space)
        assert got.shape == dict(ref.shape)
        assert got.axis_names == tuple(ref.axis_names)
        want = np.vectorize(lambda d: ids[d.id])(ref.devices)
        np.testing.assert_array_equal(
            np.vectorize(lambda d: d.index)(got.devices), want)
    for data, space in ((3, 2), (5, 1), (0, 3)):
        with pytest.raises(ValueError) as got:
            port_mesh.make_mesh(devs, data=data, space=space)
        with pytest.raises(ValueError) as ref:
            ref_mesh.make_mesh(data=data, space=space)
        assert str(got.value) == str(ref.value)


def test_make_mesh_without_card_raises(monkeypatch):
    """No silent CPU mesh: the default devices are the CUDA cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_mesh.make_mesh()
    assert port_mesh.make_mesh([torch.device("cpu")] * 2).shape == {
        "data": 2, "space": 1}


@pytest.mark.parametrize("device", DEVICES)
def test_data_parallel_matches_reference(device):
    frames, cfg, batch = make_batch(8, seed=1)
    mesh, rmesh = meshes(device, 8, 1)
    before = sc.full_launches
    pos, col, cnt = port_mesh.reconstruct_batch_data_parallel(
        mesh, *(batch[a] for a in ARGS), port_cfg(cfg))
    if device == "cuda":
        assert sc.full_launches == before + 8  # K1F once per data row
    rpos, rcol, rcnt = map(np.asarray, ref_mesh.reconstruct_batch_data_parallel(
        rmesh, *(batch[a] for a in ARGS), cfg))
    np.testing.assert_array_equal(cnt, rcnt)
    assert pos.dtype == col.dtype == np.uint16 and pos.shape == rpos.shape
    for k in range(8):
        n = int(rcnt[k])
        assert n > 0
        np.testing.assert_array_equal(pos[k, :n], rpos[k, :n])
        np.testing.assert_array_equal(col[k, :n], rcol[k, :n])


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("data,space", [(4, 2), (2, 4)])
def test_gof_spatial_matches_reference(device, data, space):
    frames, cfg, batch = make_batch(4, seed=2)
    mesh, rmesh = meshes(device, data, space)
    pos, col, cnt, totals = spatial.reconstruct_gof_spatial(
        mesh, *(batch[a] for a in ARGS), port_cfg(cfg))
    rpos, rcol, rcnt, rtot = ref_spatial.reconstruct_gof_spatial(
        rmesh, *(batch[a] for a in ARGS), cfg)
    s_loc = cfg.s_cap // space
    np.testing.assert_array_equal(cnt, np.asarray(rcnt))
    np.testing.assert_array_equal(totals, np.asarray(rtot))
    np.testing.assert_array_equal(totals[:, 0], cnt.sum(axis=1))
    got = [spatial.stitch_spatial(pos[k], col[k], cnt[k], s_loc)
           for k in range(4)]
    assert_frames_equal(got, ref_stitched(rpos, rcol, rcnt, s_loc))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("pack30,data,space", [
    (False, 4, 2), (True, 4, 2), (False, 2, 4)])
def test_pretiled_packed_matches_reference(device, pack30, data, space):
    """The narrow path per shard (K1 at the shard's slot extent) and the
    sharded fetch stitch to the reference's points; one K1 launch per
    shard on the card."""
    frames, cfg, batch = make_batch(4, seed=7)
    cfg = replace(cfg, pack30=pack30)
    mesh, rmesh = meshes(device, data, space)
    fields, cat, pcfg = staged(cfg, batch)
    before = sc.launches
    ops, cnt, totals = spatial.reconstruct_gof_spatial_pretiled_packed(
        mesh, *host_cat_stager(fields, cat), pcfg)
    if device == "cuda":
        assert sc.launches == before + data * space
    assert len(ops) == data and all(len(row) == space for row in ops)
    assert all(len(o) == (2 if pack30 else 3) for row in ops for o in row)
    s_loc = cfg.s_cap // space
    rops, rcnt, rtot = ref_spatial.reconstruct_gof_spatial_pretiled_packed(
        rmesh, *tile_batch(cfg, batch), cfg)
    np.testing.assert_array_equal(cnt, np.asarray(rcnt))
    np.testing.assert_array_equal(totals, np.asarray(rtot))
    assert_frames_equal(
        _fetch_sharded_packed(ops, cnt, space, s_loc),
        ref_fetch_packed(rops, rcnt, space, s_loc))


def _smoothing(kind):
    """(port kw, reference kw) of a smoothing case."""
    if kind == "none":
        return {}, {}
    return ({"smoothing": S.SmoothingConfig(8, 4, 10),
             "attr_smoothing": S.AttrSmoothingConfig(8, 255, 1, 10)},
            {"smoothing": RefSmoothing(8, 4, 10),
             "attr_smoothing": RefAttrSmoothing(8, 255, 1, 10)})


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("smooth,data,space", [
    ("none", 4, 2), ("both", 4, 2), ("both", 2, 4)])
def test_pretiled_wide_matches_reference(device, smooth, data, space):
    """The wide path per shard (K2W, smoothing statistics combined across
    the shards, K1F) stitches to the reference's points, which equal its
    unsharded smoothing."""
    frames, cfg, batch = make_batch(4, seed=7)
    kw, ref_kw = _smoothing(smooth)
    cfg = replace(cfg, **ref_kw)
    mesh, rmesh = meshes(device, data, space)
    fields, cat, pcfg = staged(cfg, batch, **kw)
    before = (payload.launches, sc.full_launches)
    ops, cnt, totals = spatial.reconstruct_gof_spatial_pretiled(
        mesh, *host_cat_stager(fields, cat), pcfg)
    if device == "cuda":
        assert (payload.launches, sc.full_launches) == (
            before[0] + data * space, before[1] + data * space)
    s_loc = cfg.s_cap // space
    rpos, rcol, rcnt, rtot = ref_spatial.reconstruct_gof_spatial_pretiled(
        rmesh, *tile_batch(cfg, batch), cfg)
    np.testing.assert_array_equal(cnt, np.asarray(rcnt))
    np.testing.assert_array_equal(totals, np.asarray(rtot))
    got = _fetch_sharded_packed(ops, cnt, space, s_loc, layout="wide")
    assert_frames_equal(got, ref_stitched(rpos, rcol, rcnt, s_loc))


@pytest.mark.parametrize("device", DEVICES)
def test_sharded_smoothing_matches_unsharded(device):
    """On a smoothed 128^2 GOF the wide path over 4 'space' shards equals
    the unsharded dispatch, and smoothing moved points."""
    from tpu_vpcc_torch.ops.tiled import reconstruct_batch_pretiled
    from tpu_vpcc_torch.runtime import pipeline as P

    gof = _prepared_gof("wide", 0)
    cfg, tables, g_bucket = P._gof_tables_and_bucket(gof, 4)
    di = P._gof_device_inputs(gof, gof.metas, (cfg, tables), g_bucket)
    assert di.staging == "device_pack"
    dev = _device(device)
    mesh = port_mesh.make_mesh([dev] * 4, data=1, space=4)
    s_loc = g_bucket // 4 * cfg.slots_per_block

    def sharded(c):
        ops, cnt, _ = spatial.reconstruct_gof_spatial_pretiled(
            mesh, *di.cat_stager(), c)
        return _fetch_sharded_packed(ops, cnt, 4, s_loc, layout="wide")

    ops, cnt = reconstruct_batch_pretiled(*di.on_device(dev), di.cfg)
    cnt = cnt.cpu().numpy()
    whole = [(p[: cnt[k]], c[: cnt[k]]) for k, (p, c) in enumerate(
        zip(*P._fetch_prefixes_packed(ops, cnt, layout="wide")))]
    got = sharded(di.cfg)
    assert_frames_equal(got, whole)
    unsmoothed = sharded(replace(di.cfg, smoothing=None, attr_smoothing=None))
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(got, unsmoothed))


def _one_frame_inputs(batch, k, dev):
    """Frame ``k`` of a batch as the port's single-frame tensors."""
    return [t[0] for t in gather_inputs_to_device(
        *(batch[a][k : k + 1] for a in ARGS), dev)]


@pytest.mark.parametrize("device", DEVICES)
def test_slot_range_and_frame_match_reference(device):
    """``reconstruct_slot_range`` at several starts (whole groups, part of
    a group, the last slots) and ``reconstruct_frame``:
    counts and compacted prefixes equal the reference's."""
    frames, cfg, batch = make_batch(2, seed=9)
    pcfg = port_cfg(cfg)
    spb = cfg.slots_per_block
    dev = _device(device)
    for k in range(2):
        inputs = _one_frame_inputs(batch, k, dev)
        ref_in = [batch[a][k] for a in ARGS]
        # two lengths (the reference traces each length anew)
        cases = [(0, 5 * spb), (3 * spb, 5 * spb), (spb + 37, 1000),
                 (cfg.s_cap // 2 + 5, 1000), (cfg.s_cap - 1000, 1000)]
        for s_start, s_len in cases:
            pos, col, n = R.reconstruct_slot_range(s_start, s_len, *inputs,
                                                   pcfg)
            rpos, rcol, rn = map(np.asarray, ref_reconstruct.reconstruct_slot_range(
                jnp.int32(s_start), s_len, *ref_in, cfg))
            assert int(n) == int(rn)
            n = int(n)
            np.testing.assert_array_equal(pos[:n].cpu().numpy(), rpos[:n])
            np.testing.assert_array_equal(col[:n].cpu().numpy(), rcol[:n])
        pos, col, n = R.reconstruct_frame(*inputs, pcfg)
        rpos, rcol, rn = map(np.asarray, ref_reconstruct.reconstruct_frame(
            *ref_in, cfg=cfg))
        assert int(n) == int(rn) > 0
        np.testing.assert_array_equal(pos[: int(n)].cpu().numpy(),
                                      rpos[: int(rn)])
        np.testing.assert_array_equal(col[: int(n)].cpu().numpy(),
                                      rcol[: int(rn)])
    with pytest.raises(ValueError, match="outside the table"):
        R.reconstruct_slot_range(cfg.s_cap - 10, 11, *inputs, pcfg)


def test_stitch_spatial_matches_reference():
    rng = np.random.default_rng(3)
    for n_space, s_loc in ((2, 50), (4, 17), (1, 9)):
        pos = rng.integers(0, 1 << 16, (n_space * s_loc, 3)).astype(np.uint16)
        col = rng.integers(0, 1 << 16, (n_space * s_loc, 3)).astype(np.uint16)
        counts = rng.integers(0, s_loc + 1, n_space).astype(np.int32)
        counts[0] = 0
        got = spatial.stitch_spatial(pos, col, counts, s_loc)
        want = ref_spatial.stitch_spatial(pos, col, counts, s_loc)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("device", DEVICES)
def test_combine_stats_equals_unsharded(device):
    """Cell statistics of slot shards (contiguous, and arbitrary subsets)
    combined equal the whole frames' statistics; applying them shard by
    shard gives ``smooth_flat``'s and ``smooth_colors_flat``'s bytes."""
    dev = _device(device)
    rng = np.random.default_rng(21)
    n, F = 6000, 2

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.asarray(a)).to(dtype).to(dev)

    xs, ys, zs = (t(rng.integers(0, 300, n)) for _ in range(3))
    cy, cu, cv = (t(rng.integers(0, 1024, n)) for _ in range(3))
    valid = t(rng.random(n) < 0.8, torch.bool)
    pid = t(rng.integers(0, 5, n))
    frame = t(rng.integers(0, F, n), torch.int64)
    geo = S.SmoothingConfig(8, 4, 10)
    attr = S.AttrSmoothingConfig(8, 255, 1, 10)
    whole_g = S.geometry_stats(xs, ys, zs, valid, pid, frame, F, geo)
    whole_c = S.color_stats(xs, ys, zs, cy, cu, cv, valid, pid, frame, F,
                            attr)
    want_g = S.smooth_flat(xs, ys, zs, valid, pid, frame, F, geo)
    want_c = S.smooth_colors_flat(xs, ys, zs, cy, cu, cv, valid, pid, frame,
                                  F, attr)
    order = torch.from_numpy(rng.permutation(n)).to(dev)
    for idx in (torch.arange(n, device=dev), order):
        parts = torch.tensor_split(idx, [1000, 1001, 4500])
        devices = [dev] * len(parts)
        for stats_fn, args, cfg, whole, apply_fn, want in (
            (S.geometry_stats, (xs, ys, zs), geo, whole_g, S.geometry_apply,
             want_g),
            (S.color_stats, (xs, ys, zs, cy, cu, cv), attr, whole_c,
             S.color_apply, want_c),
        ):
            shard_stats = [
                stats_fn(*(a[p] for a in args), valid[p], pid[p], frame[p],
                         F, cfg) for p in parts
            ]
            combined = S.combine_stats(shard_stats, devices)
            assert len(combined) == len(parts)
            # one device: every shard shares the one combined copy
            assert all(c[0] is combined[0][0] for c in combined)
            for a, b in zip(combined[0], whole):
                assert a.dtype == torch.int32
                assert torch.equal(a, b)
            got = [torch.empty_like(w) for w in want]
            for p, st in zip(parts, combined):
                out = apply_fn(st, *(a[p] for a in args), valid[p], pid[p],
                               frame[p], cfg)
                for g, o in zip(got, out):
                    g[p] = o
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            # each shard against its own grids alone smooths otherwise
            alone = [torch.empty_like(w) for w in want]
            for p, st in zip(parts, shard_stats):
                out = apply_fn(st, *(a[p] for a in args), valid[p], pid[p],
                               frame[p], cfg)
                for g, o in zip(alone, out):
                    g[p] = o
            assert any(not torch.equal(g, w) for g, w in zip(alone, want))
    moved = sum(int((a != b).sum()) for a, b in zip(want_g, (xs, ys, zs)))
    assert moved > 0, "the case must move points"


#: fixture families through a Decoder with a mesh: plain, smoothing, 45°
#: views in three maps, rotated (the counted fallback), trailing layer
DECODER_FAMILIES = ("verify", "smoothing", "proj45_three_maps", "rotated",
                    "three_maps")


@needs_encoder
@pytest.mark.parametrize("name", DECODER_FAMILIES)
def test_decoder_on_mesh_matches_meshless_and_reference(name, caplog):
    data = STREAMS[name]()
    kw = STREAM_PARAMS.get(name, {})

    def port(mesh=None):
        dec = Decoder(Params(data, device="cpu", mesh=mesh, **kw))
        dec.start()
        return [format_ply(f) for f in dec], dec.stats.counter_totals()

    mesh, rmesh = meshes("cpu", 4, 2)
    plain, _ = port()
    with caplog.at_level(logging.WARNING):
        sharded, counters = port(mesh)
    ref = RefDecoder(RefParams(data, mesh=rmesh, **kw))
    ref.start()
    ref_sharded = [format_ply(f) for f in ref]
    assert len(plain) >= 1
    assert sharded == plain
    assert sharded == ref_sharded
    fallbacks = counters.get("mesh_fallback_dispatches", 0)
    warned = "falls back to single-device" in caplog.text
    if name == "rotated":
        assert fallbacks >= 1 and warned
        assert "non-tileable frames" in caplog.text
    else:
        assert fallbacks == 0 and not warned


@needs_encoder
@pytest.mark.parametrize("data,space,n_streams", [(4, 2, 2), (8, 1, 8)])
def test_batcher_on_mesh_matches_meshless_and_reference(tmp_path, data, space,
                                                        n_streams):
    """``decode_streams`` with a mesh, as ``tests/test_batcher.py`` runs
    it: bit-identical to the meshless decode and to tpu_vpcc's."""
    paths = make_streams(tmp_path, n_streams=n_streams, n_frames=2)
    mesh, rmesh = meshes("cpu", data, space)
    params = Params(device="cpu")

    def fmt(streams):
        return [[format_ply(f) for f in s] for s in streams]

    sharded = fmt(batcher.decode_streams(paths, mesh=mesh, params=params))
    plain = fmt(batcher.decode_streams(paths, params=params))
    ref = fmt(ref_decode_streams(paths, mesh=rmesh))
    assert all(len(s) == 2 for s in sharded)
    assert sharded == plain == ref


def test_batcher_explicit_mesh_wins(monkeypatch):
    """An explicit ``mesh`` wins over ``params.mesh``: the dispatches see
    the explicit one."""
    seen = []
    real = batcher._dispatch_device

    def spy(di, device, stats=None, mesh=None):
        seen.append(mesh)
        return real(di, device, stats=stats, mesh=mesh)

    monkeypatch.setattr(batcher, "_dispatch_device", spy)
    cpu = [torch.device("cpu")]
    in_params = port_mesh.make_mesh(cpu * 2, data=1, space=2)
    explicit = port_mesh.make_mesh(cpu * 2, data=2, space=1)
    streams = [[_prepared_gof("narrow", 0)]]
    params = Params(device="cpu", mesh=in_params)
    for mesh, want in ((explicit, explicit), (None, in_params)):
        seen.clear()
        out = list(batcher._decode_waves(
            [iter(g) for g in streams], lambda it: next(it, None), params,
            mesh=mesh))
        assert len(out) == 2 and seen and all(m is want for m in seen)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("data,space", [(1, 4), (2, 2)])
def test_prepared_gofs_on_mesh(device, data, space):
    """``Decoder.start_gofs`` with a mesh on prepared 128^2 GOFs of the
    three paths equals the meshless CPU decode; on the card the K1, K2W
    and K1F launches are shards x chunks on the tiled GOFs, and the
    gather GOF falls back (counted) to one K1F launch."""
    kinds = ("narrow", "wide", "gather")
    gofs = {k: [_prepared_gof(k, 0), _prepared_gof(k, 2)] for k in kinds}
    dev = _device(device)
    mesh = port_mesh.make_mesh([dev] * (data * space), data=data, space=space)
    for kind, kind_gofs in gofs.items():
        before = (sc.launches, payload.launches, sc.full_launches,
                  pack.launches)
        dec = Decoder(Params(device=str(dev), mesh=mesh))
        dec.start_gofs(kind_gofs)
        got = [format_ply(f) for f in dec]
        launched = (sc.launches - before[0], payload.launches - before[1],
                    sc.full_launches - before[2], pack.launches - before[3])
        plain = Decoder(Params(device="cpu"))
        plain.start_gofs(kind_gofs)
        assert got == [format_ply(f) for f in plain]
        assert len(got) == 4 and all(b"element vertex 0" not in f
                                     for f in got)
        fallbacks = dec.stats.counter_totals().get(
            "mesh_fallback_dispatches", 0)
        assert fallbacks == (2 if kind == "gather" else 0)
        if device == "cuda":
            shards_x_chunks = data * space * 2  # one chunk per GOF
            rows_x_chunks = data * 2  # K5: one card named on every row
            assert launched == {
                "narrow": (shards_x_chunks, 0, 0, rows_x_chunks),
                "wide": (0, shards_x_chunks, shards_x_chunks, rows_x_chunks),
                "gather": (0, 0, 2, 0),
            }[kind]
        else:
            assert launched == (0, 0, 0, 0)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("data,space", [(1, 4), (2, 2)])
def test_device_pack_on_mesh_packs_once_per_device_and_row(
        device, data, space, monkeypatch):
    """Prepared 128^2 narrow and wide GOFs through a ``Decoder`` on a
    mesh of one device named ``data x space`` times: the device pack (the
    default staging) runs once for each distinct device of each data row
    and chunk, not once a shard (the plain version on the CPU, K5's
    launches on the card), and the frames equal the meshless decode; the
    frames are the same under the host pack, which packs nothing on the
    device."""
    dev = _device(device)
    mesh = port_mesh.make_mesh([dev] * (data * space), data=data,
                               space=space)
    calls = count_plain_packs(monkeypatch)
    for kind in ("narrow", "wide"):
        gofs = [_prepared_gof(kind, 0), _prepared_gof(kind, 2)]
        plain = Decoder(Params(device="cpu"))
        plain.start_gofs(gofs)
        want = [format_ply(f) for f in plain]
        outs = []
        for hostpack in (False, True):
            del calls[:]
            before = pack.launches
            with (host_pack_staging() if hostpack else nullcontext()):
                dec = Decoder(Params(device=str(dev), mesh=mesh))
                dec.start_gofs(gofs)
                outs.append([format_ply(f) for f in dec])
            packs = len(calls) + pack.launches - before
            # one distinct device a row; a GOF of two frames is one chunk
            assert packs == (0 if hostpack else data * len(gofs)), (
                kind, hostpack, packs)
            assert not dec.stats.counter_totals().get(
                "mesh_fallback_dispatches")
        assert outs[0] == want and outs[1] == want


@pytest.mark.cuda
def test_distinct_cards_match_cpu():
    """On a machine with four cards: the same sharded dispatches over
    four distinct cards equal the CPU mesh's."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards (on the card: pytest -m cuda)")
    frames, cfg, batch = make_batch(4, seed=7)
    kw, ref_kw = _smoothing("both")
    cfg = replace(cfg, **ref_kw)
    fields, cat, pcfg = staged(cfg, batch, **kw)
    cards = [torch.device("cuda", i) for i in range(4)]
    for data, space in ((1, 4), (2, 2), (4, 1)):
        s_loc = cfg.s_cap // space
        outs = []
        for devs in (cards, [torch.device("cpu")] * 4):
            mesh = port_mesh.make_mesh(devs, data=data, space=space)
            ops, cnt, _ = spatial.reconstruct_gof_spatial_pretiled(
                mesh, *host_cat_stager(fields, cat), pcfg)
            outs.append((cnt, _fetch_sharded_packed(ops, cnt, space, s_loc,
                                                    layout="wide")))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        assert_frames_equal(outs[0][1], outs[1][1])


def test_graft_entry_forward_on_cpu():
    """``graft_entry.entry``: the narrow dispatch at 256^2 counts the
    points of the gather fallback on the same frame (an independent
    path)."""
    from tpu_vpcc_torch import graft_entry
    from tpu_vpcc_torch.models.flagship import (
        FlagshipConfig,
        example_batch_inputs,
    )

    fn, args = graft_entry.entry(device="cpu")
    ops, counts = fn(*args)
    assert len(ops) in (2, 3) and int(counts[0]) > 0
    cfg = FlagshipConfig(256, 256, 16, 4, 2, batch=1)
    _, want = R.reconstruct_batch(*gather_inputs_to_device(
        *example_batch_inputs(cfg, n_patches=8), "cpu"), cfg.frame_config())
    assert torch.equal(counts, want)


def test_graft_entry_matches_reference_entry():
    """``graft_entry.entry`` (raw pre-tiled planes: K5, words, K1) against
    the root ``__graft_entry__.entry`` (``_flat_pretiled_impl`` on the
    same raw planes): equal counts and compacted points."""
    import jax

    import __graft_entry__ as ref_graft
    from tpu_vpcc_torch import graft_entry
    from tpu_vpcc_torch.ops.tiled import _unpack_ops_points

    fn, args = graft_entry.entry(device="cpu")
    ops, counts = fn(*args)
    pos, col = _unpack_ops_points(ops, "narrow")
    ref_fn, ref_args = ref_graft.entry()
    rpos, rcol, rcnt = map(np.asarray, jax.jit(ref_fn)(*ref_args))
    np.testing.assert_array_equal(counts.numpy(), rcnt)
    assert int(counts[0]) > 0
    for f, n in enumerate(rcnt):
        np.testing.assert_array_equal(pos[f, :n].numpy(), rpos[f, :n])
        np.testing.assert_array_equal(col[f, :n].numpy(), rcol[f, :n])
    # the entry's planes are the reference's, bucketed to the live groups
    assert len(args) == len(ref_args) == 7
    for a, b in zip(args[1:], ref_args[1:]):
        np.testing.assert_array_equal(a.numpy().view(b.dtype), b)


@pytest.mark.parametrize("n_devices", [8, 3])
def test_graft_entry_dryrun_on_cpu(n_devices, no_bridge):
    """``graft_entry.dryrun_multichip`` on the CPU named n times, the
    native video bridge refused: its sharded steps agree and the stream
    it authors, its video served from the store, decodes through the
    mesh byte-equal to the oracle (it raises otherwise)."""
    from tpu_vpcc_torch import graft_entry

    graft_entry.dryrun_multichip(n_devices, device="cpu")


@pytest.mark.parametrize("n_devices,data", [(1, 1), (2, 1), (4, 2)])
def test_graft_entry_dryrun_never_calls_bridge(n_devices, data, no_bridge,
                                               monkeypatch):
    """The dry run's stream step calls neither the bridge's decode
    (``runtime.pipeline.decompress_video``) nor its encoder (the
    ``utils.fixtures.encode_yuv420`` that ``build_fixture_stream``
    calls): the store serves both, at every row count; the decode
    looks up each of the entry's decoded results."""
    from tpu_vpcc_torch import graft_entry
    from tpu_vpcc_torch.runtime import pipeline
    from tpu_vpcc_torch.tools import video_store
    from tpu_vpcc_torch.utils import fixtures

    called = []

    def spy(name):
        def call(*args, **kw):
            called.append(name)
            raise AssertionError(f"the dry run called the bridge's {name}")
        return call

    bridge_decode = spy("decompress_video")
    monkeypatch.setattr(pipeline, "decompress_video", bridge_decode)
    monkeypatch.setattr(fixtures, "encode_yuv420", spy("encode_yuv420"))
    store = video_store.VideoStore()
    graft_entry.dryrun_multichip(n_devices, device="cpu", store=store)
    assert not called
    assert pipeline.decompress_video is bridge_decode  # restored
    entry = store.entries[graft_entry.DRYRUN_ENTRY.format(data=data)]
    # one served encode a video unit, and every decoded result looked up
    assert store.encode_hits == len(video_store.video_units(
        entry.stream.read_bytes()))
    assert store.hits >= len(entry.calls)


@pytest.mark.parametrize("data", [1, 2, 3, 4])
def test_graft_dryrun_stream_matches_reference(data, no_bridge, monkeypatch):
    """``graft_entry.dryrun_stream`` (the port's scene generator and
    ``build_fixture_stream``) equals the stream that the root
    ``__graft_entry__``'s dry run authors at the same rows, both
    encoding through the store, and the store's entry."""
    from test_torch_video_store import reference_dryrun_stream
    from tpu_vpcc.utils import fixtures as ref_fixtures
    from tpu_vpcc_torch import graft_entry
    from tpu_vpcc_torch.tools.video_store import VideoStore, served_encode

    store = VideoStore()
    monkeypatch.setattr(ref_fixtures, "encode_yuv420", store.encode)
    ref = reference_dryrun_stream(data)
    with served_encode(store):
        got = graft_entry.dryrun_stream(data)
    name = graft_entry.DRYRUN_ENTRY.format(data=data)
    assert got == ref == store.entries[name].stream.read_bytes()


@pytest.mark.parametrize("n_devices", [5, 10])
def test_graft_entry_dryrun_without_entry_raises(n_devices, no_bridge):
    """Five 'data' rows (5 devices, or 10 in two 'space' shards) have no
    store entry: the dry run raises ``StoreMiss`` naming the entry, and
    neither falls back to the bridge nor skips its stream step."""
    from tpu_vpcc_torch import graft_entry
    from tpu_vpcc_torch.tools.video_store import StoreMiss

    with pytest.raises(StoreMiss, match="graft_dryrun_d5"):
        graft_entry.dryrun_multichip(n_devices, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 8])
def test_graft_entry_dryrun_on_card(n_devices, no_bridge):
    """The dry run with ``cuda:0`` named n times; every kernel of its
    path launched (K5, K2W, K1F, K1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")
    from tpu_vpcc_torch import graft_entry

    for mod in (sc, payload, pack):
        mod.reset_launches()
    graft_entry.dryrun_multichip(n_devices, device="cuda:0")
    assert min(sc.launches, sc.full_launches, payload.launches,
               pack.launches) > 0


def test_graft_entry_without_card_raises(monkeypatch):
    from tpu_vpcc_torch import graft_entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
