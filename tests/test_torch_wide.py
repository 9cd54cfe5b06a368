"""The wide path of the PyTorch port against tpu_vpcc's, on the CPU.

Held against the JAX package, with the same inputs made from a seed with
numpy:

  - K1F's plain version (``shift_compact_full``) against the Pallas
    kernel ``shift_compact_full_order(..., interpret=True)``;
  - K2W's plain version (``payload.wide_words``) against the wide branch
    of ``tiled._tiles_to_words`` and, where its scope allows, against
    ``pallas_kernels.tiles_to_payload_pallas(..., interpret=True)``;
  - the smoothing against ``smooth_batch``/``smooth_colors_batch`` and
    the numpy oracle;
  - the whole wide dispatch and fetch against
    ``tiled.reconstruct_batch_pretiled`` + ``pipeline._fetch_prefixes``.

The reference side stages host-packed, host-oriented cats
(``TPU_VPCC_HOSTPACK=1 TPU_VPCC_HOSTORIENT=1``), except in the
device-pack cases of the whole dispatch: there it runs its own CPU
default on the raw block-tiled arrays, against the port's device-packed
and host-packed dispatches. Outputs are integers:
no tolerance, words compared bit for bit, compacted operands up to each
frame's count. The kernels themselves are held against these plain
versions by the ``cuda``-marked tests, on a card.
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dispatch import PREC, RES, H, W, _frames, _tiled
from tpu_vpcc.atlas import groups as G
from tpu_vpcc.models import flagship as ref_flagship
from tpu_vpcc.ops import smoothing as ref_smoothing
from tpu_vpcc.ops import tiled as ref_tiled
from tpu_vpcc.ops.pallas_kernels import tiles_to_payload_pallas
from tpu_vpcc.ops.shift_compact import shift_compact_full_order
from tpu_vpcc.ops.smoothing import AttrSmoothingConfig, SmoothingConfig
from tpu_vpcc.runtime import pipeline as ref_pipeline
from tpu_vpcc_torch.ops import payload as K2W
from tpu_vpcc_torch.ops import shift_compact as sc
from tpu_vpcc_torch.ops import smoothing as S
from tpu_vpcc_torch.ops import smoothing_np as SNP
from tpu_vpcc_torch.ops import tiled as T
from tpu_vpcc_torch.runtime import pipeline as P


@pytest.fixture(autouse=True)
def host_cat_env(monkeypatch):
    monkeypatch.setenv("TPU_VPCC_HOSTPACK", "1")
    monkeypatch.setenv("TPU_VPCC_HOSTORIENT", "1")


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# ---------------------------------------------------------------------------
# K1F: full-order compaction
# ---------------------------------------------------------------------------


def _k1f_port(words, valid):
    ops, counts = sc.shift_compact_full(
        [_i32(w) for w in words], torch.from_numpy(valid)
    )
    return [o.numpy().view(np.uint32) for o in ops], counts.numpy()


def _assert_full_prefixes(ref_ops, ref_counts, ops, counts, words, valid):
    np.testing.assert_array_equal(counts, ref_counts)
    np.testing.assert_array_equal(counts, valid.sum(axis=1))
    for w, a, b in zip(words, ref_ops, ops):
        for f, n in enumerate(counts):
            np.testing.assert_array_equal(b[f, :n], np.asarray(a)[f, :n])
            np.testing.assert_array_equal(b[f, :n], w[f][valid[f]])


def _k1f_words(F, S, seed):
    r = np.random.default_rng(seed)
    return [r.integers(0, 1 << 32, (F, S), dtype=np.uint32) for _ in range(3)]


@pytest.mark.parametrize(
    "F,S,extent,density",
    [
        (1, 16384, 8192, 0.6),
        (2, 32768, 16384, 0.35),
        (1, 8192, 2048, 0.0),
        (1, 16384, 16384, 1.0),
        (3, 16384, 4096, 0.5),
        # the edges of the kernel's 4,096-slot tiles that the Pallas
        # kernel also takes: one tile, three frames of three tiles, 36
        # tiles (the look-back passes a warp's 32 status words)
        (1, 4096, 4096, 0.6),
        (3, 12288, 4096, 0.6),
        (1, 147456, 8192, 0.6),
    ],
)
def test_k1f_plain_matches_pallas_kernel(F, S, extent, density):
    words = _k1f_words(F, S, seed=S * 13 + F)
    valid = np.random.default_rng(F + S).random((F, S)) < density
    ref_ops, ref_counts = shift_compact_full_order(
        tuple(jnp.asarray(w) for w in words), jnp.asarray(valid), F, S,
        extent=extent, interpret=True,
    )
    ops, counts = _k1f_port(words, valid)
    _assert_full_prefixes(ref_ops, np.asarray(ref_counts), ops, counts,
                          words, valid)


@pytest.mark.parametrize("pattern", ["last_chunk", "one_per_chunk",
                                     "run_across_boundary"])
def test_k1f_plain_degenerate_patterns(pattern):
    F, S, extent = 1, 16384, 4096
    words = _k1f_words(F, S, seed=5)
    valid = np.zeros((F, S), bool)
    if pattern == "last_chunk":
        valid[:, S - extent:] = True
    elif pattern == "one_per_chunk":
        valid[:, ::extent] = True
    else:
        valid[:, : extent + 7] = True
    ref_ops, ref_counts = shift_compact_full_order(
        tuple(jnp.asarray(w) for w in words), jnp.asarray(valid), F, S,
        extent=extent, interpret=True,
    )
    ops, counts = _k1f_port(words, valid)
    _assert_full_prefixes(ref_ops, np.asarray(ref_counts), ops, counts,
                          words, valid)


def test_k1f_odd_extent_and_empty_frames():
    """Extents no TPU chunk divides, and frames of no slots."""
    for F, S in ((2, 3 * 2048 + 5), (3, 1), (2, 0)):
        words = _k1f_words(F, S, seed=F * 31 + S)
        valid = np.random.default_rng(S).random((F, S)) < 0.5
        ops, counts = _k1f_port(words, valid)
        ref_ops = [np.zeros_like(w) for w in words]
        for w, ref in zip(words, ref_ops):
            for f in range(F):
                ref[f, : valid[f].sum()] = w[f][valid[f]]
        _assert_full_prefixes(ref_ops, valid.sum(axis=1), ops, counts,
                              words, valid)


@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("S", [4097, 8963], ids=["one-tile+1", "3-tiles+3"])
def test_k1f_plain_at_ragged_tile_edges(S, F):
    """Extents at the edges of the kernel's 4,096-slot tiles that no
    Pallas chunk divides and the kernel's 16-byte validity vector does
    not either: the plain version against numpy."""
    words = _k1f_words(F, S, seed=S + F)
    valid = np.random.default_rng(S * F).random((F, S)) < 0.6
    ops, counts = _k1f_port(words, valid)
    ref_ops = [np.zeros_like(w) for w in words]
    for w, ref in zip(words, ref_ops):
        for f in range(F):
            ref[f, : valid[f].sum()] = w[f][valid[f]]
    _assert_full_prefixes(ref_ops, valid.sum(axis=1), ops, counts, words,
                          valid)


def test_k1f_cpu_path_is_plain_and_uncounted():
    words = [_i32(w) for w in _k1f_words(2, 512, seed=1)]
    valid = torch.from_numpy(np.random.default_rng(1).random((2, 512)) < 0.5)
    before = (sc.launches, sc.full_launches)
    ops, counts = sc.shift_compact_full(words, valid)
    ref_ops, ref_counts = sc.shift_compact_full_reference(words, valid)
    assert (sc.launches, sc.full_launches) == before
    assert torch.equal(counts, ref_counts)
    for a, b in zip(ops, ref_ops):
        for f, n in enumerate(counts.tolist()):
            assert torch.equal(a[f, :n], b[f, :n])


def test_k1f_wrapper_rejects_bad_inputs():
    w = [_i32(x) for x in _k1f_words(1, 64, seed=2)]
    v = torch.ones((1, 64), dtype=torch.bool)
    with pytest.raises(ValueError):
        sc.shift_compact_full(w[:2], v)
    with pytest.raises(TypeError):
        sc.shift_compact_full([w[0].to(torch.int64), w[1], w[2]], v)
    with pytest.raises(TypeError):
        sc.shift_compact_full(w, v.to(torch.int32))
    with pytest.raises(ValueError):
        sc.shift_compact_full([w[0][:, :32], w[1], w[2]], v)


# ---------------------------------------------------------------------------
# K2W: gather + wide words
# ---------------------------------------------------------------------------


def _raw(case_seed, mc, maps, changes, chroma_full=False, planes=False):
    """The raw block-tiled reference arrays ``(fields, occ, geo0, geo1,
    ay, au, av)`` and config for two 128² frames; ``planes`` draws each
    live group's G_PLANE from {0, 1, 2, 3} and sets
    ``additional_planes``."""
    frames = _frames(seed=case_seed, map_count=mc)
    tiled, cs = _tiled(frames, maps, chroma_full)
    fcfg = ref_flagship.FlagshipConfig(W, H, RES, PREC)
    _, cfg_ref, _, _ = ref_flagship.bucket_flagship_inputs(
        (tiled[0],), fcfg.frame_config()
    )
    cfg_ref = replace(cfg_ref, shift_compact=0, sort_split=1,
                      sort_split_batched=False, chroma_shift=cs, **changes)
    if planes:
        fields = tiled[0].copy()
        r = np.random.default_rng(case_seed)
        live = fields[:, :, G.G_VALID] > 0
        fields[:, :, G.G_PLANE] = np.where(
            live, r.integers(0, 4, live.shape), 0
        )
        assert set(np.unique(fields[live][:, G.G_PLANE])) == {0, 1, 2, 3}
        tiled = (fields,) + tiled[1:]
        cfg_ref = replace(cfg_ref, additional_planes=True)
    return tiled, cfg_ref


def _staged(case_seed, mc, maps, changes, chroma_full=False, planes=False):
    """Staged reference arrays ``(fields, cat, None x5)`` and config of
    :func:`_raw`'s case."""
    tiled, cfg_ref = _raw(case_seed, mc, maps, changes, chroma_full, planes)
    return ref_tiled.stage_cat_inputs(*tiled, cfg_ref)


def _ref_tiles(arrays, cfg_ref):
    fields = jnp.asarray(arrays[0])
    t = ref_tiled._gather_tiles(
        fields, jnp.asarray(arrays[1]), None, None, None, None, None, cfg_ref
    )
    F, Gc = fields.shape[0], fields.shape[1]
    fields_f = fields.reshape(F * Gc, G.N_GROUP_FIELDS)
    return fields_f, t, F, Gc


def _port_words(arrays, cfg_ref):
    cfg, fields, cat = T.inputs_from_reference(cfg_ref, arrays)
    before = K2W.launches
    out = K2W.wide_words(fields, cat, cfg)
    assert K2W.launches == before  # the CPU path runs the plain version
    w0, w1, w2, valid = out
    return [w.numpy().view(np.uint32) for w in (w0, w1, w2)], valid.numpy()


K2W_CASES = {
    # name: (content map count, maps dispatched, cfg changes, 4:4:4
    #        chroma, random 45-degree planes)
    "two_maps": (2, (0, 1), {}, False, False),
    "relative_d1": (2, (0, 1), {"absolute_d1": False}, False, False),
    "one_map": (1, (0,), {"map_count": 1}, False, False),
    "chroma444": (2, (0, 1), {}, True, False),
    "layer_drop_map0": (3, (1, 2), {"drop_map0": True}, False, False),
    "planes45": (2, (0, 1), {}, False, True),
    "planes45_relative_d1": (2, (0, 1), {"absolute_d1": False}, False, True),
    "planes45_drop_map0": (3, (1, 2), {"drop_map0": True}, False, True),
    "planes45_one_map": (1, (0,), {"map_count": 1}, False, True),
}


@pytest.mark.parametrize("case", sorted(K2W_CASES))
def test_k2w_plain_matches_wide_words_stage(case):
    mc, maps, changes, chroma_full, planes = K2W_CASES[case]
    arrays, cfg_ref = _staged(len(case) + 7, mc, maps, changes,
                              chroma_full, planes)
    fields_f, t, F, Gc = _ref_tiles(arrays, cfg_ref)
    S = Gc * cfg_ref.slots_per_block
    ref = ref_tiled._tiles_to_words(
        fields_f, lambda i: fields_f[:, i], *t, F, F * Gc, S, cfg_ref
    )
    words, valid = _port_words(arrays, cfg_ref)
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(valid, np.asarray(ref[3]))
    for a, b in zip(ref[:3], words):
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("case", ["two_maps", "relative_d1", "one_map",
                                  "chroma444"])
def test_k2w_plain_matches_pallas_payload_kernel(case):
    """``_payload_kernel`` has no drop_map0 and no 45-degree rotation,
    and takes group counts that are multiples of its 32-group chunk:
    the table is padded with empty rows to such a count."""
    mc, maps, changes, chroma_full, planes = K2W_CASES[case]
    arrays, cfg_ref = _staged(len(case) + 7, mc, maps, changes,
                              chroma_full, planes)
    fields = arrays[0]
    F, Gc = fields.shape[0], fields.shape[1]
    pad = -Gc % 16  # F = 2 frames: F * Gp a multiple of 32
    fields = np.concatenate(
        [fields, np.zeros((F, pad, G.N_GROUP_FIELDS), np.int32)], axis=1
    )
    arrays = (fields,) + tuple(arrays[1:])
    fields_f, t, F, Gc = _ref_tiles(arrays, cfg_ref)
    ref = tiles_to_payload_pallas(fields_f, *t, cfg_ref, interpret=True)
    words, valid = _port_words(arrays, cfg_ref)
    np.testing.assert_array_equal(
        valid.reshape(-1), np.asarray(ref[3]).astype(bool)
    )
    for a, b in zip(ref[:3], words):
        np.testing.assert_array_equal(b.reshape(-1), np.asarray(a))


def test_k2w_wrapper_rejects_bad_inputs():
    arrays, cfg_ref = _staged(3, 2, (0, 1), {})
    cfg, fields, cat = T.inputs_from_reference(cfg_ref, arrays)
    bad = arrays[0].copy()
    bad[0, 0, G.G_BLOCKID] = arrays[1].shape[1]  # one past the cat
    with pytest.raises(ValueError, match="G_BLOCKID"):
        T.to_device(bad, arrays[1], "cpu")
    with pytest.raises(ValueError, match="host-oriented"):
        K2W.wide_words(fields, cat, replace(cfg, host_oriented=False))
    with pytest.raises(TypeError):
        K2W.wide_words(fields.to(torch.int64), cat, cfg)
    with pytest.raises(ValueError):
        K2W.wide_words(fields, cat[:, :, :10], cfg)


# ---------------------------------------------------------------------------
# smoothing
# ---------------------------------------------------------------------------


def _slots(F, n, seed, extent=64):
    """Slot data for smoothing: points of four clusters crowded into a
    small cube, so that cells hold several clusters and points move."""
    r = np.random.default_rng(seed)
    xs, ys, zs = (r.integers(0, extent, (F, n)).astype(np.int32)
                  for _ in range(3))
    pid = r.integers(0, 4, (F, n)).astype(np.int32)
    valid = r.random((F, n)) < 0.8
    cy, cu, cv = (r.integers(0, 1024, (F, n)).astype(np.int32)
                  for _ in range(3))
    return xs, ys, zs, valid, pid, cy, cu, cv


SMOOTH_CFGS = {
    "grid4_bd6": SmoothingConfig(grid_size=4, threshold=4,
                                 geometry_bitdepth_3d=6),
    "grid8_bd10": SmoothingConfig(grid_size=8, threshold=16),
}
ATTR_CFGS = {
    "grid4_bd6": AttrSmoothingConfig(4, 255, 1, geometry_bitdepth_3d=6),
    "grid8_bd10": AttrSmoothingConfig(8, 255, 1),
}


@pytest.mark.parametrize("name", sorted(SMOOTH_CFGS))
def test_geometry_smoothing_matches_reference(name):
    cfg = SMOOTH_CFGS[name]
    xs, ys, zs, valid, pid, _, _, _ = _slots(2, 3000, seed=len(name))
    ref = ref_smoothing.smooth_batch(
        *(jnp.asarray(a) for a in (xs, ys, zs, valid, pid)), cfg
    )
    got = S.smooth_batch(*(torch.from_numpy(a) for a in
                           (xs, ys, zs, valid, pid)), cfg)
    moved = 0
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for f in range(2):
        ora = ref_smoothing.smooth_slots_np(
            xs[f], ys[f], zs[f], valid[f], pid[f], cfg
        )
        for a, b, orig in zip(ora, got, (xs, ys, zs)):
            np.testing.assert_array_equal(b[f].numpy(), a)
            moved += int((a != orig[f]).sum())
    assert moved > 0


@pytest.mark.parametrize("name", sorted(ATTR_CFGS))
def test_colour_smoothing_matches_reference(name):
    cfg = ATTR_CFGS[name]
    xs, ys, zs, valid, pid, cy, cu, cv = _slots(2, 3000, seed=3 + len(name))
    args = (xs, ys, zs, cy, cu, cv, valid, pid)
    ref = ref_smoothing.smooth_colors_batch(
        *(jnp.asarray(a) for a in args), cfg
    )
    got = S.smooth_colors_batch(*(torch.from_numpy(a) for a in args), cfg)
    moved = 0
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for f in range(2):
        ora = ref_smoothing.smooth_colors_np(*(a[f] for a in args), cfg)
        for a, b, orig in zip(ora, got, (cy, cu, cv)):
            np.testing.assert_array_equal(b[f].numpy(), a)
            moved += int((a != orig[f]).sum())
    assert moved > 0


# ---------------------------------------------------------------------------
# the whole wide dispatch and fetch
# ---------------------------------------------------------------------------


GEO = SmoothingConfig(grid_size=8, threshold=16)
ATTR = AttrSmoothingConfig(8, 255, 1)

DISPATCH_CASES = {
    # name: (content seed, content map count, maps dispatched, cfg
    #        changes, random 45-degree planes, colour mode); the seeds of
    #        the smoothing cases give content where smoothing moves points
    "smooth_geo_attr": (10, 2, (0, 1),
                        {"smoothing": GEO, "attr_smoothing": ATTR},
                        False, "yuv10"),
    "smooth_geo": (26, 2, (0, 1), {"smoothing": GEO}, False, "yuv10"),
    "smooth_attr_raw": (6, 2, (0, 1), {"attr_smoothing": ATTR}, False,
                        "raw"),
    "proj45": (7, 2, (0, 1), {}, True, "yuv10"),
    "proj45_layer": (8, 3, (1, 2), {"drop_map0": True}, True, "yuv10"),
    "proj45_smooth": (10, 2, (0, 1),
                      {"smoothing": GEO, "attr_smoothing": ATTR},
                      True, "yuv10"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_wide_dispatch_and_fetch_match_reference(case):
    seed, mc, maps, changes, planes, color_mode = DISPATCH_CASES[case]
    arrays, cfg_ref = _staged(seed, mc, maps, changes, planes=planes)
    assert not ref_tiled.narrow_emit_ok(cfg_ref, 2, 1)
    pos_t, col_t, counts = ref_tiled.reconstruct_batch_pretiled(
        *arrays, cfg=cfg_ref
    )
    counts = np.asarray(counts)
    pos_r, col_r = ref_pipeline._fetch_prefixes(pos_t, col_t, counts,
                                                color_mode)

    cfg, fields, cat = T.inputs_from_reference(cfg_ref, arrays)
    assert not T.narrow_emit_ok(cfg)
    ops, counts_p = T.reconstruct_batch_pretiled(fields, cat, cfg)
    counts_p = counts_p.numpy()
    np.testing.assert_array_equal(counts_p, counts)
    assert counts.min() > 0
    pos, col = P._fetch_prefixes_packed(ops, counts_p, color_mode,
                                        layout="wide")
    assert pos.dtype == pos_r.dtype and col.dtype == col_r.dtype
    for f, n in enumerate(counts):
        np.testing.assert_array_equal(pos[f, :n], pos_r[f, :n])
        np.testing.assert_array_equal(col[f, :n], col_r[f, :n])
    if cfg.smoothing is not None or cfg.attr_smoothing is not None:
        # smoothing provably ran: the unsmoothed dispatch differs
        ops0, _ = T.reconstruct_batch_pretiled(
            fields, cat, replace(cfg, smoothing=None, attr_smoothing=None)
        )
        assert any(
            not torch.equal(a[f, :n], b[f, :n])
            for a, b in zip(ops, ops0) for f, n in enumerate(counts)
        )


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_wide_device_pack_dispatch_matches_reference_default(case,
                                                             monkeypatch):
    """tpu_vpcc without the TPU's knobs (its CPU default: raw tiled
    arrays, the pack and the orientation fix on the device), the port's
    device-packed and host-packed wide dispatches: equal counts,
    byte-equal compacted prefixes."""
    from test_torch_dispatch import dispatch_both_stagings, port_cfg

    monkeypatch.delenv("TPU_VPCC_HOSTPACK")
    monkeypatch.delenv("TPU_VPCC_HOSTORIENT")
    seed, mc, maps, changes, planes, color_mode = DISPATCH_CASES[case]
    tiled, cfg_ref = _raw(seed, mc, maps, changes, planes=planes)
    assert not cfg_ref.host_oriented
    pos_t, col_t, counts = ref_tiled.reconstruct_batch_pretiled(
        *tiled, cfg=cfg_ref
    )
    counts = np.asarray(counts)
    assert counts.min() > 0
    pos_r, col_r = ref_pipeline._fetch_prefixes(pos_t, col_t, counts,
                                                color_mode)
    cfg = port_cfg(cfg_ref)
    assert not T.narrow_emit_ok(cfg)
    outs = dispatch_both_stagings(tiled, cfg, color_mode, monkeypatch)
    for frames in outs.values():
        assert len(frames) == len(counts)
        for f, (pos, col) in enumerate(frames):
            n = counts[f]
            assert len(pos) == n and pos.dtype == pos_r.dtype
            np.testing.assert_array_equal(pos, pos_r[f, :n])
            np.testing.assert_array_equal(col, col_r[f, :n])


def test_wide_layout_is_named_not_inferred():
    ops = [torch.tensor([[0x00020001, 0]], dtype=torch.int32),
           torch.tensor([[0x03FF0003, 0]], dtype=torch.int32),
           torch.tensor([[0x00050004, 0]], dtype=torch.int32)]
    pos, col = T._unpack_ops_points(ops, "wide")
    assert pos[0, 0].tolist() == [1, 2, 3]
    assert col[0, 0].tolist() == [0x3FF, 4, 5]
    pos_n, _ = T._unpack_ops_points(
        [ops[0], ops[1].to(torch.int16), ops[2]], "narrow"
    )
    assert pos_n[0, 0].tolist() == [1, 2, 3]
    with pytest.raises(ValueError):
        T._unpack_ops_points(ops, "pack31")


def test_rot45_matches_reference():
    from tpu_vpcc.ops.reconstruct import apply_inverse_rot45 as ref_rot45
    from tpu_vpcc_torch.ops.reconstruct import apply_inverse_rot45

    r = np.random.default_rng(45)
    px, py, pz = (r.integers(0, 70000, 4096).astype(np.int32)
                  for _ in range(3))
    plane = r.integers(0, 4, 4096).astype(np.int32)
    for bd in (8, 10, 12):
        ref = ref_rot45(*(jnp.asarray(a) for a in (px, py, pz, plane)), bd)
        got = apply_inverse_rot45(
            *(torch.from_numpy(a) for a in (px, py, pz, plane)), bd
        )
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# the f64 smoothing oracles (tests/test_smoothing_f64.py on the port's
# copies in ops/smoothing_np.py)
# ---------------------------------------------------------------------------

F64_CFG = S.SmoothingConfig(grid_size=8, threshold=16, geometry_bitdepth_3d=10)


def clustered_points(seed, n=50_000, n_clusters=300, n_patches=8):
    rng = np.random.default_rng(seed)
    centers = rng.integers(32, 992, (n_clusters, 3))
    idx = rng.integers(0, n_clusters, n)
    pts = np.clip(
        centers[idx] + rng.normal(0, 3, (n, 3)).astype(int), 0, 1023
    ).astype(np.int32)
    pid = rng.integers(0, n_patches, n).astype(np.int32)
    return pts, pid, np.ones(n, np.int32)


def _geo_specs(pts, pid, valid):
    """The int32 spec and the f64 oracle of the port on one point set,
    each (n, 3)."""
    args = (pts[:, 0], pts[:, 1], pts[:, 2], valid, pid, F64_CFG)
    return (np.stack(SNP.smooth_slots_np(*args), 1),
            np.stack(SNP.smooth_slots_f64(*args), 1))


def test_geo_specs_agree_away_from_threshold():
    pts, pid, valid = clustered_points(0)
    A, B = _geo_specs(pts, pid, valid)
    moved_a = (A != pts).any(1)
    moved_b = (B != pts).any(1)
    # the move gates disagree only for threshold straddlers
    assert (moved_a != moved_b).mean() < 0.025
    # where both move a point, the landings differ by at most half a cell
    both = moved_a & moved_b
    assert both.sum() > 100  # the comparison is non-vacuous
    assert np.abs(A[both].astype(int) - B[both].astype(int)).max() <= \
        F64_CFG.grid_size // 2
    neither = ~moved_a & ~moved_b
    np.testing.assert_array_equal(A[neither], pts[neither])
    np.testing.assert_array_equal(B[neither], pts[neither])


def test_geo_gate_mismatches_are_threshold_straddlers():
    """Every gate disagreement lies in a narrow f64-dist^2 window around
    the SEI threshold."""
    pts, pid, valid = clustered_points(1)
    A, B = _geo_specs(pts, pid, valid)
    mism = (A != pts).any(1) != (B != pts).any(1)
    f64_only = mism & (B != pts).any(1)
    d2 = ((B[f64_only].astype(float) - pts[f64_only]) ** 2).sum(1)
    assert d2.size and (d2 >= F64_CFG.threshold - 4).all()
    assert (d2 <= F64_CFG.threshold + 12).all()


def test_color_f64_blend_matches_hand_case():
    # the f64 blend (1575*500 + 2025*900) / 3600 = 725.0 exactly: both
    # specs agree
    a = np.array([[100 + dx, 100 + dy, 100] for dx in range(4)
                  for dy in range(4)])
    b = np.array([[100, 100, 104]])
    pts = np.concatenate([a, b]).astype(np.int32)
    pid = np.array([0] * len(a) + [1], np.int32)
    valid = np.ones(len(pts), np.int32)
    cols = np.full((len(pts), 3), 500, np.int32)
    cols[len(a)] = (900, 500, 500)
    cfg = S.AttrSmoothingConfig(
        grid_size=8, threshold_variation=400, threshold_difference=50,
        geometry_bitdepth_3d=10,
    )
    args = (pts[:, 0], pts[:, 1], pts[:, 2], cols[:, 0], cols[:, 1],
            cols[:, 2], valid, pid, cfg)
    ci = SNP.smooth_colors_np(*args)
    cf = SNP.smooth_colors_f64(*args)
    assert ci[0][len(a)] == cf[0][len(a)] == 725
    np.testing.assert_array_equal(np.stack(ci, 1), np.stack(cf, 1))


def test_fixture_decode_divergence_negligible():
    """On a reconstructed synthetic frame (the port's scene and oracle)
    the two specs are near identical: <0.2% of positions differ, D1 PSNR
    >= 80 dB."""
    from tpu_vpcc_torch.reconstruction.oracle import (
        GeneratePointCloudParams,
        generate_point_cloud,
    )
    from tpu_vpcc_torch.reconstruction.pointset import PointSet3
    from tpu_vpcc_torch.utils.metrics import d1_metric
    from tpu_vpcc_torch.utils.synthetic import make_synthetic_frame

    rng = np.random.default_rng(5)
    diverged = 0
    for _ in range(3):
        sf = make_synthetic_frame(
            rng, width=128, height=128, occupancy_resolution=8,
            occupancy_precision=4, n_patches=6, frame_index=0,
        )
        params = GeneratePointCloudParams(
            occupancy_resolution=sf.occupancy_resolution,
            occupancy_precision=sf.occupancy_precision,
            map_count_minus1=sf.map_count - 1,
        )
        ps, partition, _ = generate_point_cloud(
            sf.meta, params, sf.occ_plane, sf.geo_planes, [sf.attr_planes]
        )
        A, B = _geo_specs(ps.positions.astype(np.int32),
                          np.asarray(partition, np.int32),
                          np.ones(len(ps), np.int32))
        assert (A != B).any(1).mean() < 0.002
        diverged += (A != B).any(1).sum()
        m = d1_metric(PointSet3(positions=A.astype(np.uint16)),
                      PointSet3(positions=B.astype(np.uint16)))
        assert m.psnr >= 80.0
    assert diverged > 0, "comparison must exercise at least one divergence"


@pytest.mark.parametrize("spec", ["geometry", "colour"])
def test_f64_oracles_match_reference(spec):
    """The port's f64 oracles and tpu_vpcc's give equal outputs on the
    same clustered points."""
    pts, pid, valid = clustered_points(2, n=20_000)
    xyz = (pts[:, 0], pts[:, 1], pts[:, 2])
    if spec == "geometry":
        got = SNP.smooth_slots_f64(*xyz, valid, pid, F64_CFG)
        ref = ref_smoothing.smooth_slots_f64(
            *xyz, valid, pid, SmoothingConfig(8, 16, 10))
    else:
        cols = np.random.default_rng(3).integers(0, 1024, (len(pts), 3))
        cfg = dict(grid_size=8, threshold_variation=64,
                   threshold_difference=4, geometry_bitdepth_3d=10)
        got = SNP.smooth_colors_f64(*xyz, *cols.T, valid, pid,
                                    S.AttrSmoothingConfig(**cfg))
        ref = ref_smoothing.smooth_colors_f64(*xyz, *cols.T, valid, pid,
                                              AttrSmoothingConfig(**cfg))
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    before = xyz if spec == "geometry" else tuple(cols.T)
    assert any((a != b).any() for a, b in zip(got, before)), "nothing moved"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")


@pytest.mark.cuda
def test_k1f_kernel_matches_plain_on_card():
    _cuda_or_skip()
    # the kernel's edges (one tile, one past it, a partial last tile, 33
    # tiles, a ragged extent) in one and three frames, and the flagship's
    edges = [(F, S) for S in sc.edge_extents(sc.tile_items()).values()
             for F in (1, 3)] + [(2, 1835008)]
    for F, S in edges:
        for density in (0.0, 0.3, 0.7, 1.0):
            words = [_i32(w).cuda() for w in _k1f_words(F, S, seed=S)]
            valid = (torch.rand((F, S), device="cuda") < density)
            before = sc.full_launches
            got, n_got = sc.shift_compact_full(words, valid)
            again, n_again = sc.shift_compact_full(words, valid)
            ref, n_ref = sc.shift_compact_full_reference(words, valid)
            torch.cuda.synchronize()
            assert sc.full_launches == before + 2
            assert torch.equal(n_got, n_ref) and torch.equal(n_again, n_ref)
            for a, b, c in zip(got, again, ref):
                for f, n in enumerate(n_ref.tolist()):
                    assert torch.equal(a[f, :n], c[f, :n])
                    assert torch.equal(b[f, :n], c[f, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K2W_CASES))
def test_k2w_kernel_matches_plain_on_card(case):
    _cuda_or_skip()
    mc, maps, changes, chroma_full, planes = K2W_CASES[case]
    arrays, cfg_ref = _staged(len(case) + 7, mc, maps, changes,
                              chroma_full, planes)
    cfg, fields, cat = T.inputs_from_reference(cfg_ref, arrays,
                                               device="cuda")
    before = K2W.launches
    got = K2W.wide_words(fields, cat, cfg)
    ref = K2W.wide_words_reference(fields, cat, cfg)
    torch.cuda.synchronize()
    assert K2W.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
