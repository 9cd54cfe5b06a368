"""Compaction K1 of the PyTorch port (tpu_vpcc_torch.ops.shift_compact).

The plain PyTorch version is held against tpu_vpcc's Pallas kernel
(``shift_compact_ops(..., interpret=True)``, as tests/test_shift_compact.py
runs it on the CPU) and against the narrow unique-key sort's prefix with
the patch-order emission index. Outputs are integer bit patterns, so
every comparison is exact, and only up to each frame's count: the tail
past it is unspecified on both sides. The CUDA kernel itself is held
against the plain version by the ``cuda``-marked test, on a card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_vpcc.ops.shift_compact import shift_compact_ops as jax_shift_compact_ops
from tpu_vpcc.ops.tiled import _narrow_sort_ops
from tpu_vpcc_torch.ops import _build
from tpu_vpcc_torch.ops import shift_compact as sc


def _words(F, S, density, pack30, seed):
    r = np.random.default_rng(seed)
    w0 = r.integers(0, 1 << 32, (F, S), dtype=np.uint32)
    wc = r.integers(0, 1 << 32, (F, S), dtype=np.uint32)
    zs = None if pack30 else r.integers(0, 1 << 16, (F, S), dtype=np.uint16)
    valid = r.random((F, S)) < density
    return w0, zs, wc, valid


def _port(w0, zs, wc, valid):
    """Run the port on numpy words; outputs back as u32/u16 arrays."""
    ops, counts = sc.shift_compact_ops(
        torch.from_numpy(w0.view(np.int32)),
        None if zs is None else torch.from_numpy(zs.view(np.int16)),
        torch.from_numpy(wc.view(np.int32)),
        torch.from_numpy(valid),
    )
    dt = [np.uint32] + ([] if zs is None else [np.uint16]) + [np.uint32]
    return [o.numpy().view(d) for o, d in zip(ops, dt)], counts.numpy()


def _assert_prefixes(ref_ops, ref_counts, ops, counts, valid):
    np.testing.assert_array_equal(counts, ref_counts)
    np.testing.assert_array_equal(counts, valid.sum(axis=1))
    assert len(ops) == len(ref_ops)
    for a, b in zip(ref_ops, ops):
        a = np.asarray(a)
        assert a.dtype == b.dtype
        for f, n in enumerate(counts):
            np.testing.assert_array_equal(a[f, :n], b[f, :n])


#: (F, S, extent) at the edges of the kernel's 4,096-pixel tiles that the
#: Pallas kernel also takes (S a multiple of its extent): the first case,
#: one tile, three tiles in three frames, and 36 tiles (the look-back
#: passes a warp's 32 status words)
PALLAS_EDGES = {
    "2x16384": (2, 16384, 8192),
    "one-tile": (1, 8192, 8192),
    "F3-3-tiles": (3, 24576, 8192),
    "36-tiles": (1, 294912, 16384),
}


@pytest.mark.parametrize("edge", sorted(PALLAS_EDGES))
@pytest.mark.parametrize("pack30", [True, False])
def test_plain_matches_pallas_kernel(pack30, edge):
    F, S, extent = PALLAS_EDGES[edge]
    w0, zs, wc, valid = _words(F, S, 0.6, pack30, seed=5 + pack30)
    ref_ops, ref_counts = jax_shift_compact_ops(
        jnp.asarray(w0), None if zs is None else jnp.asarray(zs),
        jnp.asarray(wc), jnp.asarray(valid), F, S, extent=extent,
        interpret=True,
    )
    ops, counts = _port(w0, zs, wc, valid)
    _assert_prefixes(ref_ops, np.asarray(ref_counts), ops, counts, valid)


def _patch_order_emi(F, S):
    iota = np.arange(S // 2, dtype=np.uint32)
    return np.concatenate([2 * iota, 2 * iota + 1])[None, :].repeat(F, 0)


def _valid_pattern(kind, F, S, r):
    half = S // 2
    v = np.zeros((F, S), bool)
    if kind == "all":
        v[:] = True
    elif kind == "d0_only":
        v[:, :half] = True
    elif kind == "d1_only":
        v[:, half:] = True
    elif kind == "alternating":
        v[:, ::2] = True
    elif kind == "last_slot":
        v[:, -1] = True
    elif kind == "first_pixel_pair":
        v[:, [0, half]] = True
    elif kind != "none":
        v[:] = r.random((F, S)) < float(kind)
    return v


@pytest.mark.parametrize("F", [1, 2, 3])
@pytest.mark.parametrize("kind", [
    "none", "all", "d0_only", "d1_only", "alternating", "last_slot",
    "first_pixel_pair", "0.05", "0.3", "0.7", "0.97",
])
def test_plain_matches_sort_prefix(F, kind):
    S = 2 * 3000  # not a multiple of any tile or chunk
    r = np.random.default_rng(F * 101 + len(kind))
    for pack30 in (True, False):
        w0, zs, wc, _ = _words(F, S, 0.5, pack30, seed=F)
        valid = _valid_pattern(kind, F, S, r)
        ref_ops = _narrow_sort_ops(
            jnp.asarray(w0), None if zs is None else jnp.asarray(zs),
            jnp.asarray(wc), jnp.asarray(valid),
            jnp.asarray(_patch_order_emi(F, S)), F, S,
        )
        ops, counts = _port(w0, zs, wc, valid)
        _assert_prefixes(ref_ops, valid.sum(axis=1), ops, counts, valid)


#: pixels per frame at the edges of the kernel's 4,096-pixel tiles that
#: no Pallas extent divides: one tile plus one pixel, and three tiles
#: plus three (neither a multiple of the kernel's 16-byte validity vector)
RAGGED_EDGES = {"one-tile+1": 4097, "3-tiles+3": 8963}


@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("edge", sorted(RAGGED_EDGES))
def test_plain_matches_sort_prefix_at_ragged_edges(edge, F):
    S = 2 * RAGGED_EDGES[edge]
    r = np.random.default_rng(S + F)
    for pack30 in (True, False):
        w0, zs, wc, _ = _words(F, S, 0.5, pack30, seed=S)
        valid = r.random((F, S)) < 0.6
        ref_ops = _narrow_sort_ops(
            jnp.asarray(w0), None if zs is None else jnp.asarray(zs),
            jnp.asarray(wc), jnp.asarray(valid),
            jnp.asarray(_patch_order_emi(F, S)), F, S,
        )
        ops, counts = _port(w0, zs, wc, valid)
        _assert_prefixes(ref_ops, valid.sum(axis=1), ops, counts, valid)


def test_cpu_path_is_plain_and_uncounted():
    w0, zs, wc, valid = _words(2, 512, 0.5, False, seed=1)
    args = (torch.from_numpy(w0.view(np.int32)),
            torch.from_numpy(zs.view(np.int16)),
            torch.from_numpy(wc.view(np.int32)), torch.from_numpy(valid))
    before = sc.launches
    ops, counts = sc.shift_compact_ops(*args)
    ref_ops, ref_counts = sc.shift_compact_ops_reference(*args)
    assert sc.launches == before
    assert torch.equal(counts, ref_counts)
    for a, b in zip(ops, ref_ops):
        for f, n in enumerate(counts.tolist()):
            assert torch.equal(a[f, :n], b[f, :n])


def test_wrapper_rejects_bad_inputs():
    w0, zs, wc, valid = _words(1, 64, 0.5, False, seed=2)
    i32 = torch.from_numpy(w0.view(np.int32))
    i16 = torch.from_numpy(zs.view(np.int16))
    ok = torch.from_numpy(wc.view(np.int32))
    v = torch.from_numpy(valid)
    with pytest.raises(TypeError):
        sc.shift_compact_ops(i32.to(torch.int64), i16, ok, v)
    with pytest.raises(TypeError):
        sc.shift_compact_ops(i32, i16.to(torch.int32), ok, v)
    with pytest.raises(ValueError):
        sc.shift_compact_ops(i32[:, :32], i16, ok, v)
    with pytest.raises(ValueError):
        sc.shift_compact_ops(i32[:, :63], i16[:, :63], ok[:, :63], v[:, :63])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    real_exists = _build.Path.exists
    monkeypatch.setattr(
        _build.Path, "exists",
        lambda self: False if self.name == "nvcc" else real_exists(self),
    )
    with pytest.raises(_build.KernelBuildError):
        _build.build("shift_compact")


def test_edge_extents_reach_each_edge():
    """The edges the card tests and ``chip_smoke.py`` take, at the
    kernel's tile: one tile and one past it, a partial last tile, more
    tiles than a warp's look-back window, and extents the 16-byte
    validity vector does not divide; the CPU parity tests' ragged
    extents are among them."""
    tile = 4096
    edges = sc.edge_extents(tile)
    assert edges["one tile"] == tile and edges["one tile + 1"] == tile + 1
    assert edges["3 tiles, last partial"] % tile
    assert -(-edges["3 tiles, last partial"] // tile) == 3
    assert -(-edges["33 tiles + 256"] // tile) > 32
    assert sum(n % 16 != 0 for n in edges.values()) == 2
    assert set(RAGGED_EDGES.values()) <= set(edges.values())


@pytest.mark.cuda
@pytest.mark.parametrize("pack30", [True, False])
def test_kernel_matches_plain_on_card(pack30):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")
    # the kernel's edges (one tile, one past it, a partial last tile, 33
    # tiles, a ragged extent) in one and three frames, and the flagship's
    edges = [(F, 2 * half) for half in sc.edge_extents(sc.tile_items())
             .values() for F in (1, 3)] + [(2, 1835008)]
    cases = [(F, S, d) for F, S in edges for d in (0.0, 0.3, 0.7, 1.0)]
    for F, S, density in cases:
        w0, zs, wc, valid = (
            None if a is None else torch.from_numpy(
                a.view({np.uint32: np.int32, np.uint16: np.int16}.get(
                    a.dtype.type, a.dtype))
            ).cuda()
            for a in _words(F, S, density, pack30, seed=S)
        )
        before = sc.launches
        got, n_got = sc.shift_compact_ops(w0, zs, wc, valid)
        again, n_again = sc.shift_compact_ops(w0, zs, wc, valid)
        ref, n_ref = sc.shift_compact_ops_reference(w0, zs, wc, valid)
        torch.cuda.synchronize()
        assert sc.launches == before + 2
        assert torch.equal(n_got, n_ref) and torch.equal(n_again, n_ref)
        for a, b, c in zip(got, again, ref):
            for f, n in enumerate(n_ref.tolist()):
                assert torch.equal(a[f, :n], c[f, :n])
                assert torch.equal(b[f, :n], c[f, :n])

