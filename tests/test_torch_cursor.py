"""The cursor compaction experiment of the PyTorch port (K3 and
``tpu_vpcc_torch.tools.compaction_experiment``) against tpu_vpcc's, on the
CPU.

  - K3's plain version (``ops.cursor_compact``) against a numpy model of
    the reference's sequential grid: a loop over the chunks that copies
    each one to its cursor's window.
  - The experiment's variants against ``tools/compaction_experiment.py``
    on the same synthetic 256² frames: ``cursor`` against
    ``run_pallas_cursor`` (its Pallas kernel in interpret mode), byte-equal
    on the covered windows with equal counts; ``nosort`` against
    ``run_nosort`` on every slot; ``full`` and ``full_order`` against
    ``run_full``'s compacted prefixes.

The reference tool is loaded from its file (``tools/`` is no package);
its ``pl`` is given a ``pallas_call`` bound to ``interpret=True``, and
nothing in the file changes. Outputs are integers: no tolerance. The
kernel itself is held against the plain version by the ``cuda``-marked
test, on a card.
"""
import functools
import importlib.util
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vpcc.models import flagship as ref_flagship
from tpu_vpcc_torch.models.flagship import FlagshipConfig, example_batch_inputs
from tpu_vpcc_torch.ops import _build
from tpu_vpcc_torch.ops import cursor_compact as K3
from tpu_vpcc_torch.tools import compaction_experiment as E

ROOT = Path(__file__).resolve().parent.parent
CH = K3.CH


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _sequential_grid(words, valid):
    """The reference's grid, step by step: chunk i copies its CH
    uncompacted elements of each word to the window of its cursor."""
    flat_v = valid.reshape(-1)
    outs = [np.zeros(flat_v.size, np.uint32) for _ in words]
    cursor = 0
    win = 0
    for i in range(flat_v.size // CH):
        win = cursor // CH
        for o, w in zip(outs, words):
            o[win * CH : (win + 1) * CH] = w.reshape(-1)[i * CH : (i + 1) * CH]
        cursor += int(flat_v[i * CH : (i + 1) * CH].sum())
    return outs, cursor, (win + 1) * CH


def _case(F, nc, density, seed):
    r = np.random.default_rng(seed)
    S = nc * CH // F
    words = [r.integers(0, 1 << 32, (F, S), dtype=np.uint32) for _ in range(3)]
    return words, r.random((F, S)) < density


@pytest.mark.parametrize("density", [0.0, 0.3, 0.7, 1.0])
@pytest.mark.parametrize("F,nc", [(1, 1), (1, 7), (2, 1), (2, 5)])
def test_plain_matches_sequential_grid(F, nc, density):
    words, valid = _case(F, nc, density, seed=F * 100 + nc + int(10 * density))
    want, count, covered = _sequential_grid(words, valid)
    before = K3.launches
    *outs, n = K3.cursor_compact(*(_i32(w) for w in words),
                                 torch.from_numpy(valid))
    assert K3.launches == before  # the CPU path runs the plain version
    assert n.dtype == torch.int32 and n.tolist() == [count]
    assert K3.covered_elements(torch.from_numpy(valid)) == covered
    for o, w, ref in zip(outs, words, want):
        assert o.shape == w.shape and o.dtype == torch.int32
        np.testing.assert_array_equal(
            o.numpy().view(np.uint32).reshape(-1)[:covered], ref[:covered])


def test_wrapper_rejects_bad_inputs():
    words, valid = _case(1, 2, 0.5, seed=3)
    w = [_i32(x) for x in words]
    v = torch.from_numpy(valid)
    with pytest.raises(ValueError, match="multiple"):
        K3.cursor_compact(*(x[:, :-1] for x in w), v[:, :-1])
    with pytest.raises(ValueError, match="multiple"):
        K3.cursor_compact(*(x[:, :0] for x in w), v[:, :0])
    with pytest.raises(TypeError):
        K3.cursor_compact(w[0].to(torch.int64), w[1], w[2], v)
    with pytest.raises(TypeError):
        K3.cursor_compact(*w, v.to(torch.int32))
    with pytest.raises(ValueError):
        K3.cursor_compact(w[0][:, : CH], w[1], w[2], v)


@pytest.mark.parametrize("lib", ["cursor_compact", "probes"])
def test_build_without_nvcc_raises(lib, monkeypatch, tmp_path):
    """A kernel library that cannot be built raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    real_exists = _build.Path.exists
    monkeypatch.setattr(
        _build.Path, "exists",
        lambda self: False if self.name == "nvcc" else real_exists(self),
    )
    with pytest.raises(_build.KernelBuildError):
        _build.build(lib)


# ---------------------------------------------------------------------------
# the experiment against tools/compaction_experiment.py
# ---------------------------------------------------------------------------


class _InterpretPallas:
    """The reference's ``pl`` with ``pallas_call`` bound to
    ``interpret=True``."""

    def __init__(self, pl):
        self._pl = pl
        self.pallas_call = functools.partial(pl.pallas_call, interpret=True)

    def __getattr__(self, name):
        return getattr(self._pl, name)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference tool and both sides' inputs: two 256² frames with 8
    patches (seeds 0-1), bucketed and tiled once, handed to both."""
    with pytest.MonkeyPatch.context() as mp:
        # the tool sets a compilation cache directory at import: keep it
        # out of the checkout
        mp.setenv("JAX_COMPILATION_CACHE_DIR",
                  str(tmp_path_factory.mktemp("jax_cache")))
        spec = importlib.util.spec_from_file_location(
            "_ref_compaction_experiment",
            ROOT / "tools" / "compaction_experiment.py",
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert os.environ["JAX_COMPILATION_CACHE_DIR"] != str(
            ROOT / ".jax_cache")
    mod.pl = _InterpretPallas(mod.pl)
    cfg = FlagshipConfig(width=256, height=256, batch=2)
    raw = example_batch_inputs(cfg, occupancy_fill=0.7, n_patches=8)
    fields, cat, pcfg, tiled = E.stage_inputs(raw, cfg.frame_config(), "cpu")
    rcfg = ref_flagship.FlagshipConfig(width=256, height=256,
                                       batch=2).frame_config()
    _, rcfg, _, _ = ref_flagship.bucket_flagship_inputs(raw, rcfg)
    ref_inputs = tuple(jnp.asarray(a) for a in tiled)
    return mod, ref_inputs, rcfg, (fields, cat, pcfg)


def _np(t):
    return np.asarray(t).astype(np.int64)


def test_cursor_variant_matches_pallas_cursor(reference):
    mod, ref_inputs, rcfg, port_inputs = reference
    pos_r, col_r, cnt_r = mod.run_pallas_cursor(*ref_inputs, cfg=rcfg)
    pos, col, cnt = E.run_cursor(*port_inputs)
    F, S = pos.shape[:2]
    assert (F * S) % CH == 0
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_r))
    valid = E.wide_words(*port_inputs)[3]
    covered = K3.covered_elements(valid)
    assert int(cnt[0]) == int(valid.sum()) and covered < F * S
    for a, b in ((pos_r, pos), (col_r, col)):
        assert np.asarray(a).dtype == np.uint16
        np.testing.assert_array_equal(
            b.numpy().reshape(-1, 3)[:covered],
            _np(a).reshape(-1, 3)[:covered],
        )


def test_nosort_variant_matches_reference(reference):
    mod, ref_inputs, rcfg, port_inputs = reference
    ref = mod.run_nosort(*ref_inputs, cfg=rcfg)
    got = E.run_nosort(*port_inputs)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), _np(a))


@pytest.mark.parametrize("variant", ["full", "full_order"])
def test_compacting_variants_match_run_full(reference, variant):
    mod, ref_inputs, rcfg, port_inputs = reference
    pos_r, col_r, cnt_r = mod.run_full(*ref_inputs, cfg=rcfg)
    pos, col, cnt = E.RUNS[variant](*port_inputs)
    counts = np.asarray(cnt_r)
    np.testing.assert_array_equal(cnt.numpy(), counts)
    assert counts.min() > 0
    for f, n in enumerate(counts):
        np.testing.assert_array_equal(pos[f, :n].numpy(), _np(pos_r)[f, :n])
        np.testing.assert_array_equal(col[f, :n].numpy(), _np(col_r)[f, :n])


def test_variant_names():
    assert E.parse_variants("cursor,nosort") == ["cursor", "nosort"]
    for name in ("split8", "megarow", "segsort_8k", "cell_full"):
        with pytest.raises(ValueError, match="TPU workaround"):
            E.parse_variants(f"nosort,{name}")
    with pytest.raises(ValueError, match="named 'cursor'"):
        E.parse_variants("pallas_cursor")
    with pytest.raises(ValueError, match="unknown"):
        E.parse_variants("cursor2")


@pytest.mark.parametrize("floor,ceiling,spread,says", [
    (0.0030, 0.0020, 0.0001, "a single pass cannot beat K1F"),
    (0.0010, 0.0300, 0.0020, "could save at most 0.029000 ms/frame"),
    (-0.0035, -0.0021, 0.0100, "unresolved"),  # the ceiling within it
    (0.0110, 0.0180, 0.0200, "unresolved"),  # the gap within it
    (0.0030, 0.0025, 0.0010, "unresolved"),  # a floor above, within it
    # a floor below 0 is noise: beyond the spread it is the noise
    (-0.001079, 0.000787, 0.000764, "unresolved"),
    (-0.0002, 0.0300, 0.0010, "could save at most 0.030000 ms/frame"),
])
def test_verdict_is_unresolved_within_the_spread(floor, ceiling, spread,
                                                 says):
    line = E.verdict({"floor_ms": floor, "ceiling_ms": ceiling,
                      "spread_ms": spread})
    assert line.startswith("verdict: floor") and says in line


def test_experiment_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        E.main(["1", "1", "cursor"])
    assert E.resolve_device("cpu").type == "cpu"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.3, 0.7, 1.0])
def test_kernel_matches_plain_on_card(density):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")
    for F, nc in ((2, 448), (1, 7), (2, 5)):
        words, valid = _case(F, nc, density, seed=nc)
        w = [_i32(x).cuda() for x in words]
        v = torch.from_numpy(valid).cuda()
        before = K3.launches
        got = K3.cursor_compact(*w, v)
        ref = K3.cursor_compact_reference(*w, v)
        torch.cuda.synchronize()
        assert K3.launches == before + 1
        assert torch.equal(got[3], ref[3])
        covered = K3.covered_elements(v)
        for a, b in zip(got[:3], ref[:3]):
            assert torch.equal(a.reshape(-1)[:covered],
                               b.reshape(-1)[:covered])
