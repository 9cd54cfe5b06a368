"""The Hopper probes P1-P12 of the PyTorch port against tpu_vpcc's Mosaic
probes, on the CPU.

One case per ``pallas_call`` of ``tools/pallas_probe.py``,
``tools/pallas_probe2.py`` and ``tools/pallas_probe3.py`` (14 in all).
Each runs the reference probe function with its module's ``INTERPRET``
set, captures what its ``report`` (and, for P9-P12, its ``run``) got, and
holds the port's probe (``tpu_vpcc_torch.tools.hopper_probe*``, whose
plain versions run on the CPU) against:

  - the probe's numpy ``want``, always;
  - the reference's interpret-mode output, byte for byte, where the
    reference's own check passed there.

Three reference formulations do not pass their check in interpret mode
(P3's repeat-dilate reports FAIL, P5's u32->u16 bitcast and P8 raise);
there the port is held against ``want`` only, and the case pins that the
reference still fails. The kernels themselves are held against the plain
versions by the ``cuda``-marked tests, on a card.
"""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_vpcc_torch.ops import probes
from tpu_vpcc_torch.tools import hopper_probe as H1
from tpu_vpcc_torch.tools import hopper_probe2 as H2
from tpu_vpcc_torch.tools import hopper_probe3 as H3
from tpu_vpcc_torch.tools import kernel_times as KT

ROOT = Path(__file__).resolve().parent.parent
_REFERENCE = {}


def _reference_run(module: str, function: str):
    """Run ``tools/<module>.py::<function>`` in interpret mode (once per
    process); returns ``{name: (got, want)}`` from its ``report`` calls
    and ``{name: out}`` from its ``run`` calls (pallas_probe3)."""
    key = (module, function)
    if key not in _REFERENCE:
        spec = importlib.util.spec_from_file_location(
            f"_ref_{module}", ROOT / "tools" / f"{module}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        reports, runs = {}, {}

        def report(name, got, want):
            reports[name] = (np.asarray(got), np.asarray(want))

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "INTERPRET", True)
            mp.setattr(mod, "report", report)
            if hasattr(mod, "run"):
                real_run = mod.run

                def run(name, *args):
                    runs[name] = real_run(name, *args)
                    return runs[name]

                mp.setattr(mod, "run", run)
            getattr(mod, function)()
        _REFERENCE[key] = (reports, runs)
    return _REFERENCE[key]


_PORT = {}


def _port_cases(fn):
    if fn not in _PORT:
        before = dict(probes.launches)
        _PORT[fn] = {c.name: c for c in fn("cpu")}
        assert probes.launches == before  # the CPU runs the plain versions
    return _PORT[fn]


def _p5_want():
    """``probe_bitcast``'s want (tools/pallas_probe2.py:52-67); the probe
    raises before it reaches it in interpret mode."""
    R = 4
    lo = np.arange(R * 512, dtype=np.uint32).reshape(R, 512) % 60000
    hi = (np.arange(R * 512, dtype=np.uint32).reshape(R, 512) * 7 + 3) % 60000
    want = np.empty((R, 1024), np.uint16)
    want[:, 0::2] = lo.astype(np.uint16)
    want[:, 1::2] = hi.astype(np.uint16)
    return want


def _p8_want():
    """``probe_mini_compact``'s want (tools/pallas_probe2.py:144-203); the
    probe raises before it reaches it in interpret mode."""
    R, L = 4, 512
    P = R * L
    r = np.random.default_rng(0)
    v0 = r.random(P) < 0.6
    v1 = r.random(P) < 0.5
    w0d0 = r.integers(0, 1 << 30, P, dtype=np.uint32)
    w0d1 = r.integers(0, 1 << 30, P, dtype=np.uint32)
    inter = np.empty(2 * P, np.uint32)
    inter[0::2] = w0d0
    inter[1::2] = w0d1
    vv = np.empty(2 * P, bool)
    vv[0::2] = v0
    vv[1::2] = v1
    return inter[vv]


_P2_NAMES = [f"P2 flat shift {k}" for k in (1, 2, 4, 32, 127, 128, 256, 1024)]
_P6_NAMES = [f"P6 u16 flat shift {k} @ lanes=1024"
             for k in (1, 5, 1023, 1024, 4096)]

# case: (reference module, function, port function, port names, reference
# name override, what the reference does in interpret mode, the
# reference's want where it never reaches its report)
CASES = {
    "P1": ("pallas_probe", "probe_rolls", H1.probe_rolls,
           ["P1 lane roll -3", "P1 row roll -2"], None, "ok", None),
    "P2": ("pallas_probe", "probe_flat_shift", H1.probe_flat_shift,
           _P2_NAMES, None, "ok", None),
    "P3-stack": ("pallas_probe", "probe_interleave", H1.probe_interleave,
                 ["P3 stack-reshape interleave"], None, "ok", None),
    "P3-dilate": ("pallas_probe", "probe_interleave", H1.probe_interleave,
                  ["P3 repeat-dilate interleave"], None, "fail", None),
    "P4": ("pallas_probe", "probe_dyn_dma", H1.probe_dyn_dma,
           ["P4 dyn-offset DMA"], None, "ok", None),
    "P5-split": ("pallas_probe2", "probe_bitcast", H2.probe_bitcast,
                 ["P5 bitcast u32->u16 interleave order"], None, "raises",
                 _p5_want),
    "P5-roundtrip": ("pallas_probe2", "probe_bitcast", H2.probe_bitcast,
                     ["P5 bitcast roundtrip"], None, "ok", None),
    "P6": ("pallas_probe2", "probe_wide_u16", H2.probe_wide_u16,
           _P6_NAMES, None, "ok", None),
    "P7": ("pallas_probe2", "probe_dynamic_roll", H2.probe_dynamic_roll,
           ["P7 dynamic lane roll"], None, "ok", None),
    "P8": ("pallas_probe2", "probe_mini_compact", H2.probe_mini_compact,
           ["P8 mini shift-compact (prefix)"], None, "raises", _p8_want),
    "P9": ("pallas_probe3", "main", H3.probe_interleave,
           ["P9 minor-dim interleave reshape"], None, "ok", None),
    "P10": ("pallas_probe3", "main", H3.probe_repeat,
            ["P10 pltpu.repeat tile-concat"], "P10", "run", None),
    "P11": ("pallas_probe3", "main", H3.probe_rev,
            ["P11 lax.rev lanes"], None, "ok", None),
    "P12": ("pallas_probe3", "main", H3.probe_interleave16,
            ["P12 u16 interleave reshape"], None, "ok", None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_probe_matches_reference(case):
    module, function, port_fn, names, ref_name, kind, ref_want = CASES[case]
    reports, runs = _reference_run(module, function)
    port = _port_cases(port_fn)
    for name in names:
        c = port[name]
        # the probe's want, always
        assert c.got.shape == c.want.shape
        np.testing.assert_array_equal(c.got, c.want)
        if kind == "raises":
            # the reference's formulation raised in interpret mode before
            # its report: the port is held against the probe's want only
            assert name not in reports
            np.testing.assert_array_equal(c.want, ref_want())
        elif kind == "fail":
            # the reference's formulation fails its own check in
            # interpret mode: the port is held against the want only
            got, want = reports[name]
            np.testing.assert_array_equal(c.want, want)
            assert got.shape == want.shape and not np.array_equal(got, want)
        elif kind == "run":
            # P10 prints a semantics verdict, not a report: its output is
            # the tile-concat the port computes
            np.testing.assert_array_equal(c.got, np.asarray(runs[ref_name]))
        else:
            got, want = reports[name]
            np.testing.assert_array_equal(c.want, want)
            np.testing.assert_array_equal(want, got)  # the reference: OK
            assert c.got.dtype == got.dtype
            np.testing.assert_array_equal(c.got, got)


def test_cpu_call_is_plain_and_uncounted():
    x = torch.arange(64 * 8, dtype=torch.int32).reshape(8, 64)
    before = dict(probes.launches)
    assert torch.equal(probes.call("P11", x), torch.flip(x, (1,)))
    assert torch.equal(probes.call("P1", x, 3, 1), torch.roll(x, 3, 1))
    assert torch.equal(probes.call("P5", x, torch.int16),
                       x.view(torch.int16))
    assert probes.launches == before
    with pytest.raises(ValueError, match="unknown probe"):
        probes.call("P13", x)


@pytest.mark.parametrize("shape", H3.EDGE_SHAPES,
                         ids=[f"R{r}-L{n}" for r, n in H3.EDGE_SHAPES])
def test_p10_p11_edge_shapes(shape):
    R, L = shape
    for fn in (H3.probe_repeat, H3.probe_rev):
        c = fn("cpu", R=R, L=L)[0]
        assert c.got.shape == c.want.shape
        np.testing.assert_array_equal(c.got, c.want)


def _first_case(probe):
    """The first case of ``probe`` at its own shape, on the CPU."""
    return next(c for mod in (H1, H2, H3) for fn in mod.PROBE_FUNCTIONS
                for c in _port_cases(fn).values() if c.probe == probe)


@pytest.mark.parametrize("probe", probes.PROBES)
def test_library_call_computes_the_probe(probe):
    """``kernel_times.library_call``, the one PyTorch call timed beside a
    probe's kernel, computes what the plain version computes; P4 and P8
    have none, and say why."""
    c = _first_case(probe)
    lib = KT.library_call(c)
    if probe in KT.NO_LIBRARY:
        assert lib is None
        return
    want = probes.plain(c.probe, *c.args)
    got = lib()
    assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("probe", probes.PROBES)
def test_probe_bytes(probe):
    """Each input byte read once, each output byte written once, at every
    probe's 64 MiB shape's arithmetic (checked here at the probe's own)."""
    c = _first_case(probe)
    out = probes.plain(c.probe, *c.args)
    n_out = out.numel() * out.element_size()
    ins = [a for a in c.args if isinstance(a, torch.Tensor)]
    n_in = sum(a.numel() * a.element_size() for a in ins)
    if probe == "P4":  # offsets [0, 1, 3, 4], 2-row steps: rows 0-5 read
        x, offs, out_rows = c.args
        n_in = offs.numel() * 4 + 6 * x.shape[2] * 4
    assert KT.probe_bytes(c) == n_in + n_out


def test_p4_last_step_wins_out_of_order():
    """Offsets that are not in order still apply in step order."""
    x = torch.arange(3 * 2 * 4, dtype=torch.int32).reshape(3, 2, 4)
    offs = torch.tensor([3, 0, 2], dtype=torch.int32)
    out = probes.call("P4", x, offs, 6)
    want = torch.zeros((6, 4), dtype=torch.int32)
    for i, o in enumerate(offs.tolist()):
        want[o : o + 2] = x[i] + 1000 * i
    assert torch.equal(out, want)
    assert out[3].tolist() == (x[2, 1] + 2000).tolist()


def test_p8_segments_compact_independently():
    c = H2.probe_mini_compact("cpu", n_seg=3)[0]
    np.testing.assert_array_equal(c.got, c.want)
    assert c.got.size > 3 * 2048


#: P4's, P5's and P8's edge shapes, shared with the card's checks:
#: (probe, fn) by label
_EDGES = {where: (probe, fn) for probe, where, fn in KT.edge_cases()}


def _edges_of(probe):
    return sorted(w for w, (p, _) in _EDGES.items() if p == probe)


_P8_EDGES = _edges_of("P8")
_P4_EDGES = _edges_of("P4")
_P5_EDGES = _edges_of("P5")


def _halves(words):
    """u32 words as their u16 stream: slot 2w the low half of word w,
    slot 2w + 1 the high half."""
    w = np.asarray(words, np.uint32).reshape(-1)
    return np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(-1)


@pytest.mark.parametrize("where", _P8_EDGES)
def test_p8_plain_whole_segments(where):
    """P8's plain version over whole segments, tails included, against
    the rule stated in numpy: copy every slot's value, then write each
    moving slot's value to slot - shift, inside its own segment."""
    seg_words, n_seg = (int(t.split("=")[1]) for t in where.split())
    alo, ahi, shc, want = H2.mini_compact_inputs(1, seg_words, n_seg)
    values = _halves(alo) | (_halves(ahi) << 16)
    s = _halves(shc).astype(np.int64)
    moving = np.flatnonzero(s)
    dest = moving - s[moving]
    n = 2 * seg_words
    assert np.array_equal(dest // n, moving // n)  # shifts stay inside
    assert np.unique(dest).size == dest.size  # and never collide
    rule = values.copy()
    rule[dest] = values[moving]
    args = [torch.from_numpy(a.view(np.int32)) for a in (alo, ahi, shc)]
    got = probes.plain("P8", *args, seg_words)
    assert got.shape == (n_seg, n)
    got = got.numpy().view(np.uint32).reshape(-1)
    np.testing.assert_array_equal(got, rule)
    for seg, w in zip(got.reshape(n_seg, n), want):
        np.testing.assert_array_equal(seg[: w.size], w)


def _p4_rule(x, offs, out_rows):
    """P4 stated row by row: each output row holds the row of the last
    step that covers it, plus 1000 * step, or zeros."""
    x, offs = np.asarray(x), np.asarray(offs, np.int64)
    r = np.arange(out_rows)[:, None]
    covers = (offs <= r) & (r < offs + x.shape[1])
    owner = np.where(covers.any(1),
                     x.shape[0] - 1 - np.argmax(covers[:, ::-1], 1), -1)
    out = np.zeros((out_rows, x.shape[2]), np.int32)
    hit = owner >= 0
    own = owner[hit]
    out[hit] = x[own, np.flatnonzero(hit) - offs[own]] + 1000 * own[:, None]
    return out, hit


#: P4 at hand-made offsets: (offs, step rows, L)
_P4_CASES = {
    "unsorted": ([5, 0, 3, 1], 2, 4),
    "gap": ([0, 6], 2, 4),
    "repeated": ([2, 2, 0, 2], 3, 4),
    "ragged-L5": ([0, 1, 3], 2, 5),
}


@pytest.mark.parametrize("where", sorted(_P4_CASES) + _P4_EDGES)
def test_p4_plain_every_row(where):
    """P4's plain version over every output row, uncovered ones included,
    against the rule stated row by row: unsorted offsets, a gap no step
    covers (zeros), repeated offsets (the later step wins), widths that
    are no multiple of four, and the edge shapes the card checks."""
    if where in _P4_CASES:
        offs, rows, L = _P4_CASES[where]
        x = np.arange(len(offs) * rows * L, dtype=np.int32).reshape(
            len(offs), rows, L)
        out_rows = max(offs) + rows + 2
        args = (torch.from_numpy(x), torch.tensor(offs, dtype=torch.int32),
                out_rows)
    else:
        args = _EDGES[where][1]("cpu", probes.plain)[0].args
    got = probes.plain("P4", *args).numpy()
    want, covered = _p4_rule(args[0].numpy(), args[1].numpy(), args[2])
    np.testing.assert_array_equal(got, want)
    assert not covered[-2:].any()  # two rows past the last step: zeros
    if where == "gap":
        assert not covered[2:6].any() and covered[:2].all()
    if where == "repeated":  # step 3 wins rows 2-4 over steps 0 and 1
        np.testing.assert_array_equal(got[2:5], args[0][3].numpy() + 3000)


def test_tools_run_on_cpu_and_stay_jax_free():
    """The four tool entry points with ``--device cpu`` (the experiment at
    256²): exit 0, the report and JSON lines, and no jax or tpu_vpcc in the
    process."""
    script = """
import runpy, sys
for argv in (["hopper_probe", "--device", "cpu"],
             ["hopper_probe2", "--device", "cpu"],
             ["hopper_probe3", "--device", "cpu"],
             ["compaction_experiment", "2", "1", "--device", "cpu",
              "--size", "256", "--patches", "8"]):
    sys.argv = argv
    try:
        runpy.run_module("tpu_vpcc_torch.tools." + argv[0],
                         run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, (argv, e.code)
mods = sorted(m for m in sys.modules
              if m.startswith("jax") or m.split(".")[0] == "tpu_vpcc")
assert not mods, mods
print("JAX_FREE")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "JAX_FREE" in out
    assert "FAIL" not in out
    for line in ("P1 lane roll -3: OK", "P4 dyn-offset DMA: OK",
                 "P5 bitcast u32->u16 interleave order: OK",
                 "P8 mini shift-compact (prefix): OK",
                 "P10 pltpu.repeat tile-concat: OK",
                 "P12 u16 interleave reshape: OK"):
        assert line in out
    assert out.count(": OK") == 13 + 9 + 4
    assert '"floor_ms"' in out and '"ceiling_ms"' in out
    assert '"total_points_check": 60726' in out
    assert "verdict: floor" in out


def test_tools_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (H1, H2, H3):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mod.main([])


def test_edge_cases_name_their_probe():
    """Every edge entry names the probe its cases run, and P5's sizes are
    the seven of ``hopper_probe2.REINTERPRET_EDGES``."""
    for where, (probe, fn) in _EDGES.items():
        assert {c.probe for c in fn("cpu", probes.plain)} == {probe}, where
    assert len(_P5_EDGES) == len(H2.REINTERPRET_EDGES) == 7


@pytest.mark.parametrize("direction", ["split", "join"])
@pytest.mark.parametrize("shape", H2.REINTERPRET_EDGES,
                         ids=[f"nbytes={4 * r * n}"
                              for r, n in H2.REINTERPRET_EDGES])
def test_p5_plain_edge_shapes(shape, direction):
    """P5's plain version at its edge sizes, in both directions, against
    numpy's ``.view`` of the same bytes."""
    R, L = shape
    words = np.random.default_rng(L).integers(
        0, 1 << 32, (R, L), dtype=np.uint64).astype(np.uint32).view(np.int32)
    x = words if direction == "split" else words.view(np.int16)
    dtype, want = ((torch.int16, x.view(np.int16)) if direction == "split"
                   else (torch.int32, x.view(np.int32)))
    got = probes.plain("P5", torch.from_numpy(x), dtype)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_p5_edge_sizes_around_the_kernel():
    """P5's edge sizes sit where the kernel changes course: below a
    16-byte vector, around one block's 16 KB, and one wave of resident
    blocks on every SM of an H100 plus three words."""
    block = probes.REINTERPRET_BLOCK_THREADS * probes.REINTERPRET_VECTORS * 4
    wave = H2.H100_SMS * H2.REINTERPRET_BLOCKS_PER_SM * block
    assert block == 4096 and H2.REINTERPRET_BLOCKS_PER_SM == 8
    assert [L for _, L in H2.REINTERPRET_EDGES] == [
        1, 3, 5, block - 4, block, block + 1, wave + 3]


def test_p5_constants_match_the_kernel():
    """``ops/probes.py``'s P5 constants are the ones ``csrc/probes.cu``
    is built with."""
    src = (ROOT / "tpu_vpcc_torch" / "csrc" / "probes.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([0-9]+);",
                             src).group(1))

    assert const("kCopyVectors") == probes.REINTERPRET_VECTORS
    assert const("kThreads") == probes.REINTERPRET_BLOCK_THREADS


def test_p5_is_one_launch_of_its_own_kernel():
    """P5's entry point launches ``vec_copy_kernel`` once, whatever the
    size, and neither it nor the kernel moves bytes through a library
    call."""
    src = (ROOT / "tpu_vpcc_torch" / "csrc" / "probes.cu").read_text()

    def body(start):
        text = src[src.index(start):]
        return text[:text.index("\n}\n")]

    entry = body("int probe_reinterpret(")
    kernel = body("vec_copy_kernel(const uint4*")
    assert entry.count("<<<") == 1 and "vec_copy_kernel<<<" in entry
    for text in (entry, kernel):
        for call in ("cudaMemcpy", "cuMemcpy", "cub::", "thrust::"):
            assert call not in text


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("tool", ["hopper_probe", "hopper_probe2",
                                  "hopper_probe3"])
def test_kernels_match_plain_on_card(tool):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")
    mod = {"hopper_probe": H1, "hopper_probe2": H2, "hopper_probe3": H3}[tool]
    before = sum(probes.launches[p] for p in probes.LIBRARIES[tool])
    kernel = [c for fn in mod.PROBE_FUNCTIONS for c in fn("cuda")]
    torch.cuda.synchronize()
    assert sum(probes.launches[p] for p in probes.LIBRARIES[tool]) > before
    plain = [c for fn in mod.PROBE_FUNCTIONS
             for c in fn("cuda", probes.plain)]
    for k, p in zip(kernel, plain):
        np.testing.assert_array_equal(k.got, k.want)
        np.testing.assert_array_equal(k.got, p.got)
    # P4 and P8 also over the whole output
    assert not KT.mismatches(kernel, plain, "probe shape")


@pytest.mark.cuda
@pytest.mark.parametrize("where", sorted(_P4_EDGES + _P8_EDGES))
def test_p4_p8_edge_shapes_on_card(where):
    """P4 and P8 at their edge shapes: the kernel's whole output equal to
    the plain version's, and to a second call's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")
    probe, fn = _EDGES[where]
    before = probes.launches[probe]
    kernel = fn("cuda", probes.call)
    torch.cuda.synchronize()
    assert probes.launches[probe] == before + 1
    plain = fn("cuda", probes.plain)
    assert not KT.mismatches(kernel, plain, where, twice=True)


@pytest.mark.cuda
@pytest.mark.parametrize("where", _P5_EDGES)
def test_p5_edge_shapes_on_card(where):
    """P5 at its edge sizes, in both directions: one counted launch a
    call, the whole output equal to the plain version's and to a second
    call's, and one kernel record on the card a call (no memcpy or
    memset)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")
    probe, fn = _EDGES[where]
    before = probes.launches["P5"]
    kernel = fn("cuda", probes.call)
    torch.cuda.synchronize()
    assert probes.launches["P5"] == before + len(kernel) == before + 2
    plain = fn("cuda", probes.plain)
    assert not KT.mismatches(kernel, plain, where, twice=True)
    for c in kernel:
        split = KT.device_split_ms(lambda c=c: probes.call("P5", *c.args))
        names = [KT.short_name(n) for n in split]
        assert len(names) == 1 and "Memset" not in names[0] \
            and "Memcpy" not in names[0], split


@pytest.mark.cuda
@pytest.mark.parametrize("shape", H3.EDGE_SHAPES,
                         ids=[f"R{r}-L{n}" for r, n in H3.EDGE_SHAPES])
def test_p10_p11_edge_shapes_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")
    R, L = shape
    for fn, probe in ((H3.probe_repeat, "P10"), (H3.probe_rev, "P11")):
        before = probes.launches[probe]
        k = fn("cuda", R=R, L=L)[0]
        torch.cuda.synchronize()
        assert probes.launches[probe] == before + 1
        p = fn("cuda", probes.plain, R=R, L=L)[0]
        np.testing.assert_array_equal(k.got, k.want)
        np.testing.assert_array_equal(k.got, p.got)


_SPIN = {"spin": [500.0, 500.0]}
_ONE = {"spin": [500.0, 500.0], "scan": [2.0], "memset": [1.0]}


def _many(calls, scan=None, memset=None, spin=2, extra=None):
    d = {"spin": [500.0] * spin,
         "scan": [2.0] * (calls if scan is None else scan),
         "memset": [1.0] * (calls if memset is None else memset)}
    d.update(extra or {})
    return {n: v for n, v in d.items() if v}


@pytest.mark.parametrize("spin", [2, 1, 0], ids=["spins", "one-spin-lost",
                                                  "spins-lost"])
def test_whole_trace_time_leaves_out_the_spins(spin):
    """A whole trace gives the calls' own device time per call, whether
    or not the spins around the calls survived in it."""
    split = KT.trace_split_ms(_SPIN, _ONE, _many(20, spin=spin), 20)
    assert sum(split.values()) == 3.0 / 1e3


@pytest.mark.parametrize("many", [
    _many(20, scan=19),                  # one launch lost
    _many(20, memset=0),                 # every launch of one name lost
    _many(20, scan=0, memset=0),         # all of the calls' work lost
    _many(20, spin=1, scan=17, memset=17),  # the first calls lost
    _many(20, extra={"other": [4.0]}),   # work that is not the calls'
    _many(20, scan=40),                  # twice as many of one name
], ids=["one-lost", "name-lost", "all-lost", "start-lost", "extra",
        "doubled"])
def test_trace_that_is_not_whole_raises(many):
    """``kernel_times`` takes a device-only time only from a whole trace:
    each name of one call's trace, exactly as many times as the calls."""
    with pytest.raises(KT.TimingError):
        KT.trace_split_ms(_SPIN, _ONE, many, 20)


@pytest.mark.parametrize("spins,one", [
    ({}, _ONE),                          # the spins' trace lost its work
    (_SPIN, dict(_SPIN)),                # one call put nothing on the card
    (_SPIN, {"spin": [500.0], "scan": [2.0]}),  # one call lost a name
], ids=["no-spins", "no-work", "one-call-lost-a-name"])
def test_reference_traces_must_be_whole(spins, one):
    with pytest.raises(KT.TimingError):
        KT.trace_split_ms(spins, one, _many(20), 20)


def test_trace_split_gives_each_name_its_time_per_call():
    """The per-name split of a whole trace: each name's durations over
    the calls, per call."""
    split = KT.trace_split_ms(_SPIN, _ONE, _many(20), 20)
    assert split == {"scan": 2.0 / 1e3, "memset": 1.0 / 1e3}
    uneven = _many(20, extra={"scan": [1.0, 3.0] * 20,
                              "memset": [0.5] * 20})
    one = {"spin": [500.0], "scan": [1.0, 3.0], "memset": [0.5]}
    assert KT.trace_split_ms(_SPIN, one, uneven, 20) == {
        "scan": 4.0 / 1e3, "memset": 0.5 / 1e3}
    with pytest.raises(KT.TimingError):
        KT.trace_split_ms(_SPIN, _ONE, _many(20, scan=19), 20)


def _measured(ms, queued=0.1, bound=0.05):
    return {"ms": ms, "queued_ms": queued, "bound_ms": bound}


@pytest.mark.parametrize("ms,ok", [
    (0.05, True),     # at the bound
    (0.105, True),    # at the queued time's slack
    (0.0499, False),  # below the bound: work missed or the bound wrong
    (0.106, False),   # above the slack: a trace ran long
])
def test_check_measured(ms, ok):
    if ok:
        KT.check_measured(_measured(ms))
    else:
        with pytest.raises(KT.TimingError):
            KT.check_measured(_measured(ms))


@pytest.mark.parametrize("times,tries", [
    ([0.08], 1),
    ([0.12, 0.08], 2),
    ([0.04, 0.12, 0.08], 3),
    ([0.12, 0.12, 0.12, 0.08], None),  # three failed: given up
], ids=["first", "second", "third", "given-up"])
def test_measure_takes_a_failed_measurement_anew(monkeypatch, times, tries):
    """``measure`` takes a measurement that fails ``check_measured``
    again, up to ``MEASURE_TRIES`` in all, and says how many it took."""
    left = iter(times)
    monkeypatch.setattr(KT, "_measure_once", lambda *a: (
        _measured(next(left)), " traces"))
    if tries is None:
        with pytest.raises(KT.TimingError, match="try 3: .* traces"):
            KT.measure(None, None)
        assert next(left) == 0.08  # no fourth measurement
    else:
        out = KT.measure(None, None)
        assert (out["ms"], out["tries"]) == (0.08, tries)


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::count_kernel<true>(unsigned char const*, "
     "long, long, int, int*)", "count_kernel<true>"),
    ("(anonymous namespace)::scan_kernel(int const*, int, int*, int*)",
     "scan_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4>(int)",
     "vectorized_elementwise_kernel<4>"),
    ("Memset (Device)", "Memset"),
    ("compact_kernel", "compact_kernel"),
])
def test_short_record_names(name, short):
    assert KT.short_name(name) == short


@pytest.mark.parametrize("kernel,library,verdict", [
    ([0.0459, 0.0457, 0.0460], [0.0457, 0.0458, 0.0456], "tie"),
    ([0.0500, 0.0501, 0.0502], [0.0457, 0.0458, 0.0456], "library faster"),
    ([0.0400, 0.0401, 0.0402], [0.0457, 0.0458, 0.0456], "kernel faster"),
], ids=["tie", "library", "kernel"])
def test_verdict_against_the_library_call(kernel, library, verdict):
    """``--repeats``: a kernel and its library call differ only by more
    than the larger of their two ranges."""
    v = KT.verdict(kernel, library)
    assert v["verdict"] == verdict
    assert (v["kernel_ms"], v["library_ms"]) == (sorted(kernel)[1], 0.0457)
    assert v["spread_ms"] == pytest.approx(
        max(max(kernel) - min(kernel), max(library) - min(library)))
