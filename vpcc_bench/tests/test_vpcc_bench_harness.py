"""The harness end to end on the CPU, at the tiny deployment: the result
line's form, what a run loads, the refusal without a card, and that the
program keeps no state between GOFs of the same content."""

import json
import subprocess
import sys

import pytest

from vpcc_bench import adapter, check, gen, run
from vpcc_bench.registry import ROOT
from vpcc_bench.tests.conftest import tiny_root

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell,trace", [("narrow_gof32_max", False),
                                        ("smooth_gof32_max", True),
                                        ("narrow_live30", False),
                                        ("narrow_live30", True)])
def test_result_line(tiny_bench, cell, trace):
    r = run.run_cell(tiny_bench, cell, 3_000_000_017, 0.6, trace,
                     device="cpu")
    want = KEYS | ({"breakdown"} if trace else set())
    assert set(r) == want
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 4
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in tiny_bench.metrics(cell, kind)}
    assert set(r["metrics"]) <= allowed
    if not trace:
        assert set(r["metrics"]) == allowed
        assert all(v["value"] > 0 for v in r["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert r["checks"] == {"frames_wrong": {"value": 0, "limit": 0},
                           "frames_missing": {"value": 0, "limit": 0}}
    json.dumps(r)


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """In a fresh interpreter, a whole run loads no module whose
    top-level name is jax, jaxlib, flax or tpu_vpcc, compared whole."""
    root = tiny_root(tmp_path)
    code = (
        "import sys, json\n"
        "from vpcc_bench.registry import Bench, HERE\n"
        "from vpcc_bench import run\n"
        f"b = Bench({str(root)!r}, HERE)\n"
        "r = run.run_cell(b, 'narrow_gof32_max', 5, 0.5, True, device='cpu')\n"
        "print(json.dumps({'correct': r['correct'],"
        " 'banned': run.banned_modules(),"
        " 'port': 'tpu_vpcc_torch' in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "banned": [], "port": True}


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_vpcc_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_vpcc.ops", sys)
    assert run.banned_modules() == ["tpu_vpcc"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    """Decided inside the run: without a card the command exits non-zero
    and prints nothing on standard output (here, on the CPU, always)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot show here")
    out = subprocess.run(
        [sys.executable, "-m", "vpcc_bench", "--workload", "narrow_gof32_max",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in out.stderr


def test_the_program_keeps_no_state_between_gofs(tiny_bench):
    """Replaying a GOF is fair: decoding A, B, A again gives A's frames
    both times, and a GOF whose planes changed in place after a decode
    comes out as its new content, not as the frames decoded before."""
    from tpu_vpcc_torch.runtime.pipeline import Decoder, Params
    from vpcc_bench.ref.recon import reconstruct_frame

    cfg = tiny_bench.config("vpcc8i_1280")
    F = cfg["frames_per_gof"]
    pool = gen.make_pool(21, cfg, 2 * F)
    a, b = (adapter.stage(pool[i * F:(i + 1) * F], cfg) for i in range(2))

    def decode(gofs):
        dec = Decoder(Params(device="cpu", pipeline_gofs=2))
        dec.start_gofs([adapter.gof_data(s, cfg) for s in gofs])
        return [check.digest(ps.positions, ps.colors) for ps in dec]

    first = decode([a])
    assert decode([a, b, a]) == first + decode([b]) + first
    for plane in a.attr:  # the attribute planes change in place
        plane[0][...] = 1023 - plane[0]
    for f in a.frames:
        for m in range(cfg["map_count"]):
            f.attr[m][0][...] = 1023 - f.attr[m][0]
    again = decode([a])
    want = [check.digest(*reconstruct_frame(f.patches, f.occ, f.geo, f.attr,
                                            cfg, "cpu")) for f in a.frames]
    assert again == want and again != first


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program to measure: the run exits non-zero with no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "vpcc_bench", tmp_path / "vpcc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys\n"
            "from vpcc_bench import run\n"
            "from vpcc_bench.registry import Bench\n"
            "r = run.run_cell(Bench(), 'narrow_gof32_max', 1, 0.5, False,"
            " device='cpu')\n"
            "print(r)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "tpu_vpcc_torch" in out.stderr
