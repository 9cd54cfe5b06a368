"""Shared fixtures: the benchmark at a size the CPU can run."""

import json
from pathlib import Path

import pytest

from vpcc_bench.registry import HERE, ROOT, Bench

#: the tiny deployment's changes: a 128x128 canvas, six patches, GOFs of
#: four frames
TINY = {"width": 128, "height": 128, "frames_per_gof": 4}


def tiny_root(tmp: Path) -> Path:
    """A checkout root whose ``BENCHMARK.json`` is the repository's and
    whose configuration files are the tiny copies of its own."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    # the smoothed deployment's cell, out of BENCHMARK.json while the
    # program's wide path disagrees with its oracle on some frames, is
    # kept here so the harness's wide path stays tested
    spec["configs"].append({
        "name": "vpcc8i_1280_smooth", "source": "-", "reduced": [],
        "file": "vpcc_bench/configs/vpcc8i_1280_smooth.json", "why": "-"})
    spec["workloads"].append({
        "name": "smooth_gof32_max", "config": "vpcc8i_1280_smooth",
        "traffic": "closed_loop", "chips": 1, "why": "-"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "narrow_gof32_max" in m.get("workloads", ()):
            m["workloads"].append("smooth_gof32_max")
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY)
        cfg["content"] = dict(cfg["content"], n_patches=6)
        path = tmp / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def tiny_bench(tmp_path) -> Bench:
    return Bench(tiny_root(tmp_path), HERE)
