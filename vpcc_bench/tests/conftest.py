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
