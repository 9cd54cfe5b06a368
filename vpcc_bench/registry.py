"""Finds the benchmark's pieces by name.

``BENCHMARK.json`` at the checkout's root lists the cells, the
configurations and the metrics. Each configuration's sizes are in
``configs/<name>.json`` (the file ``BENCHMARK.json`` names), each
traffic mix's parameters in ``traffic/<name>.json``, and each per-layer
metric's reader in ``metrics/<name>.py``, which defines
``read(record) -> float | None``. Adding one of each adds files and
entries; no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

#: the harness's folder and the checkout's root
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT, harness: Optional[Path] = None):
        self.root = Path(root)
        self.harness = Path(harness) if harness is not None else HERE
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(
            (self.harness / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries the cell reports:
        those that list it, or list no cells."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable:
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.harness / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"vpcc_bench_metric_{metric.replace('.', '_')}", path)
        if spec is None or spec.loader is None:
            raise KeyError(f"no reader for metric {metric!r} at {path}")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
