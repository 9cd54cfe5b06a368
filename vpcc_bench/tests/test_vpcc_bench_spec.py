"""BENCHMARK.json against the benchmark contract's form, and every name
it holds found by the harness."""

import json
import re

import pytest

from vpcc_bench.registry import HERE, ROOT, Bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["vpcc_bench"]
    assert 1 <= len(SPEC["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[key]:
            yield key, e["name"]
    for w in SPEC["workloads"]:
        yield "config", w["config"]
        yield "traffic", w["traffic"]
    for c in SPEC["configs"]:
        for k in c["reduced"]:
            yield "reduced", k


@pytest.mark.parametrize("kind,name", sorted(set(_names())))
def test_name_characters(kind, name):
    assert NAME.match(name), (kind, name)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        for cell in metric.get("workloads", cells):
            reported = [m["name"] for m in SPEC["end_to_end"]
                        if cell in m.get("workloads", cells)]
            assert metric["moves"] in reported, (metric["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    b = Bench()
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in b.metrics(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert b.metrics(w["name"], "per_layer")
        assert w["chips"] == 1
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_pieces_found_by_name(cell):
    b = Bench()
    w = b.cell(cell)
    cfg = b.config(w["config"])
    assert cfg["name"] == w["config"]
    traffic = b.traffic(w["traffic"])
    assert traffic["loop"] in ("open", "closed")
    for m in b.metrics(cell, "per_layer"):
        assert callable(b.reader(m["name"]))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("vpcc_bench/")
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"]
    assert body["reduced"] == config["reduced"] == []
    assert config["source"].startswith("https://")
    assert len(config["source"]) <= 200


def test_each_per_layer_metric_has_a_reader_file():
    for m in SPEC["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_roofline_metrics_named_by_the_contract():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_a_new_config_traffic_and_metric_need_no_edit(tmp_path):
    """A throwaway configuration, traffic mix, cell and per-layer metric,
    added as files and entries beside copies of the existing ones, are
    found by name; no existing file changes."""
    import shutil

    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "vpcc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "vpcc_bench").rglob("*")
              if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((ROOT / SPEC["configs"][0]["file"]).read_text())
    cfg["name"] = "extra_cfg"
    (root / "vpcc_bench/configs/extra_cfg.json").write_text(json.dumps(cfg))
    (root / "vpcc_bench/traffic/extra_mix.json").write_text(
        json.dumps({"loop": "closed", "pool_gofs": 1, "pipeline_gofs": 1}))
    (root / "vpcc_bench/metrics/extra_metric.py").write_text(
        "def read(record):\n    return 42.0\n")
    spec["configs"].append(dict(SPEC["configs"][0], name="extra_cfg",
                                file="vpcc_bench/configs/extra_cfg.json"))
    spec["workloads"].append({"name": "extra_cell", "config": "extra_cfg",
                              "traffic": "extra_mix", "chips": 1,
                              "why": "a throwaway cell"})
    spec["per_layer"].append({"name": "extra_metric", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "device", "moves": "frames_per_s",
                              "workloads": ["extra_cell"]})
    spec["end_to_end"][0]["workloads"].append("extra_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    b = Bench(root, root / "vpcc_bench")
    assert b.config(b.cell("extra_cell")["config"])["name"] == "extra_cfg"
    assert b.traffic("extra_mix")["pool_gofs"] == 1
    assert [m["name"] for m in b.metrics("extra_cell", "per_layer")] == [
        "extra_metric"]
    assert b.reader("extra_metric")({}) == 42.0
    for p, data in before.items():
        assert p.read_bytes() == data, p
