"""The comparison that decides ``correct`` fails what it has to fail: the
control (the reference with float32 colour conversion in the program's
place), and a run whose timed path is broken underneath, once for each
fault a one-card decode can have. (The exchange between cards is a
fault no cell here can have: every cell runs on one card.)"""

import json

import numpy as np
import pytest

from vpcc_bench import run
from vpcc_bench.control import control_readings


@pytest.mark.parametrize("cell", ["narrow_gof32_max", "smooth_gof32_max"])
def test_the_control_fails(tiny_bench, cell):
    """At 640^2 with 48 patches, a pool of 8 frames of some 250k points:
    float32 colours differ from float64 on a few points in a million."""
    for c in tiny_bench.spec["configs"]:
        p = tiny_bench.root / c["file"]
        cfg = json.loads(p.read_text())
        cfg.update(width=640, height=640)
        cfg["content"]["n_patches"] = 48
        p.write_text(json.dumps(cfg))
    r = control_readings(tiny_bench, cell, 3_000_000_017, "cpu")
    assert r["frames"] == 8
    assert r["frames_wrong"] > 0


def _stale(monkeypatch):
    """A step that returns its state unchanged: every GOF comes out as
    the first GOF decoded."""
    from tpu_vpcc_torch.runtime import pipeline as P

    real = P._reconstruct_gof_device
    kept = []

    def stale(gof, device, stats=None, mesh=None):
        frames = list(real(gof, device, stats=stats, mesh=mesh))
        if not kept:
            kept.append(frames)
        return iter(kept[0])

    monkeypatch.setattr(P, "_reconstruct_gof_device", stale)


def _half_batch(monkeypatch):
    """Half of each dispatch's frames left out."""
    from tpu_vpcc_torch.runtime import pipeline as P

    real = P._dispatch_device

    def half(di, device, stats=None, mesh=None):
        out = real(di, device, stats=stats, mesh=mesh)
        return out[: max(1, len(out) // 2)]

    monkeypatch.setattr(P, "_dispatch_device", half)


def _altered(monkeypatch):
    """One answer altered where it is produced: the first point of every
    frame gets another colour."""
    from tpu_vpcc_torch.runtime import pipeline as P

    real = P._emit_pointset

    def altered(pos, col, gof):
        ps = real(pos, col, gof)
        if len(ps):
            ps.colors[0] = ps.colors[0] ^ np.uint8(1)
        return ps

    monkeypatch.setattr(P, "_emit_pointset", altered)


def _fails(monkeypatch):
    """The decoder fails after its first GOFs: the run still prints a
    result, not correct, with the frames it never sent missing."""
    from tpu_vpcc_torch.runtime import pipeline as P

    real = P._dispatch_device
    calls = []

    def fails(di, device, stats=None, mesh=None):
        calls.append(1)
        if len(calls) > 8:
            raise RuntimeError("a planted failure")
        return real(di, device, stats=stats, mesh=mesh)

    monkeypatch.setattr(P, "_dispatch_device", fails)


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered, _fails],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell", ["narrow_gof32_max", "smooth_gof32_max",
                                  "narrow_live30"])
def test_a_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, fault,
                                            cell):
    fault(monkeypatch)
    r = run.run_cell(tiny_bench, cell, 3_000_000_019, 0.6, False,
                     device="cpu")
    assert r["correct"] is False
    assert r["failed"] > 0
    assert (r["checks"]["frames_wrong"]["value"]
            + r["checks"]["frames_missing"]["value"]) > 0
