"""The comparison that decides ``correct`` fails what it has to fail: the
control (the reference with float32 colour conversion in the program's
place), and a run whose timed path is broken underneath, once for each
fault a one-card decode can have, in the Decoder and in the multi-stream
batcher, and once for each fault of the batcher's streams: two streams'
frames swapped, a GOF repeated or skipped, a stream ended early, a frame
on the wrong stream. (The exchange between cards is a fault no cell here
can have: every cell runs on one card.)"""

import json

import numpy as np
import pytest

from vpcc_bench import run
from vpcc_bench.control import control_readings


@pytest.mark.parametrize("cell", ["narrow_gof32_max", "smooth_gof32_max",
                                  "multistream8_max"])
def test_the_control_fails(tiny_bench, cell):
    """At 640^2 with 48 patches, frames of some 250k points (a pool of 8,
    or of 32 for the eight streams): float32 colours differ from float64
    on a few points in a million."""
    for c in tiny_bench.spec["configs"]:
        p = tiny_bench.root / c["file"]
        cfg = json.loads(p.read_text())
        cfg.update(width=640, height=640)
        cfg["content"]["n_patches"] = 48
        p.write_text(json.dumps(cfg))
    r = control_readings(tiny_bench, cell, 3_000_000_017, "cpu")
    traffic = tiny_bench.traffic(tiny_bench.cell(cell)["traffic"])
    assert r["frames"] == traffic["pool_gofs"] * 4
    assert r["frames_wrong"] > 0


def _stale(monkeypatch):
    """A step that returns its state unchanged: every GOF comes out as
    the first GOF decoded (the Decoder's, or the batcher's)."""
    from tpu_vpcc_torch.parallel import batcher as B
    from tpu_vpcc_torch.runtime import pipeline as P

    real = P._reconstruct_gof_device
    real_finish = B._finish_frames
    kept = []

    def stale(gof, device, stats=None, mesh=None):
        frames = list(real(gof, device, stats=stats, mesh=mesh))
        if not kept:
            kept.append(frames)
        return iter(kept[0])

    def stale_finish(plan, frames, results, device, stats=None, mesh=None):
        out = list(real_finish(plan, frames, results, device, stats=stats,
                               mesh=mesh))
        if not kept:
            kept.append(out)
        return iter(kept[0])

    monkeypatch.setattr(P, "_reconstruct_gof_device", stale)
    monkeypatch.setattr(B, "_finish_frames", stale_finish)


def _half_batch(monkeypatch):
    """Half of each dispatch's frames left out (the Decoder's, and the
    batcher's merged ones)."""
    from tpu_vpcc_torch.parallel import batcher as B
    from tpu_vpcc_torch.runtime import pipeline as P

    real = P._dispatch_device

    def half(di, device, stats=None, mesh=None):
        out = real(di, device, stats=stats, mesh=mesh)
        return out[: max(1, len(out) // 2)]

    monkeypatch.setattr(P, "_dispatch_device", half)
    monkeypatch.setattr(B, "_dispatch_device", half)


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
    result, not correct, with the frames it never sent missing (the
    Decoder in its fifth GOF, the batcher in its eleventh, the third of
    the timed run's first wave)."""
    from tpu_vpcc_torch.parallel import batcher as B
    from tpu_vpcc_torch.runtime import pipeline as P

    real = P._reconstruct_gof_device
    real_finish = B._finish_frames
    gofs, finished = [], []

    def fails(gof, device, stats=None, mesh=None):
        gofs.append(1)
        if len(gofs) > 4:
            raise RuntimeError("a planted failure")
        yield from real(gof, device, stats=stats, mesh=mesh)

    def fails_finish(plan, frames, results, device, stats=None, mesh=None):
        finished.append(1)
        if len(finished) > 10:
            raise RuntimeError("a planted failure")
        return real_finish(plan, frames, results, device, stats=stats,
                           mesh=mesh)

    monkeypatch.setattr(P, "_reconstruct_gof_device", fails)
    monkeypatch.setattr(B, "_finish_frames", fails_finish)


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered, _fails],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell", ["narrow_gof32_max", "smooth_gof32_max",
                                  "narrow_live30", "multistream8_max"])
def test_a_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, fault,
                                            cell):
    fault(monkeypatch)
    r = run.run_cell(tiny_bench, cell, 3_000_000_019, 0.6, False,
                     device="cpu")
    assert r["correct"] is False
    assert r["failed"] > 0
    assert (r["checks"]["frames_wrong"]["value"]
            + r["checks"]["frames_missing"]["value"]) > 0


#: the tiny deployment's GOF length
F = 4


def _swapped(items):
    """Streams 0 and 1 swap frames."""
    for s, ps in items:
        yield {0: 1, 1: 0}.get(s, s), ps


def _repeated(items):
    """Stream 1's first GOF comes out twice."""
    first = []
    for s, ps in items:
        yield s, ps
        if s == 1 and len(first) < F:
            first.append(ps)
            if len(first) == F:
                yield from ((1, p) for p in first)


def _skipped(items):
    """Stream 1's second GOF never comes out."""
    n = 0
    for s, ps in items:
        if s == 1:
            n += 1
            if F < n <= 2 * F:
                continue
        yield s, ps


def _ended_early(items):
    """Stream 2 ends after its first GOF."""
    n = 0
    for s, ps in items:
        if s == 2:
            n += 1
            if n > F:
                continue
        yield s, ps


def _wrong_stream(items):
    """Stream 3's second frame comes out on stream 4."""
    n = 0
    for s, ps in items:
        if s == 3:
            n += 1
            if n == 2:
                s = 4
        yield s, ps


def _renumbered(items):
    """``(stream, frame)`` in place of ``stream``: each frame numbered by
    its place in its stream, as a sound batcher numbers it, so only the
    content can tell the fault."""
    count: dict = {}
    for s, ps in items:
        count[s] = count.get(s, -1) + 1
        yield s, count[s], ps


@pytest.mark.parametrize("fault", [_swapped, _repeated, _skipped,
                                   _ended_early, _wrong_stream],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_stream_is_not_correct(tiny_bench, monkeypatch, fault):
    from tpu_vpcc_torch.parallel import batcher as B

    assert tiny_bench.config("vpcc8i_1280")["frames_per_gof"] == F
    real = B._decode_waves

    def broken(*args, **kw):
        return _renumbered(fault((s, ps) for s, _f, ps in real(*args, **kw)))

    monkeypatch.setattr(B, "_decode_waves", broken)
    r = run.run_cell(tiny_bench, "multistream8_max", 3_000_000_029, 0.6,
                     False, device="cpu")
    assert r["correct"] is False
    assert (r["checks"]["frames_wrong"]["value"]
            + r["checks"]["frames_missing"]["value"]) > 0


def test_a_frame_numbered_out_of_place_is_wrong(tiny_bench, monkeypatch):
    """A frame that the batcher numbers other than its place in its
    stream is wrong, though its content is right."""
    from tpu_vpcc_torch.parallel import batcher as B

    real = B._decode_waves

    def misnumbered(*args, **kw):
        for s, f, ps in real(*args, **kw):
            yield s, (f + 1 if (s, f) == (5, 2) else f), ps

    monkeypatch.setattr(B, "_decode_waves", misnumbered)
    r = run.run_cell(tiny_bench, "multistream8_max", 3_000_000_031, 0.6,
                     False, device="cpu")
    assert r["correct"] is False
    assert r["checks"]["frames_wrong"]["value"] == 1
    assert r["checks"]["frames_missing"]["value"] == 0
