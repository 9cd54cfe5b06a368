"""The multi-stream timed loop on the CPU, at the tiny deployment: the
harness's entry into the batcher, the window over streams that fall out
of step, and a batcher that hangs."""

import threading
import time

import pytest

from vpcc_bench import adapter, check, gen, run

CELL = "multistream8_max"


def _setup(bench, seed):
    cell = bench.cell(CELL)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    F, P = cfg["frames_per_gof"], traffic["pool_gofs"]
    pool = gen.make_pool(seed, cfg, P * F)
    staged = [adapter.stage(pool[g * F:(g + 1) * F], cfg) for g in range(P)]
    return cfg, traffic, pool, staged


def _digests(items):
    return [(s, f, check.digest(ps.positions, ps.colors))
            for s, f, ps in items]


def test_the_entry_yields_what_the_wave_loop_yields(tiny_bench):
    """Over the same GOFs, the harness's entry gives each stream the
    frames and indices that the batcher's wave loop gives it."""
    from tpu_vpcc_torch.parallel import batcher as B
    from tpu_vpcc_torch.runtime.pipeline import Params

    cfg, traffic, _, staged = _setup(tiny_bench, 41)

    def feeds():
        return [[adapter.gof_data(staged[(s + k) % len(staged)], cfg)
                 for k in range(2)] for s in range(3)]

    ours = _digests(run.decode_gof_streams(feeds(), Params(device="cpu"),
                                           traffic["host_workers"], None))
    theirs = _digests(B._decode_waves([iter(f) for f in feeds()],
                                      lambda it: next(it, None),
                                      Params(device="cpu"),
                                      traffic["host_workers"]))
    # streams interleave in the order their preps complete
    assert sorted(ours) == sorted(theirs)
    assert sorted((s, f) for s, f, _ in ours) == [
        (s, f) for s in range(3) for f in range(2 * cfg["frames_per_gof"])]


@pytest.mark.parametrize("lag", [False, True])
def test_the_window_closes_on_streams_that_meet(tiny_bench, monkeypatch,
                                                lag):
    """The window closes at a GOF completed once every stream has as many
    whole GOFs, also where the batcher keeps a stream a GOF behind the
    others (the others are then fed no further than the furthest)."""
    from tpu_vpcc_torch.parallel import batcher as B

    cfg, traffic, pool, staged = _setup(tiny_bench, 43)
    F = cfg["frames_per_gof"]
    real = B._decode_waves

    def lagging(*args, **kw):
        held = []
        for s, f, ps in real(*args, **kw):
            if s != 0:
                yield s, f, ps
                continue
            held.append((s, f, ps))
            if len(held) == 2 * F:
                yield from held[:F]
                del held[:F]
        yield from held

    if lag:
        monkeypatch.setattr(B, "_decode_waves", lagging)
    timed = run.TimedStreams(staged, cfg, traffic, 0.3, "cpu")
    timed.run()
    want, _ = run.reference_digests(pool, cfg, "cpu")
    assert timed.t_close is not None
    assert timed.t_close - timed.t_open >= 0.3
    assert (timed.n_close - timed.n_open) % F == 0
    assert sum(timed.received) == len(timed.recv_t)
    assert len(timed.handed_gofs()) * F == len(timed.recv_t)
    assert timed.judge(want) == (0, 0, 0)


def test_a_batcher_that_hangs_ends_the_run_not_correct(tiny_bench,
                                                       monkeypatch):
    """The timed batcher stops after its first wave: the run gives up
    after its limits and comes out not correct, the frames never sent
    missing."""
    from tpu_vpcc_torch.parallel import batcher as B

    real = B._decode_waves
    calls = []
    release = threading.Event()

    def hangs(*args, **kw):
        calls.append(1)
        for i, item in enumerate(real(*args, **kw)):
            yield item
            if len(calls) > 1 and i == 31:
                release.wait(30)

    monkeypatch.setattr(B, "_decode_waves", hangs)
    monkeypatch.setattr(run, "DRAIN_S", 0.5)
    timed_run = run.TimedStreams.run
    took = []

    def clocked(self, profiler=None):
        t0 = time.perf_counter()
        timed_run(self, profiler)
        took.append(time.perf_counter() - t0)

    monkeypatch.setattr(run.TimedStreams, "run", clocked)
    try:
        r = run.run_cell(tiny_bench, CELL, 3_000_000_037, 0.3, False,
                         device="cpu")
    finally:
        release.set()
    for t in threading.enumerate():  # the abandoned batcher ends
        if t.name == "vpcc_bench-batcher":
            t.join(60)
            assert not t.is_alive()
    # it gives up 0.3 + 2 x 0.5 s after the first hand-over
    assert took[0] < 10
    assert r["correct"] is False
    assert r["checks"]["frames_missing"]["value"] > 0
