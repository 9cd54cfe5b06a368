"""The port's stage spans and counters (``tpu_vpcc_torch.utils.stats``):
the span record, its parents and GOF ids, the dispatch split into H2D,
enqueue and sync, the H2D byte counter, the decode loop's hold and the
frame hand-off, the bound on kept spans, and ``stage_seconds`` written
once a span, at its end."""

import logging
import re
import threading
import time
from pathlib import Path

import pytest

from tpu_vpcc_torch.runtime import pipeline
from tpu_vpcc_torch.runtime.pipeline import Decoder, Params
from tpu_vpcc_torch.utils import stats as S
from tpu_vpcc_torch.utils.stats import (
    SPAN_GOFS,
    DecodeStats,
    GofStats,
    record_span,
    stage_timer,
)

DISPATCH_CHILDREN = ("recon_h2d", "recon_enqueue", "recon_sync")


def _gofs(n=2, seed=5):
    """``n`` prepared 128^2 GOFs of four frames on the narrow path: two
    dispatches of two frames each (``DEVICE_BATCH``)."""
    from tpu_vpcc_torch.models.flagship import (
        FlagshipConfig,
        example_frames,
        example_gof,
    )

    cfg = FlagshipConfig(128, 128, 16, batch=4)
    return [example_gof(cfg, example_frames(cfg, seed=seed + 10 * g,
                                            n_patches=8))
            for g in range(n)]


def _decode(gofs, pipeline_gofs=2):
    dec = Decoder(Params(device="cpu", pipeline_gofs=pipeline_gofs))
    dec.start_gofs(gofs)
    frames = list(dec)
    return dec, frames


@pytest.fixture(scope="module")
def decoded():
    """Two GOFs through ``Decoder.start_gofs`` on the CPU, with the
    bytes of every dispatch's staged arrays and of the CPU tensors that
    cross to the device, as ``DeviceInputs.on_device`` sees them."""
    from tpu_vpcc_torch.ops.tiled import plane_tensors

    seen = []
    orig = pipeline.DeviceInputs.on_device

    def on_device(self, device):
        crossing = (plane_tensors(*self.arrays)
                    if self.staging == "device_pack" else None)
        seen.append((sum(a.nbytes for a in self.arrays), self.staging,
                     None if crossing is None
                     else sum(t.nbytes for t in crossing)))
        return orig(self, device)

    pipeline.DeviceInputs.on_device = on_device
    try:
        dec, frames = _decode(_gofs())
    finally:
        pipeline.DeviceInputs.on_device = orig
    return dec, frames, seen


def test_dispatch_splits_into_h2d_enqueue_and_sync(decoded):
    dec, _frames, seen = decoded
    n_dispatch = 0
    for g in dec.stats.gofs:
        spans = g.spans
        dispatches = [s for s in spans if s.name == "recon_dispatch"]
        assert len(dispatches) == 2  # two chunks of two frames
        n_dispatch += len(dispatches)
        for d in dispatches:
            assert d.parent == "reconstruct"
            inside = [s for s in spans if s.thread == d.thread
                      and d.start_ns <= s.start_ns <= s.end_ns <= d.end_ns
                      and s is not d]
            assert sorted(s.name for s in inside) == sorted(DISPATCH_CHILDREN)
            assert all(s.parent == "recon_dispatch" for s in inside)
            # the children run back to back in order and fill the span
            inside.sort(key=lambda s: s.start_ns)
            assert [s.name for s in inside] == list(DISPATCH_CHILDREN)
        for name in DISPATCH_CHILDREN:
            assert sum(s.name == name for s in spans) == len(dispatches)
    assert len(seen) == n_dispatch


def test_every_span_carries_its_gof(decoded):
    dec, _frames, _seen = decoded
    assert len(dec.stats.gofs) == 2
    for g in dec.stats.gofs:
        assert g.spans and all(s.gof == g.gof_index for s in g.spans)
        assert all(s.start_ns <= s.end_ns for s in g.spans)
        top = [s for s in g.spans if s.name == "reconstruct"]
        assert len(top) == 1 and top[0].parent is None
        for s in g.spans:
            if s.name in ("recon_tables", "recon_stage", "recon_dispatch",
                          "recon_fetch", "recon_emit"):
                assert s.parent == "reconstruct", s
                assert s.thread == top[0].thread
                assert top[0].start_ns <= s.start_ns <= s.end_ns \
                    <= top[0].end_ns
            if s.cpu_ns is not None:
                assert 0 <= s.cpu_ns


def test_one_hold_a_gof_and_one_handoff_a_frame(decoded):
    dec, frames, _seen = decoded
    assert sum(g.frame_count for g in dec.stats.gofs) == len(frames) == 8
    for g in dec.stats.gofs:
        holds = [s for s in g.spans if s.name == "emit_hold"]
        handoffs = [s for s in g.spans if s.name == "emit_handoff"]
        assert len(holds) == 1 and len(handoffs) == g.frame_count == 4
        recon = next(s for s in g.spans if s.name == "reconstruct")
        assert holds[0].start_ns == recon.end_ns
        assert all(s.start_ns >= holds[0].end_ns for s in handoffs)
        # recorded by the consumer (this thread), across threads
        assert {s.thread for s in handoffs} == {threading.get_ident()}
        assert all(s.parent is None and s.cpu_ns is None
                   for s in holds + handoffs)
        assert holds[0].thread != threading.get_ident()


def test_h2d_bytes_count_the_staged_arrays(decoded):
    dec, _frames, seen = decoded
    assert dec.stats.counter_totals()["h2d_bytes"] == sum(b for b, _, _ in seen)
    assert {st for _, st, _ in seen} == {"device_pack"}
    # the CPU tensors that cross hold the same bytes as the staged arrays
    assert all(b == crossing for b, _, crossing in seen)


def test_frames_and_end_of_stream_unchanged_by_the_handoff(decoded):
    """``recv_frame`` still returns a ``PointSet3`` and then None; the
    frames equal a decode without a second GOF in flight."""
    from tpu_vpcc_torch.reconstruction.pointset import PointSet3

    dec, frames, _seen = decoded
    assert all(isinstance(f, PointSet3) for f in frames)
    assert dec.recv_frame() is None
    _dec, again = _decode(_gofs(), pipeline_gofs=1)
    assert [len(f) for f in again] == [len(f) for f in frames]


def test_close_still_ends_the_stream():
    dec = Decoder(Params(device="cpu", pipeline_gofs=2, queue_depth=1))
    dec.start_gofs(_gofs())
    assert dec.recv_frame() is not None
    dec.close()
    dec._thread.join(timeout=120)
    assert not dec._thread.is_alive()
    got = dec.recv_frame()
    # what is left in the queue: at most a frame, then the sentinel
    while got is not None:
        got = dec.recv_frame()
    assert dec.recv_frame() is None


class _SpanLog(dict):
    """A ``stage_seconds`` that logs each write as a span ending now and
    as long as the write added (the benchmark's way of reading it)."""

    def __init__(self, log):
        super().__init__()
        self._log = log

    def __setitem__(self, key, value):
        now = time.perf_counter()
        length = value - self.get(key, 0.0)
        super().__setitem__(key, value)
        self._log.append((key, now - length, now))


def test_stage_seconds_written_once_a_span_at_its_end():
    log = []
    g = GofStats(gof_index=3, stage_seconds=_SpanLog(log))
    with stage_timer(g, "outer"):
        time.sleep(0.002)
        for _ in range(3):
            with stage_timer(g, "inner"):
                time.sleep(0.001)
    t0 = time.perf_counter_ns()
    time.sleep(0.001)
    record_span(g, "handoff", t0)
    assert [name for name, _, _ in log] == ["inner"] * 3 + ["outer",
                                                           "handoff"]
    assert [s.name for s in g.spans] == [name for name, _, _ in log]
    for (name, start, end), s in zip(log, g.spans):
        assert abs(start - s.start_ns / 1e9) < 1e-3, name
        assert abs(end - s.end_ns / 1e9) < 1e-3, name
    assert g.stage_seconds["inner"] == pytest.approx(
        sum((s.end_ns - s.start_ns) / 1e9 for s in g.spans
            if s.name == "inner"))
    assert [s.parent for s in g.spans] == ["outer"] * 3 + [None, None]
    assert all(s.gof == 3 for s in g.spans)


def test_stage_totals_and_summary_still_read_the_seconds():
    st = DecodeStats()
    for _ in range(2):
        g = st.new_gof()
        with stage_timer(g, "recon_tables"):
            pass
        g.count("h2d_bytes", 10)
    assert set(st.stage_totals()) == {"recon_tables"}
    assert st.counter_totals() == {"h2d_bytes": 20}
    assert "recon_tables=" in st.gofs[0].summary()
    assert not hasattr(GofStats(), "video_bytes")


def test_a_span_is_recorded_when_its_block_raises():
    g = GofStats()
    with pytest.raises(KeyError):
        with stage_timer(g, "outer"):
            with stage_timer(g, "inner"):
                raise KeyError("x")
    assert [(s.name, s.parent) for s in g.spans] == [("inner", "outer"),
                                                    ("outer", None)]
    with stage_timer(g, "after"):
        pass
    assert g.spans[-1].parent is None  # the stack was unwound


def test_parents_are_per_thread():
    g = GofStats()
    opened, release = threading.Event(), threading.Event()

    def other():
        with stage_timer(g, "other_outer"):
            opened.set()
            release.wait(30)
            with stage_timer(g, "other_inner"):
                pass

    t = threading.Thread(target=other)
    t.start()
    assert opened.wait(30)
    with stage_timer(g, "main"):
        release.set()
        t.join(30)
    assert not t.is_alive()
    by = {s.name: s for s in g.spans}
    assert by["main"].parent is None
    assert by["other_inner"].parent == "other_outer"
    assert by["other_outer"].thread == by["other_inner"].thread
    assert by["other_outer"].thread != by["main"].thread


def test_cpu_time_is_the_threads_own():
    """A span's CPU time is its own thread's: a sleep beside a spinning
    thread reads little, a spin for 30 ms of CPU reads at least that."""
    g = GofStats()
    stop = threading.Event()

    def spin_until_stopped():
        while not stop.is_set():
            pass

    t = threading.Thread(target=spin_until_stopped)
    t.start()
    try:
        with stage_timer(g, "sleep"):
            time.sleep(0.05)
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive()
    with stage_timer(g, "spin"):
        c0 = time.thread_time_ns()
        while time.thread_time_ns() - c0 < 30_000_000:
            pass
    sleep, spin = g.spans
    assert sleep.cpu_ns < 0.5 * (sleep.end_ns - sleep.start_ns)
    assert spin.cpu_ns >= 30_000_000


@pytest.mark.parametrize("extra", [0, 1, 3])
def test_old_gofs_lose_their_spans_and_keep_their_seconds(extra):
    st = DecodeStats()
    for k in range(SPAN_GOFS + extra):
        g = st.new_gof()
        with stage_timer(g, "recon_tables"):
            pass
        g.count("h2d_bytes", k)
    dropped = [g for g in st.gofs if g.spans is None]
    assert [g.gof_index for g in dropped] == list(range(extra))
    assert all(len(g.spans) == 1 for g in st.gofs[extra:])
    assert all("recon_tables" in g.stage_seconds for g in st.gofs)
    assert st.counter_totals()["h2d_bytes"] == sum(range(SPAN_GOFS + extra))
    if dropped:  # a span closing on a dropped GOF still adds its seconds
        before = dropped[0].stage_seconds["recon_tables"]
        record_span(dropped[0], "recon_tables", time.perf_counter_ns() - 10)
        assert dropped[0].stage_seconds["recon_tables"] > before
        assert dropped[0].spans is None


@pytest.mark.parametrize("level,calls", [(logging.INFO, 0),
                                         (logging.DEBUG, 2)])
def test_debug_summary_formatted_only_when_debug_is_on(monkeypatch, caplog,
                                                       level, calls):
    n = []
    orig = GofStats.summary
    monkeypatch.setattr(GofStats, "summary",
                        lambda self: n.append(1) or orig(self))
    caplog.set_level(level, logger=pipeline.__name__)
    _decode(_gofs())
    assert len(n) == calls


def test_the_port_makes_no_profiler_call():
    """Spans stay in memory: no ``record_function`` and no check whether
    a profiler is on, anywhere in the port's package."""
    root = Path(S.__file__).resolve().parent.parent
    pat = re.compile(r"record_function\s*\(|_profiler_enabled"
                     r"|(torch|autograd)\.profiler(\.| import)"
                     r"|import torch\.profiler")
    hits = [str(p.relative_to(root)) for p in sorted(root.rglob("*.py"))
            if pat.search(p.read_text())]
    # the kernel-timing tool traces the card on purpose, outside the
    # decoder's path
    assert all(h.startswith("tools/") for h in hits), hits
