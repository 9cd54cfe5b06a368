"""The port's stage spans and counters (``tpu_vpcc_torch.utils.stats``):
the span record, its parents and GOF ids, the dispatch split into H2D,
enqueue and sync, the H2D byte counter, the wide path's smoothing span
and slot counter (absent on the narrow path) and its count of passes run
on the smoothing kernels, the decode loop's hold and the
frame hand-off, its emission of a GOF as soon as it is reconstructed
(``emit_early``), the bound on kept spans, and ``stage_seconds`` written
once a span, at its end."""

import logging
import re
import threading
import time
from pathlib import Path

import pytest
import torch

from tpu_vpcc_torch.runtime import pipeline
from tpu_vpcc_torch.runtime.pipeline import Decoder, Params
from tpu_vpcc_torch.utils import stats as S
from tpu_vpcc_torch.utils.ply import format_ply
from tpu_vpcc_torch.utils.stats import (
    SPAN_GOFS,
    DecodeStats,
    GofStats,
    record_span,
    stage_timer,
)

DISPATCH_CHILDREN = ("recon_h2d", "recon_enqueue", "recon_sync")
#: frames in a GOF of :func:`_gofs`
GOF_FRAMES = 4
#: the longest a test's feed or reconstruction waits on another thread
GATE_S = 20.0


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


@pytest.fixture(scope="module")
def plain3():
    """The PLY bytes of three GOFs of :func:`_gofs` decoded one GOF at a
    time (``pipeline_gofs=1``)."""
    _dec, frames = _decode(_gofs(3), pipeline_gofs=1)
    return [format_ply(f) for f in frames]


def _gated(gofs, gate, before, met):
    """Yield ``gofs`` in turn, waiting on ``gate`` (at most
    :data:`GATE_S`) before ``gofs[before]``; ``met`` gets whether the wait
    ended by the gate."""
    for k, gof in enumerate(gofs):
        if k == before:
            met.append(gate.wait(GATE_S))
        yield gof


def test_a_list_feed_emits_after_the_next_gof_as_before(decoded):
    """With every item waiting (a list, as the warm-up feeds), the next
    GOF is always there first: no GOF counts ``emit_early``."""
    dec, _frames, _seen = decoded
    assert [g.counters["emit_early"] for g in dec.stats.gofs] == [0, 0]


def test_a_gof_is_emitted_before_the_next_one_arrives(plain3):
    """GOF 1 is handed over only once GOF 0's frames are all received: a
    loop that holds GOF 0 until GOF 1 arrives waits out the gate."""
    arrived, met = threading.Event(), []
    dec = Decoder(Params(device="cpu", pipeline_gofs=2))
    dec.start_gofs(_gated(_gofs(), arrived, 1, met))
    frames = []
    for frame in dec:
        frames.append(frame)
        if len(frames) == GOF_FRAMES:
            arrived.set()
    assert met == [True]
    for g in dec.stats.gofs:
        hold = next(s for s in g.spans if s.name == "emit_hold")
        assert hold.end_ns - hold.start_ns < GATE_S / 10 * 1e9
    assert dec.stats.gofs[0].counters["emit_early"] == 1
    assert [format_ply(f) for f in frames] == plain3[:2 * GOF_FRAMES]


@pytest.mark.parametrize("depth", [2, 3])
def test_frames_keep_gof_order_when_a_later_gof_ends_first(monkeypatch,
                                                          plain3, depth):
    """GOF 0's reconstruction waits until GOF 1's has ended, and GOF 2 is
    handed over once GOF 1's frames are received: the frames still come
    in GOF order, and GOF 1 goes out before GOF 2 arrives."""
    orig = pipeline._reconstruct_gof_device
    gof1_done, arrived = threading.Event(), threading.Event()
    waited, met = [], []

    def recon(gof, device, stats=None, mesh=None):
        if stats.gof_index == 0:
            waited.append(gof1_done.wait(GATE_S))
        frames = list(orig(gof, device, stats=stats, mesh=mesh))
        if stats.gof_index == 1:
            gof1_done.set()
        return frames

    monkeypatch.setattr(pipeline, "_reconstruct_gof_device", recon)
    dec = Decoder(Params(device="cpu", pipeline_gofs=depth))
    dec.start_gofs(_gated(_gofs(3), arrived, 2, met))
    frames = []
    for frame in dec:
        frames.append(frame)
        if len(frames) == 2 * GOF_FRAMES:
            arrived.set()
    assert waited == [True] and met == [True]
    assert [format_ply(f) for f in frames] == plain3
    assert dec.stats.gofs[1].counters["emit_early"] == 1


def test_close_while_the_next_gof_is_awaited_still_ends_the_stream():
    """The receiver drops the decoder after GOF 0's first frame, while
    the feed holds GOF 1 back: the stream still ends with the sentinel."""
    gate, met = threading.Event(), []
    dec = Decoder(Params(device="cpu", pipeline_gofs=2, queue_depth=1))
    dec.start_gofs(_gated(_gofs(), gate, 1, met))
    assert dec.recv_frame() is not None
    dec.close()
    gate.set()
    dec._thread.join(timeout=120)
    assert not dec._thread.is_alive()
    got = dec.recv_frame()
    while got is not None:
        got = dec.recv_frame()
    assert dec.recv_frame() is None


def test_a_slow_consumer_does_not_hold_back_the_next_gof(monkeypatch):
    """A GOF arrives every ``P`` s, reconstructs in ``R`` and its frames
    are taken ``c`` s apart: emitting GOF k (which blocks on the bounded
    queue) must not keep GOF k+1 waiting for its reconstruction, so the
    stream ends as soon as when the loop submitted GOF k+1 before
    emitting GOF k: about ``n P + R + 4 c``. A loop that takes the next
    GOF only between emissions needs ``R + 2 c`` a GOF instead of ``P``,
    0.56 s more here."""
    n, P, R, c = 8, 0.25, 0.2, 0.06
    starts, arrivals = [], []

    def recon(gof, device, stats=None, mesh=None):
        starts.append(time.perf_counter())
        time.sleep(R)
        return [()] * GOF_FRAMES

    def feed():
        for _ in range(n):
            time.sleep(P)
            arrivals.append(time.perf_counter())
            yield object()

    monkeypatch.setattr(pipeline, "_reconstruct_gof_device", recon)
    dec = Decoder(Params(device="cpu", pipeline_gofs=2, queue_depth=1))
    t0 = time.perf_counter()
    dec.start_gofs(feed())
    got = 0
    for _ in dec:
        got += 1
        time.sleep(c)
    total = time.perf_counter() - t0
    assert got == n * GOF_FRAMES
    assert total < n * P + R + GOF_FRAMES * c + 0.25
    # the slowest wait from a GOF's arrival to its reconstruction's start
    assert max(s - a for s, a in zip(starts, arrivals)) < 0.05 + c


@pytest.mark.parametrize("where", ["feed", "recon"])
def test_an_error_ends_the_stream_after_the_gofs_before_it(monkeypatch,
                                                           plain3, where):
    """GOF 1 fails, in the feed or in its reconstruction: GOF 0's frames
    come out, then the receiver gets the error and the stream ends."""
    orig = pipeline._reconstruct_gof_device

    def recon(gof, device, stats=None, mesh=None):
        if stats.gof_index == 1:
            raise ValueError("GOF 1")
        return orig(gof, device, stats=stats, mesh=mesh)

    def feed():
        gofs = _gofs(3)
        yield gofs[0]
        raise ValueError("GOF 1")

    if where == "recon":
        monkeypatch.setattr(pipeline, "_reconstruct_gof_device", recon)
    dec = Decoder(Params(device="cpu", pipeline_gofs=2))
    dec.start_gofs(feed() if where == "feed" else _gofs(3))
    frames = [dec.recv_frame() for _ in range(GOF_FRAMES)]
    with pytest.raises(ValueError, match="GOF 1"):
        dec.recv_frame()
    assert dec.recv_frame() is None
    dec._thread.join(timeout=120)
    assert not dec._thread.is_alive()
    assert [format_ply(f) for f in frames] == plain3[:GOF_FRAMES]


def test_h2d_bytes_count_the_staged_arrays(decoded):
    dec, _frames, seen = decoded
    assert dec.stats.counter_totals()["h2d_bytes"] == sum(b for b, _, _ in seen)
    assert {st for _, st, _ in seen} == {"device_pack"}
    # the CPU tensors that cross hold the same bytes as the staged arrays
    assert all(b == crossing for b, _, crossing in seen)


def _wide_gofs(n=2, seed=5):
    """:func:`_gofs` with geometry and colour smoothing set: every
    dispatch takes the wide path."""
    from dataclasses import replace

    from tpu_vpcc_torch.models.flagship import ATTR_SMOOTHING, GEO_SMOOTHING

    return [replace(g, geo_smoothing=GEO_SMOOTHING,
                    attr_smoothing=ATTR_SMOOTHING) for g in _gofs(n, seed)]


def _decode_seeing_smoothing(gofs, mesh=None):
    """Decode ``gofs``, with the (frames, slot extent) of every shard that
    the wide path's smoothing receives."""
    from tpu_vpcc_torch.ops import tiled

    seen = []
    orig = tiled.smooth_words_shards

    def smooth(shards, cfg, combine=None):
        seen.extend(tuple(s[4].shape) for s in shards)
        return orig(shards, cfg, combine)

    tiled.smooth_words_shards = smooth
    try:
        dec = Decoder(Params(device="cpu", mesh=mesh))
        dec.start_gofs(gofs)
        frames = list(dec)
    finally:
        tiled.smooth_words_shards = orig
    return dec, frames, seen


@pytest.fixture(scope="module")
def decoded_wide():
    return _decode_seeing_smoothing(_wide_gofs())


def _inside(span, spans):
    return [s for s in spans if s.thread == span.thread and s is not span
            and span.start_ns <= s.start_ns <= s.end_ns <= span.end_ns]


def test_wide_dispatch_smooths_inside_its_enqueue(decoded_wide):
    """One ``recon_smooth`` a wide dispatch, a child of ``recon_enqueue``;
    the dispatch's own children are as on the narrow path."""
    dec, frames, _seen = decoded_wide
    assert len(frames) == 2 * GOF_FRAMES
    for g in dec.stats.gofs:
        dispatches = [s for s in g.spans if s.name == "recon_dispatch"]
        assert len(dispatches) == 2
        for d in dispatches:
            children = [s for s in _inside(d, g.spans)
                        if s.parent == "recon_dispatch"]
            assert [s.name for s in sorted(children,
                                           key=lambda s: s.start_ns)] == list(
                DISPATCH_CHILDREN)
            enqueue = next(s for s in children if s.name == "recon_enqueue")
            smooth = [s for s in _inside(d, g.spans)
                      if s.name == "recon_smooth"]
            assert len(smooth) == 1 and smooth[0].parent == "recon_enqueue"
            assert smooth[0] in _inside(enqueue, g.spans)
        assert sum(s.name == "recon_smooth" for s in g.spans) == 2
        assert g.stage_seconds["recon_smooth"] > 0


def test_smooth_slots_count_frames_times_slot_extent(decoded_wide):
    dec, _frames, seen = decoded_wide
    assert sum(f for f, _ in seen) == 2 * GOF_FRAMES
    slots = sum(f * s for f, s in seen)
    assert dec.stats.counter_totals()["smooth_slots"] == slots
    # a group's slots: two maps of res x res pixels
    assert all(s % (2 * 16 * 16) == 0 for _, s in seen)


@pytest.mark.parametrize("path", ["plain", "kernels", "unlaunched"])
def test_smooth_kernel_passes_count_only_the_kernel_path(monkeypatch, path):
    """``smooth_kernel_passes`` adds two a wide dispatch (geometry and
    colour) where smoothing launches its kernels, and nothing on the
    plain path. Here the kernel path is the plain versions put in the
    kernels' place on the CPU, counting their launches as the kernels'
    wrappers do (``kernels``) or not at all (``unlaunched``: the device
    would take the kernels, but none launched, so nothing is counted);
    the frames are the plain path's."""
    from tpu_vpcc_torch.ops import smoothing

    _plain, want, _ = _decode_seeing_smoothing(_wide_gofs(n=1))
    if path != "plain":
        launch = (smoothing._count_launches if path == "kernels"
                  else lambda n, passes=0: None)

        def stats(*args):
            launch(2)
            return smoothing._stats_plain(*args)

        def apply(stats, xs, ys, zs, a, b, c, valid, pid, frame, cfg,
                  color):
            launch(1, passes=1)
            if color:
                return smoothing.color_apply_plain(
                    stats, xs, ys, zs, a, b, c, valid, pid, frame, cfg)
            return smoothing.geometry_apply_plain(stats, xs, ys, zs, valid,
                                                  pid, frame, cfg)

        monkeypatch.setattr(smoothing, "uses_kernels", lambda t: True)
        monkeypatch.setattr(smoothing, "_stats_cuda", stats)
        monkeypatch.setattr(smoothing, "_apply_cuda", apply)
    dec, frames, _seen = _decode_seeing_smoothing(_wide_gofs(n=1))
    assert [format_ply(f) for f in frames] == [format_ply(f) for f in want]
    (g,) = dec.stats.gofs
    dispatches = sum(s.name == "recon_smooth" for s in g.spans)
    assert dispatches == 2
    if path == "kernels":
        assert g.counters["smooth_kernel_passes"] == 2 * dispatches
    else:
        assert "smooth_kernel_passes" not in g.counters


def test_narrow_path_records_no_smoothing(decoded):
    dec, _frames, _seen = decoded
    for g in dec.stats.gofs:
        assert not any(s.name == "recon_smooth" for s in g.spans)
        assert "recon_smooth" not in g.stage_seconds
        assert "smooth_slots" not in g.counters


def test_mesh_dispatch_smooths_inside_the_dispatch():
    """On a mesh of two shards (the CPU twice) each wide dispatch has one
    ``recon_smooth`` over both shards, under ``recon_dispatch``, and
    ``smooth_slots`` counts both shards' slots."""
    from tpu_vpcc_torch.parallel import mesh as port_mesh

    mesh = port_mesh.make_mesh([torch.device("cpu")] * 2, data=1, space=2)
    dec, frames, seen = _decode_seeing_smoothing(_wide_gofs(n=1), mesh=mesh)
    _plain, plain_frames, _ = _decode_seeing_smoothing(_wide_gofs(n=1))
    assert [format_ply(f) for f in frames] == [format_ply(f)
                                               for f in plain_frames]
    assert "mesh_fallback_dispatches" not in dec.stats.counter_totals()
    (g,) = dec.stats.gofs
    smooth = [s for s in g.spans if s.name == "recon_smooth"]
    assert len(smooth) == 2 and all(s.parent == "recon_dispatch"
                                    for s in smooth)
    assert len(seen) == 4  # two dispatches of two shards
    assert g.counters["smooth_slots"] == sum(f * s for f, s in seen)


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
