"""The readers of the program's own spans and counters: their values on a
hand-made record, None where their data is absent, the mapping of the
program's clock onto the trace's, the harness's traced runs reporting
them, and the older readers unmoved by the record's two new keys."""

import json
import time
from dataclasses import dataclass, field

import pytest

from vpcc_bench import run
from vpcc_bench import trace as T
from vpcc_bench.registry import ROOT, Bench
from vpcc_bench.spans import to_trace_us

NEW = ("h2d_host_ms_per_frame", "enqueue_ms_per_frame",
       "sync_wait_ms_per_frame", "h2d_host_gbps", "host_wait_ms_per_frame",
       "tables_idle_ms_per_frame", "hold_ms_per_gof.live",
       "handoff_ms_per_frame.live")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
#: the host window, 10 s to 10.001 s, lands on the trace's 0-1000 µs
H0 = 10_000_000_000
WINDOW = (10.0, 10.001)


def _stats():
    """Two GOFs of two frames, their spans at known host times (ns from
    ``H0``; one ns is a thousandth of a trace µs here)."""
    from tpu_vpcc_torch.utils.stats import DecodeStats, Span

    st = DecodeStats()
    plan = [
        # name, start, end (ns from H0), cpu ns
        [("recon_tables", 100_000, 300_000, 50_000),
         ("recon_stage", 300_000, 310_000, 10_000),
         ("recon_h2d", 310_000, 330_000, 20_000),
         ("recon_enqueue", 330_000, 334_000, 4_000),
         ("recon_sync", 334_000, 340_000, 1_000),
         ("recon_emit", 340_000, 346_000, 6_000),
         ("emit_hold", 350_000, 5_350_000, None),
         ("emit_handoff", 5_350_000, 5_351_000, None),
         ("emit_handoff", 5_351_000, 5_353_000, None)],
        [("recon_tables", 250_000, 400_000, 150_000),
         ("recon_h2d", 400_000, 440_000, 40_000),
         ("recon_emit", 440_000, 444_000, 1_000),
         ("emit_hold", 444_000, 3_444_000, None),
         ("emit_handoff", 3_444_000, 3_447_000, None),
         ("emit_handoff", 3_447_000, 3_448_000, None)],
    ]
    for k, spans in enumerate(plan):
        g = st.new_gof()
        for name, a, b, cpu in spans:
            g.spans.append(Span(name, k, None, 1, H0 + a, H0 + b, cpu))
            g.stage_seconds[name] = (g.stage_seconds.get(name, 0.0)
                                     + (b - a) / 1e9)
        g.count("h2d_bytes", 3_000_000 * (k + 1))
        g.frame_count = 2
    return st


def _trace(device=True):
    recs = [T.DeviceRecord("kernel", "pack_tiles_kernel", 150.0, 50.0),
            T.DeviceRecord("gpu_memcpy", "Memcpy HtoD", 350.0, 150.0),
            T.DeviceRecord("kernel", "compact_narrow_kernel", 600.0, 10.0),
            T.DeviceRecord("kernel", "elementwise_kernel", 700.0, 5.0)]
    return T.Trace(window_us=(0.0, 1000.0), device=recs if device else [],
                   host=[("aten::add", 10.0, 20.0)])


def _record(stats=None, with_keys=True, device=True):
    stats = _stats() if stats is None else stats
    spans: dict = {}
    for g in stats.gofs:
        for k, v in g.stage_seconds.items():
            spans[k] = spans.get(k, 0.0) + v
    tr = _trace(device)
    rec = {"frames": 4, "gofs": 2, "spans": spans, "trace": tr,
           "busy_s": T.busy_s(tr), "window_s": tr.window_s,
           "bytes": {"k1": 10_000, "k1f": 20_000, "k2w": 30_000,
                     "k5": 40_000},
           "late_s": [0.001, 0.004]}
    if with_keys:
        rec.update(stats=stats, host_window=WINDOW)
    return rec


WANT = {
    "h2d_host_ms_per_frame": (0.020 + 0.040) / 4,
    "enqueue_ms_per_frame": 0.004 / 4,
    "sync_wait_ms_per_frame": 0.006 / 4,
    # 9 MB over 60 µs
    "h2d_host_gbps": 9_000_000 / 60e-6 / 1e9,
    # wall - cpu over tables, stage, emit: (150+50+0) + (0+140+3) µs
    "host_wait_ms_per_frame": ((200_000 - 50_000) + (10_000 - 10_000)
                               + (6_000 - 6_000) + (150_000 - 150_000)
                               + (4_000 - 1_000)) / 1e6 / 4,
    # tables cover 100-400 µs; the device is busy 150-200 and 350-400
    "tables_idle_ms_per_frame": (300 - 50 - 50) / 1e3 / 4,
    "hold_ms_per_gof.live": (5.0 + 3.0) / 2,
    "handoff_ms_per_frame.live": (0.001 + 0.002 + 0.003 + 0.001) / 4,
}


@pytest.mark.parametrize("metric", NEW)
def test_reader_on_a_hand_made_record(metric):
    got = Bench().reader(metric)(_record())
    assert got == pytest.approx(WANT[metric], rel=1e-9)


@dataclass
class _OldGof:
    """A GOF's statistics as a program without span records keeps them."""

    gof_index: int = 0
    frame_count: int = 2
    stage_seconds: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)


@dataclass
class _OldStats:
    gofs: list = field(default_factory=list)


@pytest.mark.parametrize("metric", NEW)
def test_reader_gives_none_for_a_program_without_spans(metric):
    old = _OldStats([_OldGof(k, stage_seconds={"recon_tables": 0.1,
                                               "recon_dispatch": 0.2})
                     for k in range(2)])
    rec = _record(stats=old)
    assert Bench().reader(metric)(rec) is None


@pytest.mark.parametrize("metric", ["host_wait_ms_per_frame",
                                    "tables_idle_ms_per_frame"])
def test_span_readers_give_none_where_a_gof_dropped_its_spans(metric):
    st = _stats()
    st.gofs[0].spans = None
    assert Bench().reader(metric)(_record(stats=st)) is None


def test_tables_idle_needs_device_records():
    rec = _record(device=False)
    assert Bench().reader("tables_idle_ms_per_frame")(rec) is None


@pytest.mark.parametrize("metric", NEW)
def test_reader_gives_none_outside_a_run_without_the_keys(metric):
    """No ``stats`` key and no run reading the record: only the readers
    of summed spans find something, and only where those spans are."""
    rec = _record(with_keys=False)
    got = Bench().reader(metric)(rec)
    if metric in ("h2d_host_ms_per_frame", "enqueue_ms_per_frame",
                  "sync_wait_ms_per_frame", "handoff_ms_per_frame.live"):
        assert got == pytest.approx(WANT[metric], rel=1e-9)
    else:
        assert got is None


def test_readers_find_the_run_that_per_layer_reads():
    """Without the record's keys, the readers take the stats and the
    window from the ``timed`` of the ``per_layer`` that calls them."""

    class Timed:
        stats = _stats()
        t_start, t_end = WINDOW

    def per_layer(timed, record):
        return {m: Bench().reader(m)(record) for m in NEW}

    got = per_layer(Timed(), _record(with_keys=False))
    for m in NEW:
        assert got[m] == pytest.approx(WANT[m], rel=1e-9), m


@pytest.mark.parametrize(
    "metric", [m["name"] for m in SPEC["per_layer"] if m["name"] not in NEW])
def test_older_readers_unmoved_by_the_new_keys(metric):
    read = Bench().reader(metric)
    assert read(_record(with_keys=True)) == read(_record(with_keys=False))


def test_host_spans_map_onto_the_trace_clock():
    """Under a CPU profiler, a dispatch on the main thread: each torch
    operation lies inside the mapped span of the stage that ran it, to
    1 ms, and the dispatch's operations inside ``recon_dispatch``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpu_vpcc_torch.models.flagship import (
        FlagshipConfig,
        example_frames,
        example_gof,
    )
    from tpu_vpcc_torch.runtime import pipeline
    from tpu_vpcc_torch.utils.stats import GofStats

    cfg = FlagshipConfig(128, 128, 16, batch=2)
    gof = example_gof(cfg, example_frames(cfg, seed=3, n_patches=8))
    fcfg, tables, g_bucket = pipeline._gof_tables_and_bucket(gof)
    di = pipeline._gof_device_inputs(gof, gof.metas, (fcfg, tables),
                                     g_bucket)
    gs = GofStats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a process's first range takes its start about 2 ms before it
        # returns, which would shift the window's traced start
        with record_function("warm-up"):
            pass
        with record_function(T.WINDOW):
            t0 = time.perf_counter()
            time.sleep(0.02)
            pipeline._dispatch_device(di, torch.device("cpu"), stats=gs)
            time.sleep(0.02)
            t1 = time.perf_counter()
    tr = T.read_profile(prof)
    at = to_trace_us({"trace": tr}, (t0, t1))
    stages = {s.name: (at(s.start_ns) - 1e3, at(s.end_ns) + 1e3)
              for s in gs.spans if s.name in ("recon_dispatch",
                                              "recon_fetch")}
    assert set(stages) == {"recon_dispatch", "recon_fetch"}
    assert tr.host
    lo, hi = stages["recon_dispatch"]
    in_dispatch = [op for op in tr.host if lo <= op[1] and op[2] <= hi]
    assert len(in_dispatch) >= 5
    for name, a, b in tr.host:
        assert any(s <= a and b <= e for s, e in stages.values()), name


@pytest.mark.parametrize("cell,names", [
    ("narrow_gof32_max", {"h2d_host_ms_per_frame", "enqueue_ms_per_frame",
                          "sync_wait_ms_per_frame", "h2d_host_gbps",
                          "host_wait_ms_per_frame"}),
    ("narrow_live30", {"hold_ms_per_gof.live", "handoff_ms_per_frame.live"}),
    ("multistream8_max", {"tables_ms_per_frame", "stage_ms_per_frame",
                          "dispatch_ms_per_frame", "fetch_ms_per_frame",
                          "emit_ms_per_frame", "h2d_host_ms_per_frame",
                          "enqueue_ms_per_frame", "sync_wait_ms_per_frame",
                          "h2d_host_gbps", "host_wait_ms_per_frame"}),
])
def test_a_traced_run_reports_the_program_spans(tiny_bench, cell, names):
    """The harness as it is, on the CPU: the program's spans reach the
    result line (``tables_idle_ms_per_frame`` needs device records)."""
    r = run.run_cell(tiny_bench, cell, 2_900_000_033, 0.6, True,
                     device="cpu")
    assert r["correct"] is True
    assert names <= set(r["metrics"])
    assert all(r["metrics"][n]["value"] > 0 for n in names)
    assert "tables_idle_ms_per_frame" not in r["metrics"]
