"""The program's own spans and counters, for the per-layer readers.

``tpu_vpcc_torch.utils.stats`` keeps, for each GOF of a run's
``DecodeStats``, its stage spans (``GofStats.spans``: name, GOF, parent,
thread, start and end on ``time.perf_counter_ns``, the thread's CPU time)
and its counters (``h2d_bytes``). A reader finds the run's ``DecodeStats``
under the record's ``"stats"`` key and the host-clock ends of the traced
window (``time.perf_counter`` seconds) under ``"host_window"``. Where the
record lacks a key, as ``run.per_layer`` builds it, the value comes from
the run that ``per_layer`` is reading: its ``timed`` (``stats``,
``t_start``, ``t_end``). A program whose GOFs keep no spans gives None.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple


def _timed():
    """The ``timed`` of the nearest caller that has one (``per_layer``)."""
    f = sys._getframe(1)
    while f is not None:
        t = f.f_locals.get("timed")
        if t is not None and hasattr(t, "stats") and hasattr(t, "t_end"):
            return t
        f = f.f_back
    return None


def run_stats(record: dict):
    """The run's ``DecodeStats``, or None."""
    if "stats" in record:
        return record["stats"]
    t = _timed()
    return None if t is None else t.stats


def host_window(record: dict) -> Optional[Tuple[float, float]]:
    """The traced window's ends on the host clock, in seconds."""
    if "host_window" in record:
        return record["host_window"]
    t = _timed()
    return None if t is None else (t.t_start, t.t_end)


def run_spans(stats) -> Optional[list]:
    """Every span of the run's GOFs; None where there are no GOFs or a
    GOF has no spans (a program that keeps none, or spans dropped)."""
    if stats is None or not stats.gofs:
        return None
    out: list = []
    for g in stats.gofs:
        spans = getattr(g, "spans", None)
        if spans is None:
            return None
        out.extend(spans)
    return out


def gof_values(stats, stage: str) -> List[float]:
    """``stage``'s seconds in each GOF that has it."""
    if stats is None:
        return []
    return [g.stage_seconds[stage] for g in stats.gofs
            if stage in g.stage_seconds]


def to_trace_us(record: dict, window):
    """Host ``perf_counter_ns`` -> the trace's µs: linear, the host
    window's ends landing on the trace window's. Its error is the gap
    between those ends and the traced window's (about 2 ms where the
    window is the process's first ``record_function``, which returns
    that long after it takes its start)."""
    h0, h1 = (x * 1e9 for x in window)
    w0, w1 = record["trace"].window_us
    scale = (w1 - w0) / (h1 - h0)
    return lambda ns: w0 + (ns - h0) * scale


def overlap(xs, ys) -> float:
    """The length two sorted, merged interval lists share."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
