"""Decode statistics, stage spans and counters (SURVEY.md §5 observability).

The reference stubbed out its bitstream ``Stat`` collector
(``src/bitstream.rs:17-45``, ``TODO[stat]`` markers); this is the working
equivalent: per-GOF stage timings, point counts, event counters and a
timeline of stage spans, exposed on the Decoder as ``decoder.stats`` and
loggable as one summary line per GOF.

A stage span is kept twice. Its seconds are added to the GOF's
``stage_seconds`` once, as it ends; and a :class:`Span` goes on the GOF's
``spans``: name, GOF, parent, thread, start and end on
``time.perf_counter_ns`` (the clock ``time.perf_counter`` reads), and the
thread's CPU time over it. Spans live in memory and are always recorded.
They never go through ``torch.profiler``: a ``record_function`` range
costs an order of magnitude more than the clock reads here even with no
profiler running, and ranges opened on the decoder's worker threads,
where every stage runs, are missing from a default CPU profiler's trace.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

#: GOFs whose spans are kept: ``DecodeStats.new_gof`` drops the spans of
#: older GOFs (their ``stage_seconds`` and counters stay), so an
#: always-on decoder holds a bounded timeline. A 51 s run of the
#: benchmark decodes about 110 GOFs, so its runs keep every span.
SPAN_GOFS = 256


class Span(NamedTuple):
    """One stage span. ``parent`` names the innermost span still open on
    the same thread when this one began (None at the top, and for a span
    recorded across threads); ``thread`` is the ident of the thread that
    recorded it; ``cpu_ns`` is that thread's CPU time over the span
    (None across threads)."""

    name: str
    gof: int
    parent: Optional[str]
    thread: int
    start_ns: int
    end_ns: int
    cpu_ns: Optional[int]


@dataclass
class GofStats:
    """Timings (seconds), spans and counts for one decoded GOF."""

    gof_index: int = 0
    frame_count: int = 0
    total_points: int = 0
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    #: event counters (e.g. ``mesh_fallback_dispatches`` when a
    #: mesh-configured decode degraded to single-device, ``h2d_bytes``
    #: the bytes of the dispatches' staged arrays sent to the device)
    counters: Dict[str, int] = field(default_factory=dict)
    #: the GOF's spans in the order they ended; None once dropped
    #: (:data:`SPAN_GOFS`)
    spans: Optional[List[Span]] = field(default_factory=list)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def summary(self) -> str:
        stages = " ".join(
            f"{k}={v * 1000:.1f}ms" for k, v in sorted(self.stage_seconds.items())
        )
        counters = " ".join(
            f"{k}={v}" for k, v in sorted(self.counters.items())
        )
        return (
            f"gof={self.gof_index} frames={self.frame_count} "
            f"points={self.total_points} {stages}"
            + (f" {counters}" if counters else "")
        )


@dataclass
class DecodeStats:
    """Accumulated statistics for one Decoder run."""

    gofs: List[GofStats] = field(default_factory=list)

    def new_gof(self) -> GofStats:
        g = GofStats(gof_index=len(self.gofs))
        self.gofs.append(g)
        if len(self.gofs) > SPAN_GOFS:
            self.gofs[-1 - SPAN_GOFS].spans = None
        return g

    @property
    def total_frames(self) -> int:
        return sum(g.frame_count for g in self.gofs)

    @property
    def total_points(self) -> int:
        return sum(g.total_points for g in self.gofs)

    def stage_totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for g in self.gofs:
            for k, v in g.stage_seconds.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def counter_totals(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for g in self.gofs:
            for k, v in g.counters.items():
                out[k] = out.get(k, 0) + v
        return out


_open = threading.local()  # .stack: names of the spans open on a thread


def _open_stack() -> List[str]:
    try:
        return _open.stack
    except AttributeError:
        _open.stack = []
        return _open.stack


def _record(stats: GofStats, name: str, parent: Optional[str],
            start_ns: int, end_ns: int, cpu_ns: Optional[int]) -> None:
    # stage_seconds is written once a span, at its end: readers that
    # watch the dict (a subclass logging each write) see whole spans
    s = stats.stage_seconds
    s[name] = s.get(name, 0.0) + (end_ns - start_ns) * 1e-9
    spans = stats.spans
    if spans is not None:
        # tuple.__new__ builds the same tuple several times faster than
        # the Python-level Span.__new__ that NamedTuple generates
        spans.append(tuple.__new__(Span, (
            name, stats.gof_index, parent, threading.get_ident(),
            start_ns, end_ns, cpu_ns)))


class stage_timer:
    """``with stage_timer(stats, name):`` records the block as a span of
    ``stats`` (a :class:`GofStats`), child of the span open around it on
    this thread. ``end_ns`` holds the span's end once the block is left."""

    __slots__ = ("stats", "name", "parent", "start_ns", "end_ns", "_cpu0")

    def __init__(self, stats: GofStats, name: str):
        self.stats, self.name = stats, name

    def __enter__(self) -> "stage_timer":
        stack = _open_stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self._cpu0 = time.thread_time_ns()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = self.end_ns = time.perf_counter_ns()
        cpu = time.thread_time_ns() - self._cpu0
        _open_stack().pop()
        _record(self.stats, self.name, self.parent, self.start_ns, end, cpu)
        return False


def record_span(stats: GofStats, name: str, start_ns: int,
                end_ns: Optional[int] = None) -> None:
    """Record a span that began at ``start_ns`` (``time.perf_counter_ns``),
    possibly on another thread, and ends at ``end_ns`` (now by default):
    no parent and no CPU time; written to ``stage_seconds`` as
    :class:`stage_timer` writes."""
    if end_ns is None:
        end_ns = time.perf_counter_ns()
    _record(stats, name, None, start_ns, end_ns, None)
