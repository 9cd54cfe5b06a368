"""Decode statistics & stage timing (SURVEY.md §5 observability).

The reference stubbed out its bitstream ``Stat`` collector
(``src/bitstream.rs:17-45``, ``TODO[stat]`` markers); this is the working
equivalent: per-GOF stage timings, stream sizes, and point counts,
exposed on the Decoder as ``decoder.stats`` and loggable as one summary
line per GOF.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class GofStats:
    """Timings (seconds) and sizes for one decoded GOF."""

    gof_index: int = 0
    frame_count: int = 0
    total_points: int = 0
    video_bytes: Dict[str, int] = field(default_factory=dict)
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    #: event counters (e.g. ``mesh_fallback_dispatches`` when a
    #: mesh-configured decode degraded to single-device)
    counters: Dict[str, int] = field(default_factory=dict)

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


@contextmanager
def stage_timer(stats: GofStats, name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats.stage_seconds[name] = (
            stats.stage_seconds.get(name, 0.0) + time.perf_counter() - t0
        )
