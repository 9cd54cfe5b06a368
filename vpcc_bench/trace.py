"""What the device did in a traced run, from a ``torch.profiler`` trace.

The run wraps its timed part in a ``record_function`` span named
:data:`WINDOW`; the device records (kernels, copies, memsets) are
clipped to it. The trace is written to the run's temporary directory,
read and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Tuple

#: the span that marks the traced window
WINDOW = "vpcc_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class DeviceRecord:
    cat: str
    name: str
    start_us: float
    dur_us: float


@dataclass
class Trace:
    """The traced window and what ran in it."""

    window_us: Tuple[float, float]
    device: List[DeviceRecord] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6


def short_name(name: str) -> str:
    """A record's name without its namespace, template and argument
    list (``void ns::kernel<true>(int*)`` -> ``kernel``)."""
    name = name.replace("(anonymous namespace)::", "")
    head = (name.split("(", 1)[0] or name).strip()
    head = head.removeprefix("void ").split("<", 1)[0]
    return head.rsplit("::", 1)[-1].strip() or name


def from_events(events: list) -> Trace:
    """A :class:`Trace` from chrome-trace events."""
    win = [e for e in events if e.get("name") == WINDOW and "dur" in e
           and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
    if not win:
        raise ValueError(f"no {WINDOW!r} span in the trace")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    t = Trace(window_us=(w0, w1))
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        a, b = max(s, w0), min(s + d, w1)
        if b <= a:
            continue
        if e.get("cat") in DEVICE_CATS:
            t.device.append(DeviceRecord(e["cat"], e.get("name", ""), a,
                                         b - a))
        elif e.get("cat") == "cpu_op":
            t.host.append((e.get("name", ""), a, b))
    return t


def read_profile(prof) -> Trace:
    """Export ``prof``'s trace to the temporary directory, read it and
    delete the file."""
    fd, path = tempfile.mkstemp(prefix="vpcc_bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return from_events(events)


def busy_intervals(records) -> List[Tuple[float, float]]:
    """The union of the records' intervals, merged, in µs."""
    spans = sorted((r.start_us, r.start_us + r.dur_us) for r in records)
    out: List[List[float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace.device)) / 1e6


def top_device_ops(trace: Trace, n: int = 10) -> list:
    """The ``n`` device operations that took most time, by short name:
    ``[[name, seconds], ...]``."""
    tot: dict = {}
    for r in trace.device:
        key = short_name(r.name)
        tot[key] = tot.get(key, 0.0) + r.dur_us / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])][:n]


def idle_gaps(trace: Trace, spans=(), t0: float = 0.0, n: int = 10) -> list:
    """The ``n`` longest stretches of the window with nothing on the
    device, each named by what the host was doing: the program's stage
    span that overlapped it most (``spans``: ``(name, start, end, gof)``
    on the host clock, the window opening at host time ``t0``), else
    the torch operation that did, else ``host: no stage``. Returns
    ``[[name, seconds], ...]``."""
    busy = busy_intervals(trace.device)
    w0, w1 = trace.window_us
    edges = [w0] + [x for a, b in busy for x in (a, b)] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    stages = [(name, w0 + (a - t0) * 1e6, w0 + (b - t0) * 1e6)
              for name, a, b, _g in spans if name != "reconstruct"]
    outer = [(name, w0 + (a - t0) * 1e6, w0 + (b - t0) * 1e6)
             for name, a, b, _g in spans if name == "reconstruct"]
    host = [(f"torch {name}", a, b) for name, a, b in trace.host
            if name != WINDOW]
    out = []
    for a, b in gaps[:n]:
        label = "host: no stage"
        for pool in (stages, outer, host):
            best, best_len = None, 0.0
            for name, s, e in pool:
                ov = min(e, b) - max(s, a)
                if ov > best_len:
                    best, best_len = name, ov
            if best is not None:
                label = f"host: {best}"
                break
        out.append([label, (b - a) / 1e6])
    return out
