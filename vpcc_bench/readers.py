"""What the per-layer metrics' readers (``metrics/<name>.py``) share.

A reader takes the traced run's record, a dict: ``frames`` and ``gofs``
decoded, ``spans`` (the program's stage spans, seconds summed over the
run's GOFs), ``trace`` (a :class:`vpcc_bench.trace.Trace`), ``busy_s``
and ``window_s``, ``bytes`` (what each kernel had to move over the run,
by kernel key, from :mod:`vpcc_bench.roofline`) and ``late_s`` (how
late each open-loop GOF was handed over). It returns a number, or None
where it finds nothing to read.
"""

from __future__ import annotations

from typing import Optional

from .roofline import HBM_BYTES_PER_S, KERNEL_NAMES
from .trace import short_name


def span_ms_per_frame(record: dict, span: str) -> Optional[float]:
    """A program stage's span, ms per frame decoded."""
    s = record["spans"].get(span)
    if s is None or not record["frames"]:
        return None
    return s * 1e3 / record["frames"]


def kernel_records(record: dict, key: str) -> list:
    name = KERNEL_NAMES[key]
    return [r for r in record["trace"].device
            if r.cat == "kernel" and short_name(r.name) == name]


def roofline_pct(record: dict, key: str) -> Optional[float]:
    """A kernel's share of its bound: the bytes it had to move over the
    run at the published HBM rate, over its device time."""
    recs = kernel_records(record, key)
    if not recs:
        return None
    device_s = sum(r.dur_us for r in recs) / 1e6
    return 100.0 * record["bytes"][key] / HBM_BYTES_PER_S / device_s


def idle_pct(record: dict) -> Optional[float]:
    """The share of the traced window with nothing on the device."""
    if not record["trace"].device or record["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
