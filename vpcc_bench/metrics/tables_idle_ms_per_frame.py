"""Device idle time while tables are built: the part of the union of the
program's ``recon_tables`` spans, mapped onto the trace's clock, with
nothing on the device (the complement of ``trace.busy_intervals``), ms
per frame."""

from vpcc_bench.spans import host_window, overlap, run_spans, run_stats, \
    to_trace_us
from vpcc_bench.trace import DeviceRecord, busy_intervals


def read(record):
    spans = run_spans(run_stats(record))
    window = host_window(record)
    if spans is None or window is None or not record["frames"]:
        return None
    trace = record["trace"]
    tables = [s for s in spans if s.name == "recon_tables"]
    if not tables or not trace.device:
        return None
    at = to_trace_us(record, window)
    w0, w1 = trace.window_us
    clipped = [(s.name, max(at(s.start_ns), w0), min(at(s.end_ns), w1))
               for s in tables]
    mapped = busy_intervals(DeviceRecord("span", name, a, b - a)
                            for name, a, b in clipped if b > a)
    inside = sum(b - a for a, b in mapped)
    idle_us = inside - overlap(mapped, busy_intervals(trace.device))
    return idle_us / 1e3 / record["frames"]
