"""Time the GOF threads spent off the CPU in the host-only stages: wall
time minus the thread's CPU time over every ``recon_tables``,
``recon_stage`` and ``recon_emit`` span (mostly waiting for the
interpreter lock), ms per frame."""

from vpcc_bench.spans import run_spans, run_stats

HOST_STAGES = ("recon_tables", "recon_stage", "recon_emit")


def read(record):
    spans = run_spans(run_stats(record))
    if spans is None or not record["frames"]:
        return None
    host = [s for s in spans if s.name in HOST_STAGES and s.cpu_ns is not None]
    if not host:
        return None
    wait_ns = sum(s.end_ns - s.start_ns - s.cpu_ns for s in host)
    return wait_ns / 1e6 / record["frames"]
