"""Host-to-device copies as the host waits for them: the program's
``recon_h2d`` span (the dispatch's staged arrays sent to the device, and
K5's launch), ms per frame."""

from vpcc_bench.readers import span_ms_per_frame


def read(record):
    return span_ms_per_frame(record, "recon_h2d")
