"""The wide path's grid smoothing, geometry and colour, as the host
enqueues it: the program's ``recon_smooth`` span (inside the dispatch's
enqueue), ms per frame. A program without the span gives None."""

from vpcc_bench.readers import span_ms_per_frame


def read(record):
    return span_ms_per_frame(record, "recon_smooth")
