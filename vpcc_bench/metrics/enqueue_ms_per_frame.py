"""The dispatch's enqueue: the program's ``recon_enqueue`` span (the
gather, the words and K1 launched on the device's inputs), ms per
frame."""

from vpcc_bench.readers import span_ms_per_frame


def read(record):
    return span_ms_per_frame(record, "recon_enqueue")
