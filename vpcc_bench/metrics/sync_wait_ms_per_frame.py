"""The dispatch's wait for the device: the program's ``recon_sync`` span
(the point counts copied back, which waits for the work enqueued before
them), ms per frame."""

from vpcc_bench.readers import span_ms_per_frame


def read(record):
    return span_ms_per_frame(record, "recon_sync")
