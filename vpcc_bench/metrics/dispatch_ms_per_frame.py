"""Dispatch (H2D, the device work, the sync): the ``recon_dispatch`` span,
ms per frame."""

from vpcc_bench.readers import span_ms_per_frame


def read(record):
    return span_ms_per_frame(record, "recon_dispatch")
