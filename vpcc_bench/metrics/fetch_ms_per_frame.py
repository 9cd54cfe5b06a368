"""Fetch and colour conversion (``ops.color``, D2H): the ``recon_fetch``
span, ms per frame."""

from vpcc_bench.readers import span_ms_per_frame


def read(record):
    return span_ms_per_frame(record, "recon_fetch")
