"""Group tables (``runtime.pipeline``, ``atlas.groups``): the ``recon_tables``
span, ms per frame."""

from vpcc_bench.readers import span_ms_per_frame


def read(record):
    return span_ms_per_frame(record, "recon_tables")
