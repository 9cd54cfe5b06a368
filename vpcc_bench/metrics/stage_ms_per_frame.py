"""Host staging (``ops.tiled``: stacks, occupancy tiling, swap mask): the
``recon_stage`` span, ms per frame."""

from vpcc_bench.readers import span_ms_per_frame


def read(record):
    return span_ms_per_frame(record, "recon_stage")
