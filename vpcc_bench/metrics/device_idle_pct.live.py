"""The device's idle share in the live cell: as ``device_idle_pct``."""

from vpcc_bench.readers import idle_pct


def read(record):
    return idle_pct(record)
