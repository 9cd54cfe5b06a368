"""The device's idle share: 1 - (union of kernel, memcpy and memset
records) / the traced window, in %."""

from vpcc_bench.readers import idle_pct


def read(record):
    return idle_pct(record)
