"""K1F's share of its bound: the bytes it must move over the run
(``vpcc_bench.roofline``) at the published 3.35 TB/s, over its
device time in the trace, in %."""

from vpcc_bench.readers import roofline_pct


def read(record):
    return roofline_pct(record, "k1f")
