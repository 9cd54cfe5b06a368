"""The decode loop's hold: the program's ``emit_hold`` span, from a GOF's
reconstruction's end to the first of its frames put on the queue, ms,
mean over the GOFs that have it."""

from vpcc_bench.spans import gof_values, run_stats


def read(record):
    held = gof_values(run_stats(record), "emit_hold")
    return sum(held) * 1e3 / len(held) if held else None
