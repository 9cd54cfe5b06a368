"""The share of the run's GOFs that the decode loop emitted while it
still awaited the next GOF (or the end of the stream): the program's
``emit_early`` counter, 1 on such a GOF and 0 on any other emitted GOF,
over the run's GOFs, in %. A program that keeps no such counter gives
None."""

from vpcc_bench.spans import run_stats


def read(record):
    stats = run_stats(record)
    if stats is None or not any("emit_early" in g.counters
                                for g in stats.gofs):
        return None
    early = sum(g.counters.get("emit_early", 0) for g in stats.gofs)
    return 100.0 * early / len(stats.gofs)
