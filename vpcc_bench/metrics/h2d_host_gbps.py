"""The host-to-device copy rate as the host sees it: the program's
``h2d_bytes`` counter over its ``recon_h2d`` time, summed over the run's
GOFs, in GB/s."""

from vpcc_bench.spans import gof_values, run_stats


def read(record):
    stats = run_stats(record)
    if stats is None:
        return None
    n = sum(g.counters.get("h2d_bytes", 0) for g in stats.gofs)
    s = sum(gof_values(stats, "recon_h2d"))
    if not n or s <= 0:
        return None
    return n / s / 1e9
