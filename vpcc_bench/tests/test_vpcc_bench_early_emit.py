"""The reader of the program's ``emit_early`` counter,
``early_emit_pct.live``: its value on hand-made statistics, None for a
program without the counter, the run it finds through ``per_layer``, and
a traced live run on the CPU reporting it."""

from dataclasses import dataclass, field

import pytest

from vpcc_bench import run
from vpcc_bench.registry import Bench

METRIC = "early_emit_pct.live"


def _stats(counts):
    """A run's ``DecodeStats`` with one GOF per entry of ``counts``: the
    GOF's ``emit_early``, or None for a GOF never emitted."""
    from tpu_vpcc_torch.utils.stats import DecodeStats

    st = DecodeStats()
    for n in counts:
        g = st.new_gof()
        g.count("h2d_bytes", 1000)
        if n is not None:
            g.count("emit_early", n)
    return st


@pytest.mark.parametrize("counts,want", [
    ([1, 1, 1, 0], 75.0),
    ([0, 0], 0.0),
    ([1, 0, None], 100.0 / 3),
])
def test_share_of_the_runs_gofs_emitted_early(counts, want):
    got = Bench().reader(METRIC)({"stats": _stats(counts)})
    assert got == pytest.approx(want, rel=1e-12)


@dataclass
class _OldGof:
    """A GOF's statistics as a program without the counter keeps them."""

    gof_index: int = 0
    counters: dict = field(default_factory=dict)


@dataclass
class _OldStats:
    gofs: list = field(default_factory=list)


@pytest.mark.parametrize("record", [
    {"stats": _OldStats([_OldGof(k, {"h2d_bytes": 10}) for k in range(3)])},
    {"stats": _OldStats([])},
    {"stats": None},
    {},
], ids=["without-the-counter", "no-gofs", "no-stats", "outside-a-run"])
def test_none_where_the_program_keeps_no_counter(record):
    assert Bench().reader(METRIC)(record) is None


def test_reads_the_run_that_per_layer_reads():
    class Timed:
        stats = _stats([1, 0])
        t_start, t_end = 10.0, 11.0

    def per_layer(timed, record):
        return Bench().reader(METRIC)(record)

    assert per_layer(Timed(), {}) == pytest.approx(50.0)


def test_a_traced_live_run_reports_the_share(tiny_bench):
    """The harness as it is, on the CPU: the counter reaches the live
    cell's result line, a share of the run's GOFs."""
    r = run.run_cell(tiny_bench, "narrow_live30", 2_900_000_047, 0.6, True,
                     device="cpu")
    assert r["correct"] is True
    share = r["metrics"][METRIC]
    assert share["unit"] == "%" and 0.0 <= share["value"] <= 100.0
