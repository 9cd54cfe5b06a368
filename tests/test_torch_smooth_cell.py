"""The benchmark's smoothed cell, ``smooth_gof32_max``, end to end on the
CPU at the tiny deployment (``vpcc_bench.tests.conftest.tiny_root``):
through the harness's normal path, ``run.run_cell``, the program's wide
path is held to the plain reference frame by frame.

Seed 3000010208 makes a pool whose frame 0 has points on the smoothing
grid's far edge (z = grid_size * grid_width = 1024) and whose frame 1,
decoded in the same dispatch, has points low in z under them: a grid
clipped over both frames instead of within each moves frame 1's points
and colours, and the run comes out not correct.
"""

import json

import numpy as np
import pytest

from vpcc_bench import gen, run
from vpcc_bench.ref.recon import reconstruct_frame
from vpcc_bench.registry import HERE, Bench
from vpcc_bench.tests.conftest import tiny_root

CELL = "smooth_gof32_max"
EDGE_SEED = 3_000_010_208


@pytest.fixture
def bench(tmp_path):
    return Bench(tiny_root(tmp_path), HERE)


def test_the_seed_puts_points_on_the_far_edge_before_a_frame_low_in_z(bench):
    config = bench.config(bench.cell(CELL)["config"])
    grid = config["geo_smoothing"]["grid_size"]
    edge = grid * -(-(1 << config["geometry_bitdepth_3d"]) // grid)
    unsmoothed = dict(config, geo_smoothing=None, attr_smoothing=None)
    pos = [np.asarray(reconstruct_frame(f.patches, f.occ, f.geo, f.attr,
                                        unsmoothed, "cpu")[0], np.int64)
           for f in gen.make_pool(EDGE_SEED, config, 2)]
    on_edge = pos[0][pos[0][:, 2] == edge]
    assert len(on_edge) > 0
    cells = {(x // grid, y // grid) for x, y, _ in on_edge}
    low = pos[1][pos[1][:, 2] < 2 * grid]
    assert any(abs(x // grid - a) <= 1 and abs(y // grid - b) <= 1
               for x, y, _ in low for a, b in cells)


@pytest.mark.parametrize("trace", [False, True])
def test_smoothed_cell_is_correct_across_the_far_edge(bench, trace):
    r = run.run_cell(bench, CELL, EDGE_SEED, 0.3, trace, device="cpu")
    assert r["checks"] == {"frames_wrong": {"value": 0, "limit": 0},
                           "frames_missing": {"value": 0, "limit": 0}}
    assert r["correct"] is True and r["attempted"] >= 8
    if trace:
        # the program's smoothing span, read on any device
        assert r["metrics"]["smooth_ms_per_frame"]["value"] > 0
    else:
        assert r["metrics"]["frames_per_s"]["value"] > 0
    json.dumps(r)


def test_smooth_reader_needs_the_span():
    read = Bench().reader("smooth_ms_per_frame")
    spans = {"recon_enqueue": 0.5, "recon_dispatch": 0.75}
    assert read({"spans": spans, "frames": 10}) is None
    assert read({"spans": dict(spans, recon_smooth=0.25),
                 "frames": 10}) == pytest.approx(25.0)
    assert read({"spans": {"recon_smooth": 0.25}, "frames": 0}) is None
