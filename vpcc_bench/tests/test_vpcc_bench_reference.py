"""The plain reference against the program's numpy oracle, on small
frames of both configurations. The reference imports nothing of the
program; this test does, to compare."""

import ast
import json

import numpy as np
import pytest

from vpcc_bench import adapter, gen
from vpcc_bench.ref.recon import reconstruct_frame, yuv10_to_rgb8
from vpcc_bench.registry import HERE, ROOT


def small(name, size=192, patches=10):
    cfg = json.loads((ROOT / f"vpcc_bench/configs/{name}.json").read_text())
    return dict(cfg, width=size, height=size,
                content=dict(cfg["content"], n_patches=patches))


@pytest.mark.parametrize("name", ["vpcc8i_1280", "vpcc8i_1280_smooth"])
@pytest.mark.parametrize("seed", [3, 4_000_000_001])
def test_reference_equals_the_programs_oracle(name, seed):
    from tpu_vpcc_torch.runtime.host import _reconstruct_gof_oracle

    cfg = small(name)
    frames = gen.make_pool(seed, cfg, 2)
    gof = adapter.gof_data(adapter.stage(frames, cfg), cfg, tiled=False)
    for f, ps in zip(frames, _reconstruct_gof_oracle(gof)):
        pos, rgb = reconstruct_frame(f.patches, f.occ, f.geo, f.attr, cfg,
                                     "cpu")
        assert len(pos) > 1000
        assert np.array_equal(ps.positions, pos)
        assert np.array_equal(ps.colors, rgb)


def test_smoothing_moves_points_and_colours():
    plain, smooth = small("vpcc8i_1280"), small("vpcc8i_1280_smooth")
    f = gen.make_pool(5, plain, 1)[0]
    p0, c0 = reconstruct_frame(f.patches, f.occ, f.geo, f.attr, plain, "cpu")
    p1, c1 = reconstruct_frame(f.patches, f.occ, f.geo, f.attr, smooth, "cpu")
    assert p0.shape == p1.shape
    assert (p0 != p1).any(axis=1).sum() > 0
    assert (c0 != c1).any(axis=1).sum() > 100


def test_colour_conversion_equals_the_programs_f64_chain():
    import torch

    from tpu_vpcc_torch.reconstruction.pointset import convert_yuv10_to_rgb8

    rng = np.random.default_rng(0)
    yuv = rng.integers(0, 1024, (200_000, 3)).astype(np.uint16)
    # the triples whose f64 chain lands on a floor boundary
    from tpu_vpcc_torch.ops.color import _G_CHAIN_DEVIATIONS
    edge = np.array(list(_G_CHAIN_DEVIATIONS), dtype=np.uint16)
    yuv = np.concatenate([yuv, edge])
    ours = yuv10_to_rgb8(torch.as_tensor(yuv.astype(np.int64))).numpy()
    assert np.array_equal(ours, convert_yuv10_to_rgb8(yuv))


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "ref").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("tpu_vpcc", "tpu_vpcc_torch",
                                               "jax"), (path, n)
    # and what it imports from the harness is the generator's columns
    src = (HERE / "ref" / "recon.py").read_text()
    assert "from ..gen import" in src and "adapter" not in src
