"""The benchmark's frozen copies against the program as it stands: the
traffic generator and the kernels' byte arithmetic."""

import json

import numpy as np
import pytest

from vpcc_bench import gen, roofline
from vpcc_bench.ref.recon import reconstruct_frame
from vpcc_bench.registry import ROOT

CONFIG = json.loads((ROOT / "vpcc_bench/configs/vpcc8i_1280.json").read_text())


@pytest.mark.parametrize("seed", [0, 7, 3_000_000_017])
def test_generator_equals_the_programs_example_frames(seed):
    from tpu_vpcc_torch.models.flagship import FlagshipConfig, example_frames

    small = dict(CONFIG, width=256, height=192,
                 content=dict(CONFIG["content"], n_patches=12))
    theirs = example_frames(FlagshipConfig(width=256, height=192, batch=3),
                            seed=seed, n_patches=12, occupancy_fill=0.7)
    ours = gen.make_pool(seed, small, 3)
    for a, b in zip(theirs, ours):
        assert np.array_equal(a.occ_plane, b.occ)
        for m in range(2):
            assert np.array_equal(a.geo_planes[m], b.geo[m])
            for x, y in zip(a.attr_planes[m], b.attr[m]):
                assert np.array_equal(x, y)
        assert len(a.meta.patches) == len(b.patches)
        for p, row in zip(a.meta.patches, b.patches):
            assert (p.uv0, p.size_uv0, p.uv1, p.d1, p.size_d) == (
                (row[gen.P_U0], row[gen.P_V0]),
                (row[gen.P_SU0], row[gen.P_SV0]),
                (row[gen.P_U1], row[gen.P_V1]), row[gen.P_D1],
                row[gen.P_SIZE_D])
            assert int(p.patch_orientation) == row[gen.P_ORIENT]
            assert p.axes == (row[gen.P_NORMAL], row[gen.P_TANGENT],
                              row[gen.P_BITANGENT])
            assert p.projection_mode == row[gen.P_MODE]


def test_owned_blocks_are_the_programs_groups():
    from tpu_vpcc_torch.atlas import groups as G
    from vpcc_bench import adapter

    small = dict(CONFIG, width=256, height=256,
                 content=dict(CONFIG["content"], n_patches=12))
    frames = gen.make_pool(11, small, 3)
    gof = adapter.gof_data(adapter.stage(frames, small), small)
    for f, meta in zip(frames, gof.metas):
        t = G.build_group_table(meta)
        assert int(t.fields[:, G.G_VALID].sum()) == roofline.owned_blocks(
            f.patches, 256, 256, 16)


@pytest.mark.parametrize("n", [1, 255, 256, 3058, 3245, 5000, 6400, 9000])
def test_bucket_equals_the_programs(n):
    from tpu_vpcc_torch.atlas.groups import bucket_group_count

    assert roofline.bucket(n, 6400) == bucket_group_count(n, 6400)


def test_first_flagship_gof_bytes_as_the_kernel_table_counts_them():
    """The first flagship GOF (seed 0, frames 0-1): K5 72,307,200 B, K1
    35,224,632 B, K1F 51,001,936 B, K2W 67,675,136 B, as the program's
    kernel table has them."""
    frames = gen.make_pool(0, CONFIG, 2)
    points = [len(reconstruct_frame(f.patches, f.occ, f.geo, f.attr, CONFIG,
                                    "cpu")[0]) for f in frames]
    assert points == [957_245, 1_014_918]
    b = roofline.gof_bytes(CONFIG, [f.patches for f in frames], points)
    assert b == {"k5": 72_307_200, "k1": 35_224_632, "k1f": 51_001_936,
                 "k2w": 67_675_136}
    assert roofline.bound_ms(b["k5"]) == pytest.approx(0.021584, abs=1e-6)


def test_pack_bytes_equal_the_programs_rule():
    import torch

    from tpu_vpcc_torch.tools.kernel_times import (pack_bytes, pack_config,
                                                   seeded_planes)

    F, nb, res, prec, cs, mc = 2, 6400, 16, 4, 1, 2
    planes = seeded_planes(mc, cs, res, prec, F, 0.3, nb,
                           torch.Generator().manual_seed(0))
    cfg = pack_config(mc, cs, res, prec, nb)
    assert pack_bytes(*planes, cfg) == F * roofline.pack_bytes_per_frame(
        CONFIG)
