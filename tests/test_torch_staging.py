"""Host staging of the PyTorch port (tpu_vpcc_torch.ops.tiled, host half)
against tpu_vpcc's: the packed cat and the field tables are byte-equal.

tpu_vpcc picks the host-packed, host-oriented cat only on a TPU
(``ops/tiled.py`` ``_mxu_policy``), so the reference side sets
TPU_VPCC_HOSTPACK=1 and TPU_VPCC_HOSTORIENT=1.
"""
from dataclasses import replace

import numpy as np
import pytest

from tpu_vpcc.atlas.groups import N_GROUP_FIELDS, bucket_group_count, build_group_table
from tpu_vpcc.atlas.patches import Patch
from tpu_vpcc.ops import tiled as ref_tiled
from tpu_vpcc.ops.reconstruct import make_config as ref_make_config
from tpu_vpcc.utils.synthetic import make_synthetic_frame
from tpu_vpcc.v3c.syntax import PatchOrientation
from tpu_vpcc_torch.ops import tiled as T
from tpu_vpcc_torch.ops.reconstruct import make_config

W = H = 64
RES = 8
PREC = 4


@pytest.fixture
def host_cat_env(monkeypatch):
    monkeypatch.setenv("TPU_VPCC_HOSTPACK", "1")
    monkeypatch.setenv("TPU_VPCC_HOSTORIENT", "1")


def _patch(uv0, size_uv0, orientation, view, d1, size_px=None):
    p = Patch(uv0=uv0, size_uv0=size_uv0, uv1=(8, 16),
              occupancy_resolution=RES, patch_orientation=orientation)
    p.set_view_id(view)
    p.d1 = d1
    p.size_d = 255
    p.size_2d_in_pixel = size_px
    return p


def _frames(seed, map_count=2, n_frames=2):
    """SWAP, MROT270 and DEFAULT patches, two of them with quantized
    (trimmed) pixel extents."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_frames):
        patches = [
            _patch((0, 0), (3, 2), PatchOrientation.SWAP, 0, 50, (20, 12)),
            _patch((4, 3), (2, 2), PatchOrientation.MROT270, 2, 10),
            _patch((0, 5), (2, 2), PatchOrientation.DEFAULT, 4, 30, (12, 16)),
        ]
        out.append(make_synthetic_frame(
            rng, width=W, height=H, occupancy_resolution=RES,
            occupancy_precision=PREC, map_count=map_count,
            patches=[replace(p) for p in patches], frame_index=k,
        ))
    return out


def _tiled_inputs(frames, map_count):
    """Bucketed fields, quantized trims and block-tiled planes."""
    tables = [build_group_table(sf.meta) for sf in frames]
    assert all(t.tiled_ok for t in tables)
    g_cap = (W // RES) * (H // RES)
    g_bucket = bucket_group_count(max(t.n_groups for t in tables), g_cap)
    fields = np.zeros((len(frames), g_bucket, N_GROUP_FIELDS), np.int32)
    trims = np.full((len(frames), g_bucket, 2), RES, np.int32)
    for k, t in enumerate(tables):
        fields[k, : t.n_groups] = t.fields[: t.n_groups]
        assert t.trim is not None
        trims[k, : t.n_groups] = t.trim[: t.n_groups]

    def stack(get):
        return np.stack([get(sf) for sf in frames])

    planes = (
        T.tile_plane(stack(lambda sf: sf.occ_plane), RES // PREC),
        T.tile_plane(stack(lambda sf: sf.geo_planes[0]), RES),
        T.tile_plane(stack(lambda sf: sf.geo_planes[min(1, map_count - 1)]), RES),
        T.tile_plane(stack(lambda sf: np.stack([p[0] for p in sf.attr_planes])), RES),
        T.tile_plane(stack(lambda sf: np.stack([p[1] for p in sf.attr_planes])), RES // 2),
        T.tile_plane(stack(lambda sf: np.stack([p[2] for p in sf.attr_planes])), RES // 2),
    )
    return fields, trims, planes


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("map_count", [1, 2])
def test_stage_cat_inputs_matches_reference(host_cat_env, monkeypatch, native,
                                            map_count):
    frames = _frames(7 + map_count, map_count=map_count)
    fields, trims, planes = _tiled_inputs(frames, map_count)
    kw = dict(width=W, height=H, occupancy_resolution=RES,
              occupancy_precision=PREC, map_count=map_count)
    ref_arrays, ref_cfg = ref_tiled.stage_cat_inputs(
        fields, *planes, ref_make_config(**kw), trims=trims
    )
    if not native:  # the exact numpy fallback of the C pack
        monkeypatch.setattr(T, "native_pack_available", lambda: False)
    (got_fields, got_cat), cfg = T.stage_cat_inputs(
        fields, *planes, make_config(**kw), trims=trims
    )
    assert ref_cfg.host_oriented and cfg.host_oriented
    assert ref_arrays[2:] == (None,) * 5
    np.testing.assert_array_equal(got_fields, ref_arrays[0])
    assert got_cat.dtype == np.uint32 and ref_arrays[1].dtype == np.uint32
    np.testing.assert_array_equal(got_cat, ref_arrays[1])
    # the trims cleared some occupancy bits (plane A bit 20)
    untrimmed, _ = T.stage_cat_inputs(fields, *planes, make_config(**kw))
    assert ((untrimmed[1] ^ got_cat) != 0).any()


def test_host_helpers_match_reference():
    rng = np.random.default_rng(3)
    plane = rng.integers(0, 1024, (2, 3, 32, 48), dtype=np.uint16)
    tiled = T.tile_plane(plane, 8)
    np.testing.assert_array_equal(tiled, ref_tiled.tile_plane(plane, 8))
    np.testing.assert_array_equal(T.untile_plane(tiled, 4, 6), plane)
    frames = _frames(11)
    fields, _, _ = _tiled_inputs(frames, 2)
    nb = (W // RES) * (H // RES)
    np.testing.assert_array_equal(
        T.swap_mask_host(fields, nb), ref_tiled.swap_mask_host(fields, nb)
    )
    for kw in (
        dict(occupancy_resolution=16, occupancy_precision=4),
        dict(occupancy_resolution=16, occupancy_precision=4, geo_shift=3),
        dict(occupancy_resolution=8, occupancy_precision=16),
        dict(occupancy_resolution=1, occupancy_precision=1),
    ):
        assert T.tiled_supported(make_config(64, 64, **kw)) == \
            ref_tiled.tiled_supported(ref_make_config(64, 64, **kw))


def test_narrow_gate():
    cfg = make_config(64, 64, 16, 4)
    assert T.narrow_emit_ok(cfg)
    for bad in (replace(cfg, smoothing=object()),
                replace(cfg, attr_smoothing=object()),
                replace(cfg, additional_planes=True)):
        assert not T.narrow_emit_ok(bad)
        # the pipeline sends these down the wide path; the narrow
        # dispatch refuses them
        with pytest.raises(ValueError, match="wide-path config"):
            T.reconstruct_batch_pretiled_packed(None, None, bad)
