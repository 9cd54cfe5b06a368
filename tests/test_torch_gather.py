"""The port's gather fallback against tpu_vpcc's, on the CPU.

tpu_vpcc side: ``ops.reconstruct.reconstruct_batch`` (XLA on the CPU)
and, through the fetch, ``runtime.pipeline._fetch_prefixes``. Port side:
the same numpy inputs carried across by ``inputs_from_reference``, then
``ops.reconstruct.reconstruct_batch`` (slot math, then K1F's plain
version) unpacked with the "gather" layout, and the port's fetch. Counts
must be equal and every frame's positions and colours byte-equal up to
its count. The cases follow the reference's own tests of the gather
kernel: every orientation (tests/test_orientations.py), the one- and
two-map, relative-D1, sparse and empty frames
(tests/test_reconstruct_jax.py), a bucketed group axis
(tests/test_bucketing.py), 4:4:4 chroma (tests/test_rgb444.py), 45-degree
views (tests/test_extended_projection.py), smoothing, and samples wider
than 10 bits.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from tpu_vpcc.atlas.groups import bucket_group_count, build_group_table
from tpu_vpcc.atlas.patches import Patch
from tpu_vpcc.ops import color as ref_color
from tpu_vpcc.ops import smoothing as ref_smoothing
from tpu_vpcc.ops.reconstruct import make_config
from tpu_vpcc.ops.reconstruct import reconstruct_batch as ref_reconstruct_batch
from tpu_vpcc.reconstruction.oracle import (
    GeneratePointCloudParams,
    generate_point_cloud,
)
from tpu_vpcc.runtime import pipeline as ref_pipeline
from tpu_vpcc.utils.synthetic import make_synthetic_frame
from tpu_vpcc.v3c.syntax import PatchOrientation
from tpu_vpcc_torch.ops import reconstruct as R
from tpu_vpcc_torch.ops import smoothing as S
from tpu_vpcc_torch.ops import tiled as T
from tpu_vpcc_torch.ops.color import rgb8_from_yuv16
from tpu_vpcc_torch.runtime import pipeline as P


def _inputs(frames, maps=(0, 1)):
    """The reference's gather inputs (fields, occ, geo0, geo1, ay, au,
    av) of synthetic frames, for the map pair ``maps`` (one map: a
    1-tuple)."""
    def one(sf):
        gt = build_group_table(
            sf.meta, occ_provider=lambda: sf.occ_plane,
            occ_precision=sf.occupancy_precision,
        )
        return (
            gt.fields, sf.occ_plane, sf.geo_planes[maps[0]],
            sf.geo_planes[maps[-1]],
            *(np.stack([sf.attr_planes[m][c] for m in maps]) for c in range(3)),
        )

    per = [one(sf) for sf in frames]
    return tuple(np.stack([p[i] for p in per]) for i in range(7))


def _cfg(sf, **kw):
    return make_config(
        width=sf.meta.width, height=sf.meta.height,
        occupancy_resolution=sf.occupancy_resolution,
        occupancy_precision=sf.occupancy_precision,
        map_count=sf.map_count, **kw,
    )


def _frames(seed, n_frames=1, width=64, res=8, prec=4, **kw):
    rng = np.random.default_rng(seed)
    return [
        make_synthetic_frame(
            rng, width=width, height=width, occupancy_resolution=res,
            occupancy_precision=prec, frame_index=k, **kw,
        )
        for k in range(n_frames)
    ]


def _compare(arrays, cfg_ref, color_mode="yuv10"):
    """Port vs reference on one set of gather inputs; returns counts."""
    pos_r, col_r, cnt_r = ref_reconstruct_batch(*arrays, cfg=cfg_ref)
    counts = np.asarray(cnt_r)
    fpos_r, fcol_r = ref_pipeline._fetch_prefixes(
        pos_r, col_r, counts, color_mode=color_mode
    )
    pos_r, col_r = np.asarray(pos_r), np.asarray(col_r)

    cfg, *tensors = T.inputs_from_reference(cfg_ref, arrays)
    ops, cnt = R.reconstruct_batch(*tensors, cfg)
    np.testing.assert_array_equal(cnt.numpy(), counts)
    pos, col = T._unpack_ops_points(ops, "gather")
    fpos, fcol = P._fetch_prefixes_packed(
        ops, counts, color_mode=color_mode, layout="gather"
    )
    assert fcol.dtype == fcol_r.dtype
    for f, n in enumerate(counts):
        np.testing.assert_array_equal(pos[f, :n].numpy(), pos_r[f, :n])
        np.testing.assert_array_equal(col[f, :n].numpy(), col_r[f, :n])
        np.testing.assert_array_equal(fpos[f, :n], fpos_r[f, :n])
        np.testing.assert_array_equal(fcol[f, :n], fcol_r[f, :n])
    return counts


# placements every orientation's range gate admits: a 2x2-block patch at
# blocks (2, 2) of a 64^2 canvas at resolution 16; at resolution 1 the
# reference decodes every orientation (tests/test_orientations.py)
_PLACEMENT = {
    16: dict(width=64, uv0=(2, 2), size_uv0=(2, 2), prec=4),
    1: dict(width=32, uv0=(11, 17), size_uv0=(5, 3), prec=1),
}


@pytest.mark.parametrize("res", sorted(_PLACEMENT))
@pytest.mark.parametrize("orientation", list(PatchOrientation),
                         ids=lambda o: o.name)
def test_orientation_matches_reference(orientation, res):
    pl = _PLACEMENT[res]
    patch = Patch(uv0=pl["uv0"], size_uv0=pl["size_uv0"], uv1=(40, 80),
                  occupancy_resolution=res, patch_orientation=orientation)
    patch.set_view_id(int(orientation) % 6)
    patch.d1 = 100 if patch.projection_mode == 0 else 900
    frames = _frames(int(orientation) + res, width=pl["width"], res=res,
                     prec=pl["prec"], patches=[patch])
    counts = _compare(_inputs(frames), _cfg(frames[0]))
    assert counts[0] > 0


def _geo12(arrays):
    """Geometry 12 bits wide: samples x4 (read with geo_shift 4)."""
    return arrays[:2] + tuple(a * 4 for a in arrays[2:4]) + arrays[4:]


def _attr12(arrays, seed):
    """Attributes 12 bits wide, drawn anew from ``seed``."""
    rng = np.random.default_rng(seed)
    return arrays[:4] + tuple(
        rng.integers(0, 4096, a.shape).astype(np.uint16) for a in arrays[4:]
    )


def _bucketed(arrays):
    n = int(arrays[0][:, :, 0].sum(axis=1).max())
    bucket = bucket_group_count(n, arrays[0].shape[1], min_bucket=1)
    assert bucket < arrays[0].shape[1], "too dense to exercise bucketing"
    return (np.ascontiguousarray(arrays[0][:, :bucket]),) + arrays[1:]


def _rgb444(frames, seed):
    """Full-resolution chroma planes (4:4:4)."""
    rng = np.random.default_rng(seed)
    for sf in frames:
        for planes in sf.attr_planes:
            for c in (1, 2):
                planes[c] = rng.integers(0, 1024, planes[0].shape).astype(
                    np.uint16)
    return frames


def _views45(frames, planes=(1, 2, 3, 1)):
    """Put a frame's first patches on the 45-degree ``planes``."""
    for sf in frames:
        for p, plane in zip(sf.meta.patches, planes):
            p.set_view_id(next(
                v for v, r in Patch._VIEW_TABLE.items()
                if r[0] == plane and r[4] == p.projection_mode
            ))
    return frames


def _empty(frames):
    frames[0].occ_plane[:] = 0
    return frames


GEO_SMOOTH = ref_smoothing.SmoothingConfig(grid_size=8, threshold=16)
ATTR_SMOOTH = ref_smoothing.AttrSmoothingConfig(8, 255, 1)

# name: (frames, maps, cfg changes, arrays transform, colour mode)
CASES = {
    "two_maps_two_frames": (lambda: _frames(1, 2, n_patches=4), (0, 1), {},
                            None, "yuv10"),
    "one_map": (lambda: _frames(2, map_count=1, prec=2, n_patches=3), (0,),
                {}, None, "yuv10"),
    "relative_d1": (lambda: _frames(3, 2, n_patches=4), (0, 1),
                    {"absolute_d1": False}, None, "yuv10"),
    "drop_map0": (lambda: _frames(4, 2, map_count=3, n_patches=3), (1, 2),
                  {"drop_map0": True}, None, "yuv10"),
    "res16_prec4_three_frames": (
        lambda: _frames(5, 3, width=128, res=16, n_patches=5), (0, 1), {},
        None, "yuv10"),
    "rgb444": (lambda: _rgb444(_frames(6, n_patches=3), 6), (0, 1),
               {"chroma_shift": 0}, None, "rgb16"),
    "views45": (lambda: _views45(_frames(7, n_patches=4)), (0, 1),
                {"additional_planes": True}, None, "yuv10"),
    # geometry and colour smoothing, two frames (one grid each), half of
    # the patches on 45-degree views: rotated before smoothing
    "smoothing_views45": (
        lambda: _views45(_frames(9, 2, n_patches=4), planes=(2, 3)),
        (0, 1), {"additional_planes": True, "smoothing": GEO_SMOOTH,
                 "attr_smoothing": ATTR_SMOOTH}, None, "yuv10"),
    "geo12": (lambda: _frames(10, 2, n_patches=4), (0, 1), {"geo_shift": 4},
              _geo12, "yuv10"),
    "attr12": (lambda: _frames(11, 2, n_patches=4), (0, 1), {},
               lambda a: _attr12(a, 11), "yuv10"),
    "attr12_raw": (lambda: _frames(12, n_patches=4), (0, 1), {},
                   lambda a: _attr12(a, 12), "raw"),
    "bucketed": (lambda: _frames(13, n_patches=3), (0, 1), {}, _bucketed,
                 "yuv10"),
    "sparse": (lambda: _frames(14, n_patches=3, occupancy_fill=0.15),
               (0, 1), {}, None, "yuv10"),
    "empty_frame": (lambda: _empty(_frames(15, 2, n_patches=3)), (0, 1), {},
                    None, "yuv10"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_matches_reference(case):
    make, maps, changes, transform, color_mode = CASES[case]
    frames = make()
    arrays = _inputs(frames, maps)
    if transform is not None:
        arrays = transform(arrays)
    cfg = _cfg(frames[0], **changes)
    cfg = replace(cfg, map_count=len(maps))
    counts = _compare(arrays, cfg, color_mode)
    if case == "empty_frame":
        assert counts[0] == 0 and counts[1] > 0
    else:
        assert counts.min() > 0


def test_gather_matches_oracle():
    """A two-frame rotated case against the numpy oracle too."""
    patches = []
    for o, uv0 in ((PatchOrientation.ROT90, (2, 0)),
                   (PatchOrientation.DEFAULT, (0, 0))):
        p = Patch(uv0=uv0, size_uv0=(2, 2), uv1=(10, 20),
                  occupancy_resolution=16, patch_orientation=o)
        p.set_view_id(1)
        p.d1 = 100
        patches.append(p)
    frames = _frames(21, 2, res=16, patches=patches)
    arrays = _inputs(frames)
    cfg_ref = _cfg(frames[0])
    cfg, *tensors = T.inputs_from_reference(cfg_ref, arrays)
    ops, counts = R.reconstruct_batch(*tensors, cfg)
    pos, col = T._unpack_ops_points(ops, "gather")
    params = GeneratePointCloudParams(
        occupancy_resolution=16, occupancy_precision=4, map_count_minus1=1)
    geo = [p for sf in frames for p in sf.geo_planes]
    attr = [a for sf in frames for a in sf.attr_planes]
    for k, sf in enumerate(frames):
        ps, _, _ = generate_point_cloud(
            sf.meta, params, sf.occ_plane, geo, [attr])
        n = int(counts[k])
        assert n == ps.point_count > 0
        np.testing.assert_array_equal(pos[k, :n].numpy(), ps.positions)
        np.testing.assert_array_equal(col[k, :n].numpy(), ps.colors16bit)


@pytest.mark.parametrize("seed", [0, 1])
def test_smooth_flat_matches_reference(seed):
    """The flat smoothing drivers on slots whose frame index is not
    contiguous, against tpu_vpcc's ``smooth_flat`` and
    ``smooth_colors_flat``."""
    rng = np.random.default_rng(seed)
    n, F = 4000, 3
    xs, ys, zs = (rng.integers(0, 64, n).astype(np.int32) for _ in range(3))
    cy, cu, cv = (rng.integers(0, 4096, n).astype(np.int32) for _ in range(3))
    valid = rng.random(n) < 0.8
    pid = rng.integers(0, 3, n).astype(np.int32)
    frame = rng.integers(0, F, n).astype(np.int32)
    # 6-bit coordinates: a 16^3 grid a frame
    geo = ref_smoothing.SmoothingConfig(grid_size=4, threshold=4,
                                        geometry_bitdepth_3d=6)
    attr = ref_smoothing.AttrSmoothingConfig(4, 4096, 1,
                                             geometry_bitdepth_3d=6)
    want = ref_smoothing.smooth_flat(xs, ys, zs, valid, pid, frame, F, geo)
    t = torch.from_numpy
    got = S.smooth_flat(t(xs), t(ys), t(zs), t(valid), t(pid), t(frame), F,
                        geo)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert any((g.numpy() != a).any() for g, a in zip(got, (xs, ys, zs)))
    want = ref_smoothing.smooth_colors_flat(
        xs, ys, zs, cy, cu, cv, valid, pid, frame, F, attr)
    got = S.smooth_colors_flat(t(xs), t(ys), t(zs), t(cy), t(cu), t(cv),
                               t(valid), t(pid), t(frame), F, attr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert any((g.numpy() != a).any() for g, a in zip(got, (cy, cu, cv)))


def test_rgb8_from_yuv16_up_to_16_bits():
    """Samples past 10 bits index the colour tables as the JAX function's
    clamped gathers do (s_r, s_b per value, packed_g at the one flat
    index u*1024+v), and y past 10,912 shifts the mask bits by 32 or
    more."""
    rng = np.random.default_rng(5)
    yuv = rng.integers(0, 1 << 16, (100_000, 3), dtype=np.uint16)
    for k, bits in enumerate((10, 11, 12, 13)):  # the rest keeps 16 bits
        yuv[k * 20_000 : (k + 1) * 20_000] >>= 16 - bits
    edges = np.array(
        [[y, u, v] for y in (0, 1023, 1024, 2727, 2728, 10911, 10912, 65535)
         for u in (0, 1023, 1024, 1025, 65535)
         for v in (0, 1023, 1024, 65535)], dtype=np.uint16)
    yuv = np.concatenate([yuv, edges])
    want = np.asarray(ref_color.rgb8_from_yuv16(yuv))
    got = rgb8_from_yuv16(torch.from_numpy(yuv.astype(np.int32)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_wide_attribute_conversion_follows_device_path():
    """Past 10 bits tpu_vpcc's device conversion (clamped tables) and
    its oracle's f64 chain disagree; the port follows the device path."""
    from tpu_vpcc.reconstruction.pointset import convert_yuv10_to_rgb8

    yuv = np.array([[49, 1982, 1042], [2394, 3216, 3935]], dtype=np.uint16)
    got = rgb8_from_yuv16(torch.from_numpy(yuv.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_color.rgb8_from_yuv16(yuv)))
    assert (got != convert_yuv10_to_rgb8(yuv)).any(axis=1).all()


def test_gather_words_refuses_planes_too_small():
    """A plane that does not cover the canvas would be indexed past its
    end (a device fault on CUDA): refused before any gather."""
    frames = _frames(31, n_patches=2)
    cfg, *t = T.inputs_from_reference(_cfg(frames[0]), _inputs(frames))
    R.gather_words(*t, cfg)
    for k, name in ((1, "occ"), (2, "geo0"), (5, "attr_u")):
        bad = list(t)
        bad[k] = t[k][..., :-1, :].contiguous()
        with pytest.raises(ValueError, match=name):
            R.gather_words(*bad, cfg)
    bad = list(t)
    bad[4] = t[4].to(torch.int32)
    with pytest.raises(ValueError, match="attr_y"):
        R.gather_words(*bad, cfg)


@pytest.mark.cuda
def test_gather_dispatch_on_card_matches_cpu():
    """The gather dispatch on the card (slot math, then K1F) against its
    CPU run on the same inputs: 45-degree views, smoothing, 12-bit
    attributes (the rotated GOFs are ``test_torch_e2e``'s); counts equal
    and prefixes byte-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")
    from tpu_vpcc_torch.ops import shift_compact as sc

    frames = _views45(_frames(41, 2, width=128, res=16, n_patches=6))
    arrays = _attr12(_inputs(frames), 41)
    cfg, *cpu = T.inputs_from_reference(
        _cfg(frames[0], additional_planes=True, smoothing=GEO_SMOOTH,
             attr_smoothing=ATTR_SMOOTH), arrays)
    ops_c, n_c = R.reconstruct_batch(*cpu, cfg)
    before = sc.full_launches
    ops_g, n_g = R.reconstruct_batch(*(t.cuda() for t in cpu), cfg)
    torch.cuda.synchronize()
    assert sc.full_launches == before + 1
    assert torch.equal(n_g.cpu(), n_c) and int(n_c.min()) > 0
    for a, b in zip(ops_g, ops_c):
        for f, n in enumerate(n_c.tolist()):
            assert torch.equal(a[f, :n].cpu(), b[f, :n])
    pos_g, col_g = P._fetch_prefixes_packed(ops_g, n_c.numpy(), "yuv10",
                                            layout="gather")
    pos_c, col_c = P._fetch_prefixes_packed(ops_c, n_c.numpy(), "yuv10",
                                            layout="gather")
    for f, n in enumerate(n_c.tolist()):
        np.testing.assert_array_equal(pos_g[f, :n], pos_c[f, :n])
        np.testing.assert_array_equal(col_g[f, :n], col_c[f, :n])
