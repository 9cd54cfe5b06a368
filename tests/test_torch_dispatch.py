"""The port's device dispatch and fetch against tpu_vpcc's.

tpu_vpcc side: ``stage_cat_inputs`` (with the host-pack and host-orient
knobs the TPU would pick), ``reconstruct_batch_pretiled_packed`` with its
default sort compaction on the CPU (one case forces the Pallas shift
kernel, interpreted) and ``_fetch_prefixes_packed``. Port side: the same
staged arrays carried across by ``inputs_from_reference``, then its own
dispatch and fetch on torch CPU tensors. Positions and colours of every
frame must be byte-equal up to the frame's count.

The device-pack cases drop those knobs: tpu_vpcc then runs its own CPU
default on the raw block-tiled arrays (the pack and the orientation fix
on the device), and the port runs both of its stagings through
``pipeline._dispatch_device``, the device pack (K5's plain version) and
the host pack.
"""
from contextlib import contextmanager
from dataclasses import replace
from unittest import mock

import numpy as np
import pytest
import torch

from tpu_vpcc.models import flagship as ref_flagship
from tpu_vpcc.ops import tiled as ref_tiled
from tpu_vpcc.runtime import pipeline as ref_pipeline
from tpu_vpcc.utils.synthetic import make_synthetic_frame
from tpu_vpcc_torch.models import flagship as port_flagship
from tpu_vpcc_torch.ops import tiled as T
from tpu_vpcc_torch.runtime import pipeline as P

W = H = 128
RES = 16
PREC = 4


@pytest.fixture(autouse=True)
def host_cat_env(monkeypatch):
    monkeypatch.setenv("TPU_VPCC_HOSTPACK", "1")
    monkeypatch.setenv("TPU_VPCC_HOSTORIENT", "1")


def _frames(seed, map_count, n_frames=2):
    rng = np.random.default_rng(seed)
    return [
        make_synthetic_frame(
            rng, width=W, height=H, occupancy_resolution=RES,
            occupancy_precision=PREC, map_count=map_count, n_patches=6,
            frame_index=k,
        )
        for k in range(n_frames)
    ]


def _tiled(frames, maps, chroma_full=False):
    """(fields, occ, geo0, geo1, ay, au, av), block-tiled, for the map
    pair ``maps`` (a 1-tuple for single-map content). ``chroma_full``
    upsamples chroma to 4:4:4."""
    fcfg = port_flagship.FlagshipConfig(W, H, RES, PREC, map_count=len(maps),
                                        batch=len(frames))
    raw = list(port_flagship.example_batch_inputs(fcfg, frames=frames))
    geo = [np.stack([sf.geo_planes[m] for sf in frames]) for m in maps]
    raw[2], raw[3] = geo[0], geo[-1]
    for i in (4, 5, 6):
        raw[i] = np.stack(
            [np.stack([sf.attr_planes[m][i - 4] for m in maps]) for sf in frames]
        )
    cs = 1
    if chroma_full:
        cs = 0
        raw[5] = raw[5].repeat(2, axis=-2).repeat(2, axis=-1)
        raw[6] = raw[6].repeat(2, axis=-2).repeat(2, axis=-1)
    raw, _, _, _ = port_flagship.bucket_flagship_inputs(
        tuple(raw), fcfg.frame_config()
    )
    tiled = (
        raw[0],
        T.tile_plane(raw[1], RES // PREC),
        T.tile_plane(raw[2], RES),
        T.tile_plane(raw[3], RES),
        T.tile_plane(raw[4], RES),
        T.tile_plane(raw[5], RES >> cs),
        T.tile_plane(raw[6], RES >> cs),
    )
    return tiled, cs


def _compare(tiled, cfg_ref, color_mode):
    arrays, cfg_ref = ref_tiled.stage_cat_inputs(*tiled, cfg_ref)
    ops, counts = ref_tiled.reconstruct_batch_pretiled_packed(*arrays, cfg=cfg_ref)
    counts = np.asarray(counts)
    pos_r, col_r = ref_pipeline._fetch_prefixes_packed(ops, counts, color_mode)

    cfg, fields, cat = T.inputs_from_reference(cfg_ref, arrays, device="cpu")
    assert cfg.host_oriented and cfg.pack30 == cfg_ref.pack30
    ops_p, counts_p = T.reconstruct_batch_pretiled_packed(fields, cat, cfg)
    counts_p = counts_p.numpy()
    np.testing.assert_array_equal(counts_p, counts)
    assert len(ops_p) == (2 if cfg.pack30 else 3)
    pos, col = P._fetch_prefixes_packed(ops_p, counts_p, color_mode)
    assert pos.dtype == pos_r.dtype and col.dtype == col_r.dtype
    for f, n in enumerate(counts):
        np.testing.assert_array_equal(pos[f, :n], pos_r[f, :n])
        np.testing.assert_array_equal(col[f, :n], col_r[f, :n])
    assert counts.min() > 0
    return counts


CASES = {
    # name: (map_count of the content, maps dispatched, cfg changes,
    #        4:4:4 chroma, colour mode)
    "pack30": (2, (0, 1), {}, False, "yuv10"),
    "split": (2, (0, 1), {"pack30": False}, False, "yuv10"),
    "relative_d1": (2, (0, 1), {"pack30": False, "absolute_d1": False},
                    False, "yuv10"),
    "raw_colors": (2, (0, 1), {}, False, "raw"),
    "chroma444": (2, (0, 1), {"chroma_shift": 0}, True, "rgb16"),
    "one_map": (1, (0,), {"map_count": 1}, False, "yuv10"),
    "three_maps_layer": (3, (1, 2), {"drop_map0": True}, False, "yuv10"),
    "shift_kernel": (2, (0, 1), {"shift_compact": 8192}, False, "yuv10"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dispatch_and_fetch_match_reference(case):
    mc, maps, changes, chroma_full, color_mode = CASES[case]
    frames = _frames(seed=len(case), map_count=mc)
    tiled, cs = _tiled(frames, maps, chroma_full)
    fcfg = ref_flagship.FlagshipConfig(W, H, RES, PREC)
    _, cfg_ref, _, _ = ref_flagship.bucket_flagship_inputs(
        (tiled[0],), fcfg.frame_config()
    )
    cfg_ref = replace(cfg_ref, shift_compact=0, sort_split=1,
                      sort_split_batched=False, chroma_shift=cs)
    cfg_ref = replace(cfg_ref, **changes)
    if case == "pack30":
        assert cfg_ref.pack30
    _compare(tiled, cfg_ref, color_mode)


def test_flagship_inputs_match_reference():
    fcfg = ref_flagship.FlagshipConfig(W, H, RES, PREC, batch=2)
    pcfg = port_flagship.FlagshipConfig(W, H, RES, PREC, batch=2)
    ref = ref_flagship.example_pretiled_batch_inputs(fcfg, seed=4, n_patches=6)
    got = port_flagship.example_pretiled_batch_inputs(pcfg, seed=4, n_patches=6)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    r_raw, r_cfg, r_bucket, r_live = ref_flagship.bucket_flagship_inputs(
        ref, fcfg.frame_config()
    )
    g_raw, g_cfg, g_bucket, g_live = port_flagship.bucket_flagship_inputs(
        got, pcfg.frame_config()
    )
    assert (r_bucket, r_live, r_cfg.pack30) == (g_bucket, g_live, g_cfg.pack30)
    np.testing.assert_array_equal(r_raw[0], g_raw[0])


def test_inputs_from_reference_rejects_unported_layouts():
    from tpu_vpcc.ops.reconstruct import make_config as ref_make_config
    from tpu_vpcc_torch.v3c.syntax import UnsupportedFeature

    cfg = ref_make_config(W, H, RES, PREC)
    fields = np.zeros((1, 4, 21), np.int32)
    cat = np.zeros((1, 64, 3 * RES * RES), np.uint32)
    with pytest.raises(UnsupportedFeature):
        T.inputs_from_reference(replace(cfg, cell_groups=True),
                                (fields, cat) + (None,) * 5)
    with pytest.raises(ValueError):
        T.inputs_from_reference(cfg, (fields, cat, cat) + (None,) * 4)


def _ref_case(case):
    """The raw block-tiled arrays and tpu_vpcc's config of a CASES case."""
    mc, maps, changes, chroma_full, color_mode = CASES[case]
    frames = _frames(seed=len(case), map_count=mc)
    tiled, cs = _tiled(frames, maps, chroma_full)
    fcfg = ref_flagship.FlagshipConfig(W, H, RES, PREC)
    _, cfg_ref, _, _ = ref_flagship.bucket_flagship_inputs(
        (tiled[0],), fcfg.frame_config()
    )
    cfg_ref = replace(cfg_ref, shift_compact=0, sort_split=1,
                      sort_split_batched=False, chroma_shift=cs)
    return tiled, replace(cfg_ref, **changes), color_mode


def port_cfg(cfg_ref):
    """The port's FrameConfig of tpu_vpcc's, field by field."""
    from dataclasses import fields as dc_fields

    from tpu_vpcc_torch.ops.reconstruct import FrameConfig

    return FrameConfig(**{f.name: getattr(cfg_ref, f.name)
                          for f in dc_fields(FrameConfig)})


def count_plain_packs(monkeypatch):
    """A list that grows by one at each call of K5's plain version."""
    from tpu_vpcc_torch.ops import pack

    calls = []
    real = pack.pack_cat_plain
    monkeypatch.setattr(pack, "pack_cat_plain",
                        lambda *a: calls.append(1) or real(*a))
    return calls


def host_packed(di):
    """A device-pack dispatch staged again as the port stages quantized
    extents: the cat packed on the host from the same planes."""
    fields, *planes, _swap = di.arrays
    arrays, cfg = T.stage_cat_inputs(fields, *planes, di.cfg)
    return replace(di, cfg=cfg, staging="host_pack", arrays=arrays)


@contextmanager
def host_pack_staging(only=lambda gof: True):
    """While open, every dispatch of a GOF (``only(gof)``) that
    ``pipeline`` and ``batcher`` stage for the device pack is staged by
    the host pack instead (:func:`host_packed`). Yields the list of the
    dispatches so staged."""
    from tpu_vpcc_torch.parallel import batcher

    real = P._gof_device_inputs
    staged = []

    def stage(gof, *args, **kw):
        di = real(gof, *args, **kw)
        if di.staging != "device_pack" or not only(gof):
            return di
        staged.append(host_packed(di))
        return staged[-1]

    with mock.patch.object(P, "_gof_device_inputs", stage), \
            mock.patch.object(batcher, "_gof_device_inputs", stage):
        yield staged


def dispatch_both_stagings(tiled, cfg, color_mode, monkeypatch):
    """The port's dispatch of ``tiled`` through ``_dispatch_device`` on
    the CPU, device-packed and host-packed: ``{staging: frames}``, each
    frame a host ``(positions, colours)``. The plain pack runs once, on
    the device-packed dispatch."""
    calls = count_plain_packs(monkeypatch)
    arrays, scfg = T.stage_plane_inputs(*tiled, cfg)
    assert scfg.host_oriented
    di = P.DeviceInputs(cfg=scfg, staging="device_pack", arrays=arrays,
                        n_frames=tiled[0].shape[0], color_mode=color_mode)
    outs = {}
    for d in (di, host_packed(di)):
        outs[d.staging] = P._dispatch_device(d, torch.device("cpu"))
        assert len(calls) == 1
    return outs


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_pack_dispatch_matches_reference_default(case, monkeypatch):
    """tpu_vpcc without the TPU's knobs (its CPU default: raw tiled
    arrays, pack and orientation fix on the device), the port's
    device-packed and host-packed dispatches: equal counts, byte-equal
    compacted prefixes."""
    monkeypatch.delenv("TPU_VPCC_HOSTPACK")
    monkeypatch.delenv("TPU_VPCC_HOSTORIENT")
    tiled, cfg_ref, color_mode = _ref_case(case)
    assert not cfg_ref.host_oriented
    ops, counts = ref_tiled.reconstruct_batch_pretiled_packed(*tiled,
                                                              cfg=cfg_ref)
    counts = np.asarray(counts)
    assert counts.min() > 0
    pos_r, col_r = ref_pipeline._fetch_prefixes_packed(ops, counts,
                                                       color_mode)
    outs = dispatch_both_stagings(tiled, port_cfg(cfg_ref), color_mode,
                                  monkeypatch)
    for frames in outs.values():
        assert len(frames) == len(counts)
        for f, (pos, col) in enumerate(frames):
            n = counts[f]
            assert len(pos) == n and len(col) == n
            assert pos.dtype == pos_r.dtype and col.dtype == col_r.dtype
            np.testing.assert_array_equal(pos, pos_r[f, :n])
            np.testing.assert_array_equal(col, col_r[f, :n])


def test_inputs_from_reference_takes_raw_tiled_arrays():
    """The reference's seven raw block-tiled arrays are read as tiled
    planes, not raster ones: packed on the device by the port's device
    pack, byte-equal to the reference's host-packed, host-oriented cat
    of the same arrays; raster arrays still give the gather's tensors."""
    tiled, cfg_ref, _ = _ref_case("pack30")
    cfg, fields, cat = T.inputs_from_reference(cfg_ref, tiled)
    assert cfg.host_oriented and not cfg_ref.host_oriented
    (ref_fields, ref_cat, *_), ref_cfg = ref_tiled.stage_cat_inputs(
        *tiled, cfg_ref)
    assert ref_cfg.host_oriented
    np.testing.assert_array_equal(fields.numpy(), ref_fields)
    assert cat.dtype == torch.int32
    np.testing.assert_array_equal(cat.numpy().view(np.uint32), ref_cat)
    fcfg = port_flagship.FlagshipConfig(W, H, RES, PREC, batch=2)
    raster = port_flagship.example_batch_inputs(fcfg, frames=_frames(3, 2))
    got = T.inputs_from_reference(cfg_ref, raster)
    assert len(got) == 8 and not got[0].host_oriented
    assert tuple(got[3].shape) == raster[2].shape  # geo0 (F, H, W)
