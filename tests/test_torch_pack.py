"""The device pack of the PyTorch port (``tpu_vpcc_torch.ops.pack``, kernel
K5) against tpu_vpcc's packs, on the CPU.

``pack_cat_plain`` packs the block-tiled planes into the cat with the
SWAP-family blocks transposed. It is held byte for byte (integer
outputs, no tolerance) against:

  - ``tpu_vpcc.ops.tiled.pack_planes_host(..., swap=...)``, the host pack
    the reference runs on a TPU, with its native C twin and with that
    monkeypatched away (numpy), over a grid of map counts, chroma shifts,
    block edges and occupancy precisions, frame counts and swap
    densities, on samples over the full 10-bit range;
  - with no block flagged, the ``jnp.concatenate`` of ``_pack_u32_planes``'
    three planes, as ``_pretiled_gather_megarow`` builds the cat on every
    backend but the TPU;
  - per owned group, the reference's device orientation: the rows of
    ``_pretiled_gather_megarow`` with the SWAP groups transposed, as
    ``_tiles_to_words`` fixes them when ``host_oriented`` is off.

The ``cuda``-marked test holds the kernel against the plain version on
a card (``pytest -m cuda tests/test_torch_pack.py``; it skips without
one).
"""
import re
from dataclasses import fields as dc_fields
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dispatch import (
    H,
    PREC,
    RES,
    W,
    _frames,
    _tiled,
    count_plain_packs,
)
from tpu_vpcc.atlas import groups as G
from tpu_vpcc.models import flagship as ref_flagship
from tpu_vpcc.ops import tiled as ref_tiled
from tpu_vpcc.ops.reconstruct import make_config as ref_make_config
from tpu_vpcc_torch.ops import pack
from tpu_vpcc_torch.ops import tiled as T
from tpu_vpcc_torch.ops.reconstruct import FrameConfig, make_config

NB = 5  # blocks a frame: odd, so no size lines up with anything

GRID = pack.CHECK_GRID


def _case_id(*values, mc, maps, nb):
    """A case's test id: its values joined by ``-``, then ``-M2`` where
    the planes hold more maps than are read and ``-nb13`` where a frame
    holds other than :data:`NB` blocks."""
    return "-".join(map(str, values)) + (f"-M{maps}" if maps != mc else "") \
        + (f"-nb{nb}" if nb != NB else "")


def _grid_id(case):
    mc, cs, res, prec, F, density, maps, nb = case
    return _case_id(mc, cs, res, prec, F, density, mc=mc, maps=maps, nb=nb)


def _planes(seed, mc, cs, res, prec, F, density, nb=NB, maps=None):
    """Block-tiled planes as the staging stacks them: occupancy u8 over
    0-255, geometry and colour u16 over the whole 10-bit range (``maps``
    maps of colour, default ``mc``), and a swap mask of the given
    density."""
    rng = np.random.default_rng(seed)
    rp, rc, M = res // prec, res >> cs, maps or mc

    def u10(*shape):
        return rng.integers(0, 1024, shape, dtype=np.uint16)

    occ = rng.integers(0, 256, (F, nb, rp, rp), dtype=np.uint8)
    planes = (occ, u10(F, nb, res, res), u10(F, nb, res, res),
              u10(F, M, nb, res, res), u10(F, M, nb, rc, rc),
              u10(F, M, nb, rc, rc))
    swap = (rng.random((F, nb)) < density).astype(np.uint8)
    return planes, swap


def _configs(mc, cs, res, prec, nb=NB):
    kw = dict(width=res * nb, height=res, occupancy_resolution=res,
              occupancy_precision=prec, map_count=mc, chroma_shift=cs)
    return ref_make_config(**kw), make_config(**kw)


def _port_pack(planes, swap, cfg):
    fields = np.zeros((swap.shape[0], 1, G.N_GROUP_FIELDS), np.int32)
    _, *t = T.plane_tensors(fields, *planes, swap)
    return pack.pack_cat_plain(*t, cfg).numpy().view(np.uint32)


#: the grid with the reference's native C pack and with numpy: the C pack
#: takes the map count for the planes' map axis, so it is left out where
#: the planes hold more maps than are read
HOST_PACK_CASES = [(native, *g) for g in GRID for native in (True, False)
                   if not (native and g[6] != g[0])]


@pytest.mark.parametrize(
    "native,mc,cs,res,prec,F,density,maps,nb", HOST_PACK_CASES,
    ids=[f"{_grid_id(c[1:])}-{'native' if c[0] else 'numpy'}"
         for c in HOST_PACK_CASES])
def test_plain_pack_matches_reference_host_pack(monkeypatch, native, mc, cs,
                                                res, prec, F, density, maps,
                                                nb):
    if not native:
        monkeypatch.setattr("tpu_vpcc.video.codec.native_pack_planes",
                            lambda *a, **k: None)
    planes, swap = _planes(res * 7 + prec + F + mc, mc, cs, res, prec, F,
                           density, nb, maps)
    cfg_ref, cfg = _configs(mc, cs, res, prec, nb)
    want = ref_tiled.pack_planes_host(*planes, cfg_ref, swap=swap)
    got = _port_pack(planes, swap, cfg)
    assert got.dtype == want.dtype == np.uint32
    assert got.shape == want.shape == (F, nb, 3 * res * res)
    np.testing.assert_array_equal(got, want)


#: the device pack's shapes ``(mc, cs, res, prec, M, nb)``: five of the
#: grid's product, then every shape of ``pack.CHECK_PATHS``
DEVICE_PACK_SHAPES = [
    (2, 1, 16, 4, 2, NB), (1, 1, 16, 4, 1, NB), (2, 0, 8, 2, 2, NB),
    (1, 0, 16, 16, 1, NB), (2, 1, 32, 4, 2, NB),
] + [(g[0], g[1], g[2], g[3], g[6], g[7]) for g in pack.CHECK_PATHS]


def _shape_id(shape):
    mc, cs, res, prec, maps, nb = shape
    return _case_id(mc, cs, res, prec, mc=mc, maps=maps, nb=nb)


@pytest.mark.parametrize("mc,cs,res,prec,maps,nb", DEVICE_PACK_SHAPES,
                         ids=[_shape_id(s) for s in DEVICE_PACK_SHAPES])
def test_plain_pack_matches_reference_device_pack(mc, cs, res, prec, maps,
                                                  nb):
    """No block flagged: the cat is the megarow gather's concat of the
    three ``_pack_u32_planes`` planes."""
    F = 2
    planes, swap = _planes(res + mc + cs, mc, cs, res, prec, F, 0.0, nb,
                           maps)
    cfg_ref, cfg = _configs(mc, cs, res, prec, nb)
    T2 = res * res
    ref_planes = ref_tiled._pack_u32_planes(
        *(jnp.asarray(a) for a in planes), cfg_ref)
    want = jnp.concatenate([p.reshape(F * nb, T2) for p in ref_planes],
                           axis=1)
    got = _port_pack(planes, swap, cfg)
    np.testing.assert_array_equal(got.reshape(F * nb, 3 * T2),
                                  np.asarray(want))


@pytest.mark.parametrize("mc", [1, 2])
def test_gathered_rows_match_reference_device_orientation(mc):
    """Synthetic 128^2 frames with SWAP-family patches: each live
    group's row of the port's device-packed cat equals the reference's
    megarow gather with the SWAP groups transposed (the orientation fix
    of ``_tiles_to_words`` with ``host_oriented`` off)."""
    frames = _frames(seed=30 + mc, map_count=mc)
    tiled, cs = _tiled(frames, tuple(range(mc)))
    fcfg = ref_flagship.FlagshipConfig(128, 128, 16, 4, map_count=mc)
    cfg_ref = fcfg.frame_config()
    fields = tiled[0]
    live = fields[:, :, G.G_VALID] > 0
    swapped = live & (fields[:, :, G.G_SWAP] == 1)
    assert swapped.any() and (live & ~swapped).any()

    t_ref = ref_tiled._pretiled_gather_megarow(
        *(jnp.asarray(a) for a in tiled), cfg_ref)
    sw = jnp.asarray(fields[:, :, G.G_SWAP] == 1).reshape(-1, 1, 1)
    t_ref = [np.asarray(jnp.where(sw, t.transpose(0, 2, 1), t))
             for t in t_ref]

    cfg = FrameConfig(**{f.name: getattr(cfg_ref, f.name)
                         for f in dc_fields(FrameConfig)})
    staged, cfg = T.stage_plane_inputs(*tiled, cfg)
    assert cfg.host_oriented
    np.testing.assert_array_equal(
        staged[-1], ref_tiled.swap_mask_host(fields, tiled[1].shape[1]))
    fields_t, cat = T.device_pack_inputs(*staged, "cpu", cfg)
    got = T._gather_tiles(fields_t, cat, cfg)
    rows = live.reshape(-1)
    for a, b in zip(got, t_ref):
        a = a.numpy().view(np.uint32).reshape(b.shape)
        np.testing.assert_array_equal(a[rows], b[rows])


def test_swap_mask_device_matches_host():
    frames = _frames(seed=5, map_count=2)
    tiled, _ = _tiled(frames, (0, 1))
    fields = tiled[0]
    nb = tiled[1].shape[1]
    got = T.swap_mask_device(torch.from_numpy(fields), nb)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  ref_tiled.swap_mask_host(fields, nb))
    assert got.sum() > 0


@pytest.mark.parametrize("env", [
    {}, {"TPU_VPCC_HOSTPACK": "1"}, {"TPU_VPCC_NO_HOSTPACK": "1"},
    {"TPU_VPCC_HOSTPACK": "1", "TPU_VPCC_NO_HOSTPACK": "1"},
])
def test_staging_reads_no_hostpack_knob(monkeypatch, env):
    """The port stages a tiled GOF without quantized extents for the
    device pack whatever the reference's host-pack knobs say."""
    from test_torch_batcher import _prepared_gof

    from tpu_vpcc_torch.runtime import pipeline as P

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    gof = _prepared_gof("narrow", 0)
    cfg, tables, g_bucket = P._gof_tables_and_bucket(gof)
    di = P._gof_device_inputs(gof, gof.metas, (cfg, tables), g_bucket)
    assert di.staging == "device_pack" and di.cfg.host_oriented
    assert len(di.arrays) == 8


@pytest.mark.parametrize("frames", [slice(None), slice(1, 3), [2, 0]],
                         ids=["all", "slice", "index"])
def test_both_stagers_put_one_cat(frames):
    """The host pack's and the device pack's stagers put the same cat of
    the same frames on the CPU (K5's plain version packs the planes)."""
    tiled, cs = _tiled(_frames(seed=9, map_count=2, n_frames=3), (0, 1))
    cfg = make_config(W, H, RES, PREC, map_count=2, chroma_shift=cs)
    planes, pcfg = T.stage_plane_inputs(*tiled, cfg)
    (fields, cat), hcfg = T.stage_cat_inputs(*tiled, cfg)
    assert pcfg == hcfg
    f_d, put_d = T.device_pack_stager(*planes, pcfg)
    f_h, put_h = T.host_cat_stager(fields, cat)
    assert torch.equal(f_d, f_h)
    got = put_d(frames, "cpu")
    assert got.shape[1:] == (tiled[1].shape[1], 3 * RES * RES)
    assert torch.equal(got, put_h(frames, "cpu"))
    assert torch.equal(got, torch.from_numpy(cat.view(np.int32))[frames])


def test_gather_dispatch_has_no_cat():
    from tpu_vpcc_torch.runtime import pipeline as P

    di = P.DeviceInputs(cfg=None, staging="gather", arrays=(
        np.zeros((1, 1, G.N_GROUP_FIELDS), np.int32),), n_frames=1)
    assert not di.use_tiled
    with pytest.raises(ValueError, match="no cat"):
        di.cat_stager()


def test_pack_cat_on_cpu_takes_the_plain_version(monkeypatch):
    planes, swap = _planes(3, 2, 1, 16, 4, 2, 0.3)
    _, cfg = _configs(2, 1, 16, 4)
    fields = np.zeros((2, 1, G.N_GROUP_FIELDS), np.int32)
    _, *t = T.plane_tensors(fields, *planes, swap)
    real = pack.pack_cat_plain
    calls = count_plain_packs(monkeypatch)
    before = pack.launches
    got = pack.pack_cat(*t, cfg)
    assert pack.launches == before and len(calls) == 1
    assert torch.equal(got, real(*t, cfg))
    with pytest.raises(NotImplementedError):
        pack.pack_cat(*(x.to("meta") for x in t), cfg)
    assert pack.launches == before


def test_pack_cat_rejects_bad_inputs():
    planes, swap = _planes(4, 2, 1, 16, 4, 1, 0.3)
    _, cfg = _configs(2, 1, 16, 4)
    fields = np.zeros((1, 1, G.N_GROUP_FIELDS), np.int32)
    _, *t = T.plane_tensors(fields, *planes, swap)
    bad_type = list(t)
    bad_type[1] = bad_type[1].to(torch.int32)
    with pytest.raises(TypeError):
        pack.pack_cat(*bad_type, cfg)
    bad_shape = list(t)
    bad_shape[4] = bad_shape[4][..., :4, :4]
    with pytest.raises(ValueError):
        pack.pack_cat(*bad_shape, cfg)
    one_map = list(t)
    one_map[3] = one_map[3][:, :1].contiguous()
    with pytest.raises(ValueError):
        pack.pack_cat(*one_map, cfg)  # two maps asked of one
    bad = fields.copy()
    bad[0, 0, G.G_BLOCKID] = NB  # one past the planes' blocks
    with pytest.raises(ValueError, match="G_BLOCKID"):
        T.planes_to_device(bad, *planes, swap, "cpu")


def _tiny_planes(F, res, prec=1):
    planes, swap = _planes(5, 2, 0, res, prec, F, 0.5, 1)
    _, cfg = _configs(2, 0, res, prec, 1)
    fields = np.zeros((F, 1, G.N_GROUP_FIELDS), np.int32)
    _, *t = T.plane_tensors(fields, *planes, swap)
    return t, cfg


@pytest.mark.parametrize("F,res,what", [
    (1, pack.K5_MAX_RES * 2, "block edges up to 128"),
    (pack.K5_MAX_FRAMES + 1, 2, "at most 65535 frames"),
])
def test_k5_refuses_what_it_cannot_launch(F, res, what):
    """The wrapper raises before any launch on a block edge above
    ``K5_MAX_RES`` or more frames than the grid's second axis holds,
    whatever the device (these checks come before the kernel loads)."""
    t, cfg = _tiny_planes(F, res)
    with pytest.raises(ValueError, match=what):
        pack._pack_cat_cuda(*t, cfg)


def test_k5_limits_match_the_kernel():
    """``ops/pack.py``'s limits are the CUDA source's: its frame bound,
    and tiles of V3C's largest edge fit a CTA's shared memory a plane at
    a time (4:4:4, two maps, 2-byte samples in rows padded by 4 bytes)."""
    src = (Path(pack.__file__).resolve().parent.parent / "csrc"
           / "pack_planes.cu").read_text()
    assert f"F > {pack.K5_MAX_FRAMES}" in src
    pad = int(re.search(r"constexpr int kRowPad = ([0-9]+);", src).group(1))
    smem = int(re.search(r"constexpr int kSmemOptIn = ([0-9]+);",
                         src).group(1))
    res = pack.K5_MAX_RES
    assert 3 * res * (2 * res + pad) <= smem


def test_pack_tool_needs_a_card(monkeypatch):
    from tpu_vpcc_torch.tools import kernel_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        kernel_times.main(["--pack"])


@pytest.mark.parametrize("maps", [1, 2])
def test_seeded_planes_pack_as_the_reference(monkeypatch, maps):
    """The planes ``kernel_times --pack`` and ``chip_smoke.py`` time K5 on
    (``seeded_planes``, ``pack_config``) are staging planes: the plain
    pack of them equals the reference's numpy host pack (its C pack takes
    no planes with more maps than are read), and ``pack_bytes`` counts
    each plane read once and the cat written once."""
    from tpu_vpcc_torch.tools import kernel_times as K

    monkeypatch.setattr("tpu_vpcc.video.codec.native_pack_planes",
                        lambda *a, **k: None)

    mc, cs, res, prec, F, nb = 1, 1, 16, 4, 2, 7
    gen = torch.Generator().manual_seed(3)
    t = K.seeded_planes(mc, cs, res, prec, F, 0.3, nb, gen, maps)
    cfg = K.pack_config(mc, cs, res, prec, nb)
    cfg_ref, _ = _configs(mc, cs, res, prec, nb)
    arrays = [x.numpy() for x in t]
    arrays[1:6] = [a.view(np.uint16) for a in arrays[1:6]]
    want = ref_tiled.pack_planes_host(*arrays[:6], cfg_ref, swap=arrays[6])
    got = pack.pack_cat(*t, cfg).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    rc = res >> cs
    read = (res // prec) ** 2 + 1 + 2 * res * res + 2 * res * res \
        + 2 * 2 * rc * rc  # occupancy, swap, geometry, luma, chroma
    assert K.pack_bytes(*t, cfg) == F * nb * (read + 12 * res * res)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_k5_kernel_matches_plain_on_card():
    """K5 against its plain version over the CPU grid (every path of the
    kernel), at one block of one frame, at a total no multiple of a
    256-thread CTA, and on frames sliced from a larger input at an offset
    that leaves the swap mask on an odd byte; each case twice, the whole
    cat byte-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")
    cases = [g[:6] + (g[7], g[6]) for g in GRID]
    cases += [(2, 1, 16, 4, 1, 1.0, 1, 2), (1, 1, 6, 3, 1, 0.5, 3, 1)]
    for mc, cs, res, prec, F, density, nb, maps in cases:
        planes, swap = _planes(res + F, mc, cs, res, prec, F, density, nb,
                               maps)
        _, cfg = _configs(mc, cs, res, prec, nb)
        fields = np.zeros((F, 1, G.N_GROUP_FIELDS), np.int32)
        _, *t = T.planes_to_device(fields, *planes, swap, "cuda")
        before = pack.launches
        got = pack.pack_cat(*t, cfg)
        again = pack.pack_cat(*t, cfg)
        want = pack.pack_cat_plain(*t, cfg)
        torch.cuda.synchronize()
        assert pack.launches == before + 2
        assert torch.equal(got, want) and torch.equal(again, want), (
            mc, cs, res, prec, F, density, nb, maps)
    # frames 1-2 of three, nb odd: each plane starts past frame 0
    planes, swap = _planes(77, 2, 1, 16, 4, 3, 0.3, 7)
    _, cfg = _configs(2, 1, 16, 4, 7)
    fields = np.zeros((3, 1, G.N_GROUP_FIELDS), np.int32)
    _, *t = T.planes_to_device(fields, *planes, swap, "cuda")
    sliced = [x[1:] for x in t]
    assert sliced[-1].data_ptr() % 2 == 1
    want = pack.pack_cat_plain(*t, cfg)[1:]
    for _ in range(2):
        assert torch.equal(pack.pack_cat(*sliced, cfg), want)
