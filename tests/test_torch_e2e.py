"""Fixture streams decoded by the PyTorch port on the CPU.

The PLY bytes of every frame must equal tpu_vpcc's device decode (JAX on
the CPU, its default there: the cat packed on the device) and the numpy
oracle's. The port's tiled frames take its default too, the device pack
(K5's plain version here); two families run again with the host pack
(the port's staging of quantized patch extents, forced on every tiled
dispatch by ``test_torch_dispatch.host_pack_staging``), and quantized
patch extents stay host-packed. The port never imports jax: subprocesses
decode through ``Decoder`` and ``python -m tpu_vpcc_torch.runtime.cli``
(a plain and a smoothing stream) and then check ``sys.modules``. Streams
with rotated orientations, and prepared GOFs with rotated orientations or
12-bit geometry, take the gather fallback.
"""
import importlib
import os
import subprocess
import sys
import types
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from test_torch_dispatch import count_plain_packs, host_pack_staging
from tpu_vpcc.atlas.patches import Patch, _check_orientation_in_range
from tpu_vpcc.runtime import cli as ref_cli
from tpu_vpcc.runtime.pipeline import Decoder as RefDecoder
from tpu_vpcc.runtime.pipeline import Params as RefParams
from tpu_vpcc.utils.fixtures import build_fixture_stream
from tpu_vpcc.utils.ply import format_ply
from tpu_vpcc.utils.synthetic import make_synthetic_frame, plant_raw_patch
from tpu_vpcc.v3c.syntax import PatchOrientation
from tpu_vpcc.v3c.syntax import UnsupportedFeature as RefUnsupportedFeature
from tpu_vpcc.video import encoder_supports
from tpu_vpcc_torch.runtime import cli as port_cli
from tpu_vpcc_torch.runtime.pipeline import Decoder, Params
from tpu_vpcc_torch.v3c.syntax import UnsupportedFeature

ROOT = Path(__file__).resolve().parent.parent
VERIFY_STREAM = ROOT / "tests" / "data" / "verify_64x64_2f.bin"


def _encoder_available() -> bool:
    """Whether libx265 encodes 8- and 10-bit here: not where the native
    bridge cannot build (a machine without libavcodec)."""
    try:
        return encoder_supports(8) and encoder_supports(10)
    except (subprocess.CalledProcessError, OSError):
        return False


needs_encoder = pytest.mark.skipif(
    not _encoder_available(),
    reason="libx265 lossless 8/10-bit required to author fixtures",
)


def _mk(seed, n_frames=2, **kw):
    rng = np.random.default_rng(seed)
    return [
        make_synthetic_frame(
            rng, width=64, height=64, occupancy_resolution=8,
            occupancy_precision=4, n_patches=3, frame_index=i, **kw,
        )
        for i in range(n_frames)
    ]


def _stream_three_maps():
    return build_fixture_stream(_mk(67, map_count=3), multi_map_streams=True)


def _stream_raw_eom_secondary():
    """Two-map frames at occupancy precision 1 with an EOM patch and a
    raw patch each, plus two secondary attributes (reflectance and a
    second texture)."""
    from tests.test_eom import make_eom_frame
    from tests.test_raw_patches import free_block_rect

    rng = np.random.default_rng(71)
    frames = []
    for i in range(2):
        sf = make_eom_frame(rng, frame_index=i)
        u0, v0 = free_block_rect(sf, 2, 1)
        plant_raw_patch(rng, sf, (u0, v0, 2, 1), n_points=13,
                        offsets=(3, 1, 2))
        frames.append(sf)
    return build_fixture_stream(
        frames, secondary_attrs=[(3, 1, None), (0, 3, None)]
    )


def _stream_plr():
    from tests.test_plr import make_plr_p_sequence

    return make_plr_p_sequence(seed=23)[1]


def _stream_aux_raw():
    from tests.test_aux_video import make_aux_frames

    return build_fixture_stream(
        make_aux_frames(seed=5, n_frames=1, with_main_raw=True)
    )


def _stream_pixel_interleave():
    from tests.test_pixel_interleave import make_pix_il_stream

    return make_pix_il_stream(seed=7, n_frames=1)[1]


def _stream_multi_tile_aux():
    from tests.test_aux_multitile import make_two_tile_frame, plant_banded_aux_raws

    rng = np.random.default_rng(61)
    sf = make_two_tile_frame(rng)
    plant_banded_aux_raws(rng, sf)
    return build_fixture_stream([sf], tiles=(2, 1), aux_tile_row_heights=[1, 1])


def _views45(frames):
    """Put the patches of each frame on the 45-degree planes 1, 2 and 3,
    as bench.py's proj45 family does."""
    for sf in frames:
        for p, plane in zip(sf.meta.patches, (1, 2, 3)):
            p.set_view_id(next(
                v for v, r in Patch._VIEW_TABLE.items()
                if r[0] == plane and r[4] == p.projection_mode
            ))
    return frames


def _stream_proj45():
    return build_fixture_stream(_views45(_mk(99, n_frames=1)))


def _stream_proj45_three_maps():
    """45-degree views in a three-map stream: the trailing-layer pass
    (drop_map0) takes the wide path too."""
    return build_fixture_stream(
        _views45(_mk(67, map_count=3)), multi_map_streams=True
    )


def _stream_smoothing_secondary():
    """Smoothing SEIs for attribute 0 and for a secondary texture: the
    secondary twin pass takes the wide path with its own instance."""
    return build_fixture_stream(
        _mk(43, map_count=2), secondary_attrs=[(3, 1, None), (0, 3, None)],
        geo_smoothing_sei=(8, 16),
        attr_smoothing_sei=[(0, 8, 255, 1), (2, 8, 255, 1)],
    )


def _stream_smoothing():
    """Geometry and attribute smoothing SEIs, as bench.py's smoothing
    family writes them (decoded with both toggles on)."""
    return build_fixture_stream(
        _mk(47, map_count=2), geo_smoothing_sei=(8, 16),
        attr_smoothing_sei=(8, 255, 1),
    )


#: the orientations that leave block alignment at resolution > 1
ROTATED = (PatchOrientation.ROT90, PatchOrientation.ROT180,
           PatchOrientation.ROT270, PatchOrientation.MIRROR,
           PatchOrientation.MROT90, PatchOrientation.MROT180)


def _rotated(seed, n_frames=2, map_count=2):
    """``_mk`` frames with every patch turned to a rotated orientation
    that the reference's range gate admits (drawn from ``seed``; a patch
    none fits keeps its own), the planes made anew for the turned
    footprints."""
    rng = np.random.default_rng(seed)
    frames = []
    for k, sf in enumerate(_mk(seed, n_frames, map_count=map_count)):
        patches = []
        for p in sf.meta.patches:
            for o in rng.permutation(len(ROTATED)):
                q = replace(p, patch_orientation=PatchOrientation(ROTATED[o]))
                try:
                    _check_orientation_in_range(q, 64, 64)
                except RefUnsupportedFeature:
                    continue
                p = q
                break
            patches.append(p)
        frames.append(make_synthetic_frame(
            rng, width=64, height=64, occupancy_resolution=8,
            occupancy_precision=4, map_count=map_count, frame_index=k,
            patches=patches,
        ))
    assert sum(p.patch_orientation in ROTATED
               for sf in frames for p in sf.meta.patches) >= n_frames
    return frames


def _stream_rotated_smoothing_secondary():
    """Rotated orientations with the smoothing SEIs for attribute 0 and
    for a secondary texture: the primary and the twin pass both take the
    gather fallback with smoothing."""
    return build_fixture_stream(
        _rotated(97), secondary_attrs=[(3, 1, None), (0, 3, None)],
        geo_smoothing_sei=(8, 16),
        attr_smoothing_sei=[(0, 8, 255, 1), (2, 8, 255, 1)],
    )


def _stream_vui():
    from tests.test_vui import rich_vui

    return build_fixture_stream(_mk(53), vui=rich_vui())


def _stream_verify():
    """The recipe of the committed verify stream: it rebuilds the file
    byte for byte."""
    rng = np.random.default_rng(123)
    return build_fixture_stream([
        make_synthetic_frame(rng, width=64, height=64,
                             occupancy_resolution=16, occupancy_precision=4,
                             n_patches=3, frame_index=i)
        for i in range(2)
    ])


# the twelve feature families of tpu_vpcc's on-device parity check
# (bench.py tpu_family_parity; its eom and secondary_attrs families are
# covered by raw_eom_secondary), the verify stream, and two more cases of
# the wide path, which proj45 and smoothing take
STREAMS = {
    "verify": lambda: VERIFY_STREAM.read_bytes(),
    "three_maps": _stream_three_maps,
    "raw_eom_secondary": _stream_raw_eom_secondary,
    "plr": _stream_plr,
    "aux_raw": _stream_aux_raw,
    "pixel_interleave": _stream_pixel_interleave,
    "multi_tile_aux": _stream_multi_tile_aux,
    "chroma422": lambda: build_fixture_stream(
        _mk(31), multi_map_streams=True, chroma422=True),
    "vui": _stream_vui,
    "atlas_hash": lambda: build_fixture_stream(_mk(59), atlas_hash_sei=True),
    "proj45": _stream_proj45,
    "smoothing": _stream_smoothing,
    # the wide path's trailing-layer and secondary-attribute passes
    "proj45_three_maps": _stream_proj45_three_maps,
    "smoothing_secondary": _stream_smoothing_secondary,
    # the gather fallback: its primary, trailing-layer and secondary
    # passes
    "rotated": lambda: build_fixture_stream(_rotated(83)),
    "rotated_three_maps": lambda: build_fixture_stream(
        _rotated(89, map_count=3), multi_map_streams=True),
    "rotated_smoothing_secondary": _stream_rotated_smoothing_secondary,
}

#: every family's recipe: ``STREAMS``, with the verify stream built
RECIPES = dict(STREAMS, verify=_stream_verify)
#: the JAX package's test modules whose helpers author some families
HELPER_MODULES = ("tests.test_eom", "tests.test_raw_patches", "tests.test_plr",
                  "tests.test_aux_video", "tests.test_pixel_interleave",
                  "tests.test_aux_multitile", "tests.test_vui")
#: the packages a family can be built with
PACKAGES = ("tpu_vpcc", "tpu_vpcc_torch")


class _Absent:
    """Stands for an object of ``tpu_vpcc`` that the port lacks: any use
    raises."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        raise AttributeError(f"{self._name} has no counterpart in "
                             f"tpu_vpcc_torch")

    def __call__(self, *args, **kw):
        raise TypeError(f"{self._name} has no counterpart in tpu_vpcc_torch")


def _counterpart(value):
    """The port's object of the same name as ``value``, an object of
    ``tpu_vpcc`` (a module, or a function or class of one); an
    :class:`_Absent` where the port lacks it; None for anything else."""
    if isinstance(value, types.ModuleType):
        module, attr = value.__name__, None
    else:
        module = getattr(value, "__module__", None)
        attr = getattr(value, "__qualname__", None)
    if not isinstance(module, str) or module.split(".")[0] != "tpu_vpcc":
        return None
    name = "tpu_vpcc_torch" + module[len("tpu_vpcc"):]
    try:
        port = importlib.import_module(name)
        return port if attr is None else getattr(port, attr)
    except (ImportError, AttributeError):
        return _Absent(f"{module}.{attr}" if attr else module)


@contextmanager
def built_with(package: str):
    """Build the families (``RECIPES``) with ``package`` while open.
    For ``tpu_vpcc`` nothing changes. For ``tpu_vpcc_torch`` every name
    that this module and :data:`HELPER_MODULES` bind to an object of
    ``tpu_vpcc`` (``build_fixture_stream``, ``make_synthetic_frame``,
    ``plant_raw_patch``, ``Patch``, ``PatchOrientation``, the writer,
    ...) is bound to the port's object of the same name, and restored on
    exit: the recipes are the same code, built by the port's scene
    generator, stream writer and encoder."""
    assert package in PACKAGES, package
    saved = []
    if package == "tpu_vpcc_torch":
        for module in [sys.modules[__name__],
                       *map(importlib.import_module, HELPER_MODULES)]:
            space = vars(module)
            for name, value in list(space.items()):
                port = _counterpart(value)
                if port is not None:
                    saved.append((space, name, value))
                    space[name] = port
    try:
        yield
    finally:
        for space, name, value in saved:
            space[name] = value


SMOOTHING = dict(apply_geo_smoothing_type=True, apply_attr_smoothing_type=True)
#: decoder options of a family (the reference's Params takes the same)
STREAM_PARAMS = {"smoothing": SMOOTHING, "smoothing_secondary": SMOOTHING,
                 "rotated_smoothing_secondary": SMOOTHING}
#: families that carry a reflectance and a second texture
SECONDARY = ("raw_eom_secondary", "smoothing_secondary",
             "rotated_smoothing_secondary")


def _decode(decoder_cls, params_cls, data, **kw):
    dec = decoder_cls(params_cls(data, **kw))
    dec.start()
    return [format_ply(f) for f in dec]


@needs_encoder
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_matches_reference_and_oracle(name, monkeypatch):
    data = STREAMS[name]()
    kw = STREAM_PARAMS.get(name, {})
    packs = count_plain_packs(monkeypatch)
    got = _decode(Decoder, Params, data, device="cpu", **kw)
    # the tiled families pack on the device; the gather packs nothing
    assert (len(packs) > 0) == (not name.startswith("rotated"))
    ref = _decode(RefDecoder, RefParams, data, **kw)
    oracle = _decode(RefDecoder, RefParams, data, use_device=False, **kw)
    port_oracle = _decode(Decoder, Params, data, use_device=False, **kw)
    assert len(got) >= 1
    if name in SECONDARY:
        header = got[0].split(b"end_header")[0]
        assert b"property ushort reflectance" in header
        assert b"property uchar red2" in header
    assert got == ref
    assert got == oracle
    assert port_oracle == oracle


@needs_encoder
@pytest.mark.parametrize("name", ["three_maps", "smoothing_secondary"])
def test_stream_under_host_pack_matches_device_pack(name, monkeypatch):
    """The port's host pack on every tiled dispatch of a stream: no plain
    device pack runs, and the bytes equal those of the port's default
    device pack and of tpu_vpcc's decode under its host-pack knob
    ``TPU_VPCC_HOSTPACK=1``."""
    data = STREAMS[name]()
    kw = STREAM_PARAMS.get(name, {})
    device_packed = _decode(Decoder, Params, data, device="cpu", **kw)
    packs = count_plain_packs(monkeypatch)
    with host_pack_staging() as staged:
        got = _decode(Decoder, Params, data, device="cpu", **kw)
    assert staged and not packs
    assert got == device_packed
    monkeypatch.setenv("TPU_VPCC_HOSTPACK", "1")
    assert got == _decode(RefDecoder, RefParams, data, **kw)


@needs_encoder
def test_quantized_stream_stays_host_packed(monkeypatch):
    """Quantized patch extents: the trim exists only as a bit mask in a
    host cat, so the port host-packs them, as tpu_vpcc does; the bytes
    equal tpu_vpcc's decode and the oracle's."""
    from test_size_quantizer import make_quantized_frame

    from tpu_vpcc_torch.runtime import pipeline as P

    q = (1, 2)
    sf, _ = make_quantized_frame(np.random.default_rng(47),
                                 [(10, 12), (4, 28), (8, 16)], q=q,
                                 occupancy_fill=0.8)
    data = build_fixture_stream([sf], size_quantizer=q)
    staged = []
    real = P._dispatch_device

    def spy(di, *a, **k):
        staged.append(di.staging)
        return real(di, *a, **k)

    monkeypatch.setattr(P, "_dispatch_device", spy)
    packs = count_plain_packs(monkeypatch)
    got = _decode(Decoder, Params, data, device="cpu")
    assert staged == ["host_pack"] and not packs
    assert len(got) == 1 and b"element vertex 0" not in got[0]
    assert got == _decode(RefDecoder, RefParams, data)
    assert got == _decode(RefDecoder, RefParams, data, use_device=False)


def test_cli_matches_reference_cli_and_stays_jax_free(tmp_path):
    """``python -m tpu_vpcc_torch.runtime.cli --device cpu`` writes the
    same files as ``python -m tpu_vpcc.runtime.cli``; the port's process
    never imports jax or tpu_vpcc."""
    out_port = tmp_path / "port"
    out_ref = tmp_path / "ref"
    script = f"""
import runpy, sys
from tpu_vpcc_torch import Decoder, Params
dec = Decoder(Params({str(VERIFY_STREAM)!r}, device="cpu"))
dec.start()
n = sum(len(f) > 0 for f in dec)
assert n == 2, n
sys.argv = ["cli", "-i", {str(VERIFY_STREAM)!r}, "-o", {str(out_port)!r},
            "--device", "cpu"]
try:
    runpy.run_module("tpu_vpcc_torch.runtime.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
mods = sorted(m for m in sys.modules
              if m.startswith("jax") or m.split(".")[0] == "tpu_vpcc")
assert not mods, mods
print("JAX_FREE")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_FREE" in proc.stdout
    assert ref_cli.main(["-i", str(VERIFY_STREAM), "-o", str(out_ref)]) == 0
    names = sorted(p.name for p in out_ref.iterdir())
    assert names == sorted(p.name for p in out_port.iterdir())
    assert len(names) == 2
    for n in names:
        assert (out_port / n).read_bytes() == (out_ref / n).read_bytes()


@needs_encoder
def test_smoothing_cli_matches_reference_cli_and_stays_jax_free(tmp_path):
    """``--apply-geo-smoothing --apply-attr-smoothing``: the port's CLI
    (on the wide path) writes the same files as tpu_vpcc's CLI, and a
    smoothing decode through the CLI and ``Decoder`` never imports jax or
    tpu_vpcc."""
    stream = tmp_path / "smoothing.bin"
    stream.write_bytes(_stream_smoothing())
    flags = ["--apply-geo-smoothing", "--apply-attr-smoothing"]
    out_port = tmp_path / "port"
    out_ref = tmp_path / "ref"
    script = f"""
import runpy, sys
from tpu_vpcc_torch import Decoder, Params
dec = Decoder(Params({str(stream)!r}, device="cpu",
                     apply_geo_smoothing_type=True,
                     apply_attr_smoothing_type=True))
dec.start()
assert sum(len(f) > 0 for f in dec) == 2
sys.argv = ["cli", "-i", {str(stream)!r}, "-o", {str(out_port)!r},
            "--device", "cpu"] + {flags!r}
try:
    runpy.run_module("tpu_vpcc_torch.runtime.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
mods = sorted(m for m in sys.modules
              if m.startswith("jax") or m.split(".")[0] == "tpu_vpcc")
assert not mods, mods
print("JAX_FREE")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_FREE" in proc.stdout
    assert ref_cli.main(["-i", str(stream), "-o", str(out_ref)] + flags) == 0
    names = sorted(p.name for p in out_ref.iterdir())
    assert names == sorted(p.name for p in out_port.iterdir())
    assert len(names) == 2
    for n in names:
        assert (out_port / n).read_bytes() == (out_ref / n).read_bytes()
    # and the port's oracle path agrees with its device path
    assert port_cli.main(["-i", str(stream), "-o", str(tmp_path / "ora"),
                          "--oracle"] + flags) == 0
    for n in names:
        assert (tmp_path / "ora" / n).read_bytes() == \
            (out_port / n).read_bytes()


@needs_encoder
def test_non_tileable_orientation_raises():
    """A ROT90 patch at resolution 16 has no block-aligned pixel tile: it
    takes the gather fallback and decodes as tpu_vpcc and the oracle
    decode it."""
    p = Patch(uv0=(2, 1), size_uv0=(2, 2), uv1=(10, 20),
              occupancy_resolution=16,
              patch_orientation=PatchOrientation.ROT90)
    p.set_view_id(1)
    p.d1 = 100
    p.size_d = 255
    sf = make_synthetic_frame(
        np.random.default_rng(13), width=64, height=64,
        occupancy_resolution=16, occupancy_precision=4,
        patches=[replace(p)], frame_index=0,
    )
    data = build_fixture_stream([sf])
    got = _decode(Decoder, Params, data, device="cpu")
    assert len(got) == 1 and b"element vertex 0" not in got[0]
    assert got == _decode(RefDecoder, RefParams, data)
    assert got == _decode(RefDecoder, RefParams, data, use_device=False)


@needs_encoder
def test_overlapping_rotated_patch_occupancy_gated():
    """tests/test_orientations.py's full-bitstream ownership hazard
    through the port: a ROT90 patch at resolution 16 overlapping a
    DEFAULT patch, the ROT90 patch's own pixel set unoccupied, so the
    DEFAULT patch keeps its block and emits."""
    p0 = Patch(uv0=(3, 1), size_uv0=(1, 1), uv1=(40, 80),
               occupancy_resolution=16,
               patch_orientation=PatchOrientation.DEFAULT)
    p0.set_view_id(0)
    p0.d1 = 100
    p0.size_d = 255
    p1 = Patch(uv0=(2, 1), size_uv0=(2, 2), uv1=(10, 20),
               occupancy_resolution=16,
               patch_orientation=PatchOrientation.ROT90)
    p1.set_view_id(1)
    p1.d1 = 100
    p1.size_d = 255
    sf = make_synthetic_frame(
        np.random.default_rng(13), width=64, height=64,
        occupancy_resolution=16, occupancy_precision=4, patches=[p0, p1],
    )
    sf.occ_plane[:] = 0
    sf.occ_plane[4:8, 12:16] = 1
    data = build_fixture_stream([sf])
    got = _decode(Decoder, Params, data, device="cpu")
    assert len(got) == 1 and b"element vertex 0" not in got[0]
    assert got == _decode(RefDecoder, RefParams, data)
    assert got == _decode(RefDecoder, RefParams, data, use_device=False)


def test_randomized_mixed_orientation_overlap_matches_oracle():
    """tests/test_orientations.py's randomized frames mixing every
    orientation the range gate admits, with overlapping footprints and
    random occupancy (the occupancy-gated ownership), as twelve frames
    of one gather dispatch of the port: equal to the numpy oracle and to
    tpu_vpcc's gather kernel."""
    from tpu_vpcc.atlas.groups import build_group_table
    from tpu_vpcc.atlas.patches import FrameMeta
    from tpu_vpcc.ops.reconstruct import make_config
    from tpu_vpcc.ops.reconstruct import reconstruct_batch as ref_batch
    from tpu_vpcc.reconstruction.oracle import (
        GeneratePointCloudParams,
        generate_point_cloud,
    )
    from tpu_vpcc_torch.ops import reconstruct as R
    from tpu_vpcc_torch.ops import tiled as T

    res, W, H, prec = 4, 32, 32, 2
    bw, bh = W // res, H // res
    rng = np.random.default_rng(23)
    rows, want = [], []
    for _trial in range(12):
        patches = []
        while len(patches) < 5:
            p = Patch(
                uv0=(int(rng.integers(0, bw)), int(rng.integers(0, bh))),
                size_uv0=(int(rng.integers(1, 4)), int(rng.integers(1, 4))),
                uv1=(int(rng.integers(0, 200)), int(rng.integers(0, 200))),
                occupancy_resolution=res,
                patch_orientation=PatchOrientation(int(rng.integers(0, 8))),
            )
            p.set_view_id(int(rng.integers(0, 6)))
            p.d1 = 100 if p.projection_mode == 0 else 900
            try:
                _check_orientation_in_range(p, W, H)
            except RefUnsupportedFeature:
                continue
            patches.append(p)
        meta = FrameMeta(width=W, height=H, patches=patches)
        occ = (rng.random((H // prec, W // prec)) < 0.5).astype(np.uint8)
        d0 = rng.integers(0, 256, (H, W)).astype(np.uint16) * 4
        d1 = np.minimum(d0 // 4 + rng.integers(0, 3, (H, W)),
                        255).astype(np.uint16) * 4
        ay = rng.integers(0, 1024, (2, H, W)).astype(np.uint16)
        au = rng.integers(0, 1024, (2, H // 2, W // 2)).astype(np.uint16)
        av = rng.integers(0, 1024, (2, H // 2, W // 2)).astype(np.uint16)
        params = GeneratePointCloudParams(
            occupancy_resolution=res, occupancy_precision=prec,
            map_count_minus1=1,
        )
        ps, _, _ = generate_point_cloud(
            meta, params, occ, [d0, d1],
            [[[ay[0], au[0], av[0]], [ay[1], au[1], av[1]]]],
        )
        want.append(ps)
        gt = build_group_table(meta, occ_provider=lambda occ=occ: occ,
                               occ_precision=prec)
        rows.append((gt.fields, occ, d0, d1, ay, au, av))
    arrays = tuple(np.stack([r[i] for r in rows]) for i in range(7))
    cfg_ref = make_config(width=W, height=H, occupancy_resolution=res,
                          occupancy_precision=prec, map_count=2)
    cfg, *tensors = T.inputs_from_reference(cfg_ref, arrays)
    ops, counts = R.reconstruct_batch(*tensors, cfg)
    pos, col = T._unpack_ops_points(ops, "gather")
    _, _, ref_counts = ref_batch(*arrays, cfg=cfg_ref)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    for k, ps in enumerate(want):
        n = int(counts[k])
        assert n == ps.point_count, k
        np.testing.assert_array_equal(pos[k, :n].numpy(), ps.positions)
        np.testing.assert_array_equal(col[k, :n].numpy(), ps.colors16bit)
    assert sum(ps.point_count > 0 for ps in want) >= 8


@needs_encoder
@pytest.mark.parametrize("name", ["rotated", "rotated_smoothing_secondary"])
def test_rotated_cli_matches_reference_cli(tmp_path, name):
    """``python -m tpu_vpcc_torch.runtime.cli --device cpu`` on rotated
    streams (the gather fallback) writes the same files as tpu_vpcc's
    CLI and as its own oracle path."""
    stream = tmp_path / f"{name}.bin"
    stream.write_bytes(STREAMS[name]())
    flags = (["--apply-geo-smoothing", "--apply-attr-smoothing"]
             if name in STREAM_PARAMS else [])
    args = ["-i", str(stream)] + flags
    assert port_cli.main(args + ["-o", str(tmp_path / "port"),
                                 "--device", "cpu"]) == 0
    assert port_cli.main(args + ["-o", str(tmp_path / "ora"),
                                 "--oracle"]) == 0
    assert ref_cli.main(args + ["-o", str(tmp_path / "ref")]) == 0
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert len(names) == 2
    for out in ("port", "ora"):
        assert names == sorted(p.name for p in (tmp_path / out).iterdir())
        for n in names:
            assert (tmp_path / out / n).read_bytes() == \
                (tmp_path / "ref" / n).read_bytes()


def _gather_gof(kind, fcfg, seed, tiled=True):
    """A prepared GOF that takes the gather fallback: ``rotated`` (a
    third of the patches turned), ``geometry12`` (12-bit geometry
    samples) or ``rotated_smoothing`` (rotated, with geometry and colour
    smoothing)."""
    from tpu_vpcc_torch.models.flagship import (
        ATTR_SMOOTHING,
        GEO_SMOOTHING,
        example_frames,
        example_gof,
    )

    rotated = 0.0 if kind == "geometry12" else 1 / 3
    frames = example_frames(fcfg, seed=seed, n_patches=8, rotated=rotated)
    kw = {"geometry_bits": 12} if kind == "geometry12" else {}
    if kind == "rotated_smoothing":
        kw = dict(geo_smoothing=GEO_SMOOTHING, attr_smoothing=ATTR_SMOOTHING)
    return example_gof(fcfg, frames, tiled=tiled, **kw)


GATHER_GOFS = ("rotated", "geometry12", "rotated_smoothing")


@pytest.mark.parametrize("kind", GATHER_GOFS)
def test_gather_gofs_through_decoder_match_oracle(kind):
    """``Decoder.start_gofs`` on prepared GOFs that take the gather
    fallback, two in flight, equal the oracle path on the same GOFs; the
    12-bit GOF also equals the 10-bit decode of its frames, and the
    K1F counter stays untouched on the CPU."""
    from tpu_vpcc_torch.models.flagship import FlagshipConfig, example_gof
    from tpu_vpcc_torch.ops import shift_compact as sc
    from tpu_vpcc_torch.runtime import pipeline as P

    fcfg = FlagshipConfig(128, 128, batch=2)
    gofs = [_gather_gof(kind, fcfg, s) for s in (0, 2)]
    for g in gofs:
        cfg, tables, g_bucket = P._gof_tables_and_bucket(g)
        assert not P._gof_device_inputs(
            g, g.metas, (cfg, tables), g_bucket).use_tiled

    def run(gofs, **kw):
        dec = Decoder(Params(**kw))
        dec.start_gofs(gofs)
        return [format_ply(f) for f in dec]

    before = sc.full_launches
    got = run(gofs, device="cpu", pipeline_gofs=2)
    assert sc.full_launches == before
    assert len(got) == 4 and all(b"element vertex 0" not in f for f in got)
    oracle = [_gather_gof(kind, fcfg, s, tiled=False) for s in (0, 2)]
    assert got == run(oracle, use_device=False)
    if kind == "geometry12":
        from tpu_vpcc_torch.models.flagship import example_frames

        narrow = [example_gof(fcfg, example_frames(fcfg, seed=s, n_patches=8))
                  for s in (0, 2)]
        assert got == run(narrow, device="cpu")


def test_quantized_extent_on_gather_frame_raises():
    """A quantized patch extent exists only as a packed-occupancy mask
    in the block-tiled cat: on frames that take the gather fallback
    (here 12-bit geometry) the port refuses it as tpu_vpcc does."""
    from tpu_vpcc.runtime import pipeline as ref_pipeline
    from tpu_vpcc.runtime.pipeline import GofData as RefGofData
    from tpu_vpcc_torch.models.flagship import FlagshipConfig, example_frames
    from tpu_vpcc_torch.runtime.host import GofData

    fcfg = FlagshipConfig(64, 64, 8, 4, batch=1)
    match = "patch size quantizer needs the block-tiled dispatch"
    for gof_cls, frames in (
        (GofData, example_frames(fcfg, seed=3, n_patches=3)),
        (RefGofData, _mk(3, n_frames=1)),
    ):
        p = frames[0].meta.patches[0]
        p.size_2d_in_pixel = (p.size_uv0[0] * 8 - 3, p.size_uv0[1] * 8 - 5)
        sf = frames[0]
        gof = gof_cls(
            metas=[sf.meta], occ_planes=sf.occ_plane[None],
            geo_planes=[g * 4 for g in sf.geo_planes],
            attr_planes=list(sf.attr_planes), map_count=2,
            occupancy_precision=4, occupancy_resolution=8, absolute_d1=True,
            geo_shift=4, attribute_count=1, frame_count=1,
            packed10_ok=False,
        )
        if gof_cls is GofData:
            dec = Decoder(Params(device="cpu"))
            dec.start_gofs([gof])
            with pytest.raises(UnsupportedFeature, match=match):
                list(dec)
        else:
            with pytest.raises(RefUnsupportedFeature, match=match):
                list(ref_pipeline._reconstruct_gof_device(gof))


@pytest.mark.parametrize("depth", [1, 2])
def test_prepared_gofs_through_decoder_match_oracle(depth):
    """``Decoder.start_gofs``: three flagship-shaped GOFs, ``depth`` of
    them reconstructing at once, come out in order and equal the oracle
    path on the same GOFs."""
    from tpu_vpcc_torch.models.flagship import (
        FlagshipConfig,
        example_frames,
        example_gof,
    )

    fcfg = FlagshipConfig(128, 128, batch=2)
    frame_sets = [example_frames(fcfg, seed=s, n_patches=6) for s in (0, 2, 4)]

    def run(tiled, **kw):
        dec = Decoder(Params(**kw))
        dec.start_gofs(example_gof(fcfg, f, tiled=tiled) for f in frame_sets)
        out = [format_ply(f) for f in dec]
        assert dec.stats.total_frames == len(out)
        return out

    got = run(True, device="cpu", pipeline_gofs=depth)
    assert len(got) == 6
    assert got == run(False, use_device=False)


def test_cuda_device_without_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decoder(Params(VERIFY_STREAM, device="cuda"))
    # the oracle path needs no device
    Decoder(Params(VERIFY_STREAM, device="cuda", use_device=False))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GATHER_GOFS)
def test_gather_gofs_on_card_match_cpu(kind):
    """The gather fallback through ``Decoder.start_gofs`` on the card
    (slot math on the card, K1F) equals its CPU run, frame by frame."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")
    from tpu_vpcc_torch.models.flagship import FlagshipConfig
    from tpu_vpcc_torch.ops import shift_compact as sc

    fcfg = FlagshipConfig(128, 128, batch=2)
    gofs = [_gather_gof(kind, fcfg, s) for s in (0, 2)]

    def run(device):
        dec = Decoder(Params(device=device))
        dec.start_gofs(gofs)
        return [format_ply(f) for f in dec]

    before = sc.full_launches
    got = run("cuda")
    assert sc.full_launches == before + len(gofs)
    assert got == run("cpu")
