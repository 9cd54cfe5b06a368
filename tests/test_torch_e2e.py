"""Fixture streams decoded by the PyTorch port on the CPU.

The PLY bytes of every frame must equal tpu_vpcc's device decode (JAX on
the CPU) and the numpy oracle's. The port never imports jax: subprocesses
decode through ``Decoder`` and ``python -m tpu_vpcc_torch.runtime.cli``
(a plain and a smoothing stream) and then check ``sys.modules``.
"""
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from tpu_vpcc.atlas.patches import Patch
from tpu_vpcc.runtime import cli as ref_cli
from tpu_vpcc.runtime.pipeline import Decoder as RefDecoder
from tpu_vpcc.runtime.pipeline import Params as RefParams
from tpu_vpcc.utils.fixtures import build_fixture_stream
from tpu_vpcc.utils.ply import format_ply
from tpu_vpcc.utils.synthetic import make_synthetic_frame, plant_raw_patch
from tpu_vpcc.v3c.syntax import PatchOrientation
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


def _stream_vui():
    from tests.test_vui import rich_vui

    return build_fixture_stream(_mk(53), vui=rich_vui())


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
}

SMOOTHING = dict(apply_geo_smoothing_type=True, apply_attr_smoothing_type=True)
#: decoder options of a family (the reference's Params takes the same)
STREAM_PARAMS = {"smoothing": SMOOTHING, "smoothing_secondary": SMOOTHING}


def _decode(decoder_cls, params_cls, data, **kw):
    dec = decoder_cls(params_cls(data, **kw))
    dec.start()
    return [format_ply(f) for f in dec]


@needs_encoder
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_matches_reference_and_oracle(name):
    data = STREAMS[name]()
    kw = STREAM_PARAMS.get(name, {})
    got = _decode(Decoder, Params, data, device="cpu", **kw)
    ref = _decode(RefDecoder, RefParams, data, **kw)
    oracle = _decode(RefDecoder, RefParams, data, use_device=False, **kw)
    port_oracle = _decode(Decoder, Params, data, use_device=False, **kw)
    assert len(got) >= 1
    if name in ("raw_eom_secondary", "smoothing_secondary"):
        header = got[0].split(b"end_header")[0]
        assert b"property ushort reflectance" in header
        assert b"property uchar red2" in header
    assert got == ref
    assert got == oracle
    assert port_oracle == oracle


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
    """A ROT90 patch at resolution 16 has no block-aligned pixel tile:
    it needs the gather fallback, not yet ported."""
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
    dec = Decoder(Params(build_fixture_stream([sf]), device="cpu"))
    dec.start()
    with pytest.raises(UnsupportedFeature, match="ROADMAP queue 1 #8"):
        list(dec)


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
