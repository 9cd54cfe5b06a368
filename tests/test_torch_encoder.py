"""The port's encode side against ``tpu_vpcc``'s: the libx265 encoder of
the native bridge (``video.codec.encode_yuv420``), the V3C writer
(``v3c/writer.py``), ``build_fixture_stream`` (``utils/fixtures.py``)
and the roundtrip example; and the video store's served encode
(``tools/video_store.py::served_encode``), by which the port rebuilds
every committed stream without libx265.

libx265 does not always give the same bytes for the same input, even
with ``frame-threads=1`` (the bridge's setting): for some inputs two
outputs occur from run to run, in one process and on one core. Both
bridges build the same source against the same libx265, so the encoder
test holds the port to some output of the reference, drawing more
encodes of each while they have none in common, and reports a reference
that gave more than one as a reference flake. ``build_fixture_stream``
is held to ``tpu_vpcc``'s with both encoding through the committed store,
which gives one answer per input.
"""

from __future__ import annotations

import importlib
import warnings

import numpy as np
import pytest

from test_torch_e2e import STREAMS, needs_encoder
from test_torch_video_store import (
    NAMES,
    ROUNDTRIP,
    outputs_of,
    recipe,
    reference_roundtrip,
    wrapper_calls,
)
from tpu_vpcc.utils import fixtures as ref_fixtures
from tpu_vpcc.video import codec as ref_codec
from tpu_vpcc_torch.runtime import pipeline
from tpu_vpcc_torch.tools import video_store
from tpu_vpcc_torch.tools.video_store import (
    StoreMiss,
    VideoStore,
    annexb,
    encode_key,
    record_encoded,
    served,
    served_encode,
)
from tpu_vpcc_torch.utils import fixtures, ply
from tpu_vpcc_torch.video import codec

PACKAGES = ("tpu_vpcc_torch", "tpu_vpcc")
#: (bit depth, chroma format, lossless) of the encoder cases; lossy ones
#: at qp 8
MODES = [(bits, chroma, lossless) for bits in (8, 10)
         for chroma in ("420", "422", "444") for lossless in (True, False)]
#: encodes of each bridge drawn at most, while the two share no output
TRIES = 16


@pytest.fixture(scope="module")
def store():
    return VideoStore()


@pytest.fixture
def no_bridge(monkeypatch):
    """The port's native bridge may not load while the test runs, as on a
    machine without libavcodec and libx265: every call of its loader is
    recorded and refused, and the PLY writer formats with numpy, as it
    does there once its one try to load the bridge has failed."""
    calls = []

    def refuse():
        calls.append(1)
        raise OSError("the native video bridge is not available here")

    monkeypatch.setattr(codec, "_load", refuse)
    monkeypatch.setattr(ply, "_ply_lib", False)
    yield calls
    assert not calls, "the bridge's loader was called"


def _planes(bit_depth: int, chroma: str, frames: int = 3, size: int = 64):
    """Seeded random YUV planes: (size, size) luma, chroma by format."""
    rng = np.random.default_rng(1000 + bit_depth)
    dtype = np.uint8 if bit_depth == 8 else np.uint16
    ch, cw = {"420": (size // 2, size // 2), "422": (size, size // 2),
              "444": (size, size)}[chroma]
    return [[rng.integers(0, 1 << bit_depth, shape).astype(dtype)
             for shape in ((size, size), (ch, cw), (ch, cw))]
            for _ in range(frames)]


@needs_encoder
@pytest.mark.parametrize("bit_depth,chroma,lossless", MODES)
def test_encode_matches_reference(bit_depth, chroma, lossless):
    """``encode_yuv420`` of both bridges in one process: the port gives
    bytes that the reference gives for the same planes and arguments; a
    lossless encode decodes through the port's bridge to the planes."""
    frames = _planes(bit_depth, chroma)
    kw = dict(bit_depth=bit_depth, lossless=lossless, qp=8,
              chroma444=chroma == "444", chroma422=chroma == "422")
    port, ref = set(), set()
    for _ in range(TRIES):
        port.add(codec.encode_yuv420(frames, **kw))
        ref.add(ref_codec.encode_yuv420(frames, **kw))
        if port & ref:
            break
    if len(ref) > 1:
        warnings.warn(f"reference flake: tpu_vpcc's encode_yuv420 gave "
                      f"{len(ref)} different outputs for one input ({kw})")
    assert port & ref, f"no output in common in {TRIES} encodes each"
    if lossless:
        decoded = codec.decode_annexb(next(iter(port & ref)))
        assert [[p.tolist() for p in f.planes] for f in decoded] == \
            [[p.tolist() for p in f] for f in frames]


@needs_encoder
@pytest.mark.parametrize("bit_depth", [8, 10])
def test_encoder_supports_matches_reference(bit_depth):
    assert codec.encoder_supports(bit_depth) is True
    assert ref_codec.encoder_supports(bit_depth) is True


@pytest.mark.parametrize("package", PACKAGES)
def test_encode_refuses_no_frames(package):
    mod = importlib.import_module(f"{package}.video.codec")
    with pytest.raises(mod.VideoEncodeError, match="no frames"):
        mod.encode_yuv420([])


def _sei_body(package: str, msg) -> bytes:
    """The SEI payload of a parsed one-payload SEI NAL unit, written
    anew by ``package``'s writer."""
    syntax = importlib.import_module(f"{package}.v3c.syntax")
    w3c = importlib.import_module(f"{package}.v3c.writer")
    (sei,) = msg.sei_prefix + msg.sei_suffix
    if isinstance(sei, syntax.SeiGeometrySmoothing):
        return w3c.write_sei_geometry_smoothing(
            list(zip(sei.instance_index, sei.method_type,
                     sei.grid_size_minus_2, sei.threshold)),
            sei.persistence_flag, sei.reset_flag)
    if isinstance(sei, syntax.SeiAttributeSmoothing):
        return w3c.write_sei_attribute_smoothing(
            [(a, *inst) for j, a in enumerate(sei.attribute_idx)
             for inst in zip(sei.instance_index[j], sei.method_type[j],
                             sei.grid_size_minus_2[j], sei.threshold[j],
                             sei.threshold_variation[j],
                             sei.threshold_difference[j])],
            sei.persistence_flag, sei.reset_flag)
    if isinstance(sei, syntax.SeiDecodedAtlasInformationHash):
        return w3c.write_sei_daih(sei)
    raise TypeError(f"no writer for {type(sei).__name__}")


def _remux_atlas(package: str, payload: bytes, ctx) -> bytes:
    """An atlas-data payload parsed NAL by NAL with ``package``'s parsers
    into ``ctx`` and written anew by its writer."""
    m = lambda name: importlib.import_module(f"{package}.{name}")  # noqa: E731
    bitio, syntax, w3c = m("bitio"), m("v3c.syntax"), m("v3c.writer")
    nal_type = syntax.NalUnitType
    precision = (payload[0] >> 5) + 1
    nals, i = [], 1
    while i < len(payload):
        n = int.from_bytes(payload[i:i + precision], "big")
        nals.append(payload[i + precision:i + precision + n])
        i += precision + n
    out = []
    for nal in nals:
        t = nal_type((nal[0] >> 1) & 63)
        bs = bitio.Bitstream(nal[2:])
        if t == nal_type.ASPS:
            asps = syntax.AtlasSequenceParameterSet.parse(bs)
            ctx.add_asps(asps)
            body = w3c.write_asps(asps)
        elif t == nal_type.AFPS:
            afps = syntax.AtlasFrameParameterSet.parse(bs, ctx)
            ctx.add_afps(afps)
            body = w3c.write_afps(
                afps, ctx.get_asps(afps.atlas_sequence_parameter_set_id))
        elif t in syntax.TILE_NAL_TYPES:
            atl = syntax.AtlasTileLayer.parse(bs, ctx, t)
            ctx.add_atlas_tile_layer(atl)
            afps = ctx.get_afps(atl.header.atlas_frame_parameter_set_id)
            body = w3c.write_atlas_tile_layer(
                atl, ctx.get_asps(afps.atlas_sequence_parameter_set_id),
                afps, t)
        else:
            body = _sei_body(package, syntax.SeiMessage.parse(
                bs, t, end_byte=len(nal) - 2))
        out.append(w3c.wrap_nal_unit(t, body))
    return w3c.build_nal_sample_stream(out, precision)


def remux(package: str, data: bytes) -> bytes:
    """``data`` parsed with ``package``'s parsers and written anew with
    its writer: each unit header by ``v3c_unit_header``, the VPS by
    ``write_vps`` (and ``write_ptl``), each atlas NAL unit by
    ``wrap_nal_unit`` over ``write_asps`` (``write_vui``,
    ``write_ref_list_struct``), ``write_afps``,
    ``write_atlas_tile_layer`` (``_write_plrd``) or the SEI writers, the
    atlas data by ``build_nal_sample_stream``, each video sub-bitstream
    through ``annexb_to_length_prefixed``, and the file by
    ``V3CSampleStreamWriter``."""
    m = lambda name: importlib.import_module(f"{package}.{name}")  # noqa: E731
    bitio, syntax, w3c = m("bitio"), m("v3c.syntax"), m("v3c.writer")
    unit_type = syntax.V3CUnitType
    sw = w3c.V3CSampleStreamWriter()
    ctx = None
    for unit in m("v3c.stream").SampleStreamV3CUnit.from_bitstream(
            bitio.Bitstream(data)).units:
        bs = bitio.Bitstream(unit.data)
        t = unit_type(bs.read(5))
        kw = {}
        if t != unit_type.VPS:
            kw.update(vps_id=bs.read(4), atlas_id=bs.read(6))
        if t == unit_type.AVD:
            kw.update(attribute_index=bs.read(7),
                      attribute_dimension_index=bs.read(5),
                      map_index=bs.read(4),
                      auxiliary_video_flag=bool(bs.read(1)))
        elif t == unit_type.GVD:
            kw.update(map_index=bs.read(4),
                      auxiliary_video_flag=bool(bs.read(1)))
        payload = unit.data[4:]
        if t == unit_type.VPS:
            ctx = m("v3c.context").Context()
            vps = syntax.V3CParameterSet.parse(bitio.Bitstream(payload))
            ctx.add_vps(vps)
            payload = w3c.write_vps(vps)
        elif t == unit_type.AD:
            payload = _remux_atlas(package, payload, ctx)
        else:
            payload = w3c.annexb_to_length_prefixed(annexb(payload))
        sw.add_unit(w3c.v3c_unit_header(t, **kw), payload)
    return sw.getvalue()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_writer_matches_reference(name, store):
    """Every family's committed stream parsed and written anew by each
    package's writer: the port's bytes equal the reference's, and both
    equal the stream."""
    data = store.entries[name].stream.read_bytes()
    assert remux("tpu_vpcc_torch", data) == remux("tpu_vpcc", data) == data


@pytest.mark.parametrize("writer,args", [
    ("write_sei_occupancy_synthesis", (((0, 1, 1, 0, 2), (1, 0, 0, 0, 0)),
                                       True, False)),
    ("write_sei_raw", (200, b"\x01\x02\xff" * 100)),
    ("write_sei_geometry_smoothing", (((0, 1, 6, 16), (1, 2, 0, 0)),)),
    ("write_sei_attribute_smoothing", (((0, 0, 1, 6, 0, 255, 1),),)),
])
def test_sei_writer_matches_reference(writer, args):
    """The SEI writers that no family's stream carries in this form."""
    port = importlib.import_module("tpu_vpcc_torch.v3c.writer")
    ref = importlib.import_module("tpu_vpcc.v3c.writer")
    assert getattr(port, writer)(*args) == getattr(ref, writer)(*args)


@pytest.mark.parametrize("name", NAMES)
def test_build_fixture_stream_matches_reference(name, store, no_bridge,
                                                monkeypatch):
    """Each entry's recipe through the port's and ``tpu_vpcc``'s
    ``build_fixture_stream``, both encoding through the committed store:
    the same encoder inputs (a miss raises) and the same bytes, the
    committed stream's."""
    monkeypatch.setattr(ref_fixtures, "encode_yuv420", store.encode)
    ref = recipe(name, "tpu_vpcc")
    with served_encode(store):
        got = recipe(name, "tpu_vpcc_torch")
    assert got == ref == store.entries[name].stream.read_bytes()


@pytest.mark.parametrize("name", NAMES)
def test_recorded_encodes_rebuild_entry(name, store, no_bridge):
    """``record_encoded`` on the port's recipe, with no encoder: the
    rebuilt stream equals the committed one (it raises otherwise), and
    each recorded encode is the manifest's, or one that another entry
    holds with the same bytes."""
    e = store.entries[name]
    table = record_encoded(name, e.stream.read_bytes(),
                           lambda: recipe(name, "tpu_vpcc_torch"))
    assert table
    for key, where in table.items():
        held = store.encoded[key]
        if held["entry"] == name:
            assert held == where
        else:
            assert store.encoded_bitstream(key) == annexb(
                video_store.video_units(e.stream.read_bytes())[where["unit"]])


def test_encoded_table_covers_every_entry(store):
    """The manifest's ``encoded`` table: each key names an entry (the
    first, in ``NAMES`` order, of those whose streams hold its
    sub-bitstream) and a unit that lies in its entry's stream."""
    assert {w["entry"] for w in store.encoded.values()} <= set(NAMES)
    for key, where in store.encoded.items():
        units = video_store.video_units(
            store.entries[where["entry"]].stream.read_bytes())
        assert 0 <= where["unit"] < len(units), key


def test_missing_encode_raises(store, tmp_path, no_bridge):
    """An encode the store does not hold raises :class:`StoreMiss`: in a
    lookup, and in a build under ``served_encode``; no fall-through to
    the bridge."""
    frames = _planes(10, "420", frames=1)
    with pytest.raises(StoreMiss, match="holds no encode"):
        store.encode(frames, bit_depth=10)
    key = next(iter(store.encoded))
    with pytest.raises(StoreMiss):
        store.encoded_bitstream(key[:-1] + ("0" if key[-1] != "0" else "1"))
    from tpu_vpcc_torch.examples.roundtrip import scene

    frames = scene()
    frames[0].geo_planes[0][0, 0] ^= 4  # one sample off the committed scene
    with served_encode(store), pytest.raises(StoreMiss):
        fixtures.build_fixture_stream(frames)


def test_encode_key_covers_planes_and_arguments():
    """The key changes with a sample, a dtype, a shape and every
    argument, and not with the planes' memory layout."""
    frames = _planes(10, "420", frames=2)
    key = encode_key(frames, bit_depth=10)
    assert key == encode_key([[np.asfortranarray(p) for p in f]
                              for f in frames], 10)
    changed = [[p.copy() for p in f] for f in frames]
    changed[1][2][3, 4] += 1
    variants = [
        encode_key(changed, bit_depth=10),
        encode_key([[p.astype(np.uint32) for p in f] for f in frames], 10),
        encode_key([[p.reshape(1, -1) for p in f] for f in frames], 10),
        encode_key(frames, bit_depth=8),
        encode_key(frames, bit_depth=10, lossless=False),
        encode_key(frames, bit_depth=10, gop=16),
        encode_key(frames, bit_depth=10, qp=8),
        encode_key(frames, bit_depth=10, chroma444=True),
        encode_key(frames, bit_depth=10, chroma422=True),
    ]
    assert len({key, *variants}) == len(variants) + 1


def test_served_encode_restores_encoder(store):
    """After ``served_encode`` exits, on return and on error, the
    name ``build_fixture_stream`` calls, ``fixtures.encode_yuv420``, is
    the bridge's function again."""
    assert fixtures.encode_yuv420 is codec.encode_yuv420
    with served_encode(store):
        assert fixtures.encode_yuv420 == store.encode
    assert fixtures.encode_yuv420 is codec.encode_yuv420
    with pytest.raises(RuntimeError, match="inside"):
        with served_encode(store):
            raise RuntimeError("inside")
    assert fixtures.encode_yuv420 is codec.encode_yuv420


@needs_encoder
def test_roundtrip_example_matches_reference(tmp_path):
    """The port's roundtrip example on the CPU, through its own encoder
    and bridge, writes the PLY files of ``examples/roundtrip.py`` byte for
    byte, and the store's digests of them."""
    from tpu_vpcc_torch.examples.roundtrip import main

    reference_roundtrip(tmp_path / "ref")
    assert main(tmp_path / "port", device="cpu") == 0
    got = outputs_of(tmp_path / "port")
    assert got == outputs_of(tmp_path / "ref")
    assert got == VideoStore().entries[ROUNDTRIP].outputs


def test_roundtrip_example_served(store, tmp_path, no_bridge):
    """The port's roundtrip example as the card runs it, here on the CPU:
    with the store in place of libx265 and of the HEVC decode, the
    committed stream and the manifest's PLY files and kernel wrapper
    calls."""
    from tpu_vpcc_torch.examples.roundtrip import main

    e = store.entries[ROUNDTRIP]
    with served_encode(store), served(store), wrapper_calls() as calls:
        assert main(tmp_path, device="cpu") == 0
    assert calls == e.launches
    assert (tmp_path / "stream.bin").read_bytes() == e.stream.read_bytes()
    assert outputs_of(tmp_path) == e.outputs
    assert pipeline.decompress_video is not store.lookup
