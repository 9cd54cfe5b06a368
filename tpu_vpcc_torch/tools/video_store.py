"""A committed store of decoded video: V3C streams beside the frames the
native libavcodec bridge decoded from their HEVC sub-bitstreams.

On a machine without libavcodec, :func:`served` puts a lookup in this
store in place of ``runtime.pipeline.decompress_video``, the decoder's
one call into the bridge; everything else (V3C parse, atlas, group
tables, staging, the kernels, smoothing, the host tails, PLY) runs as
it does with the bridge:

    store = VideoStore()
    with served(store):
        cli.main(["-i", str(store.entries["verify"].stream), "-o", "out/"])

The store is one directory (:data:`STORE_DIR`) holding, per entry, the
stream ``<entry>.v3c`` (or the manifest's path to a stream committed
elsewhere) and the decoded frames ``<entry>.npz`` (LZMA-compressed; a
result that an earlier entry holds is not written again), and one
``manifest.json``. Each decoded result is keyed by the arguments of
``decompress_video``: the SHA-256 of the sub-bitstream, ``codec_id``,
``bytestream_video_coder`` and ``tile`` (a ``tile > 0`` decode returns
block-tiled planes). The store keeps each result as the bridge returned
it, byte for byte and in its layout, with every frame's bit depth,
chroma shifts and ``is_rgb``.

For each entry the manifest lists its stream, the CLI flags and
``Params`` keywords it decodes with, each output file's name, point
count and the SHA-256 of its PLY bytes (as ``tpu_vpcc``'s CLI writes
them with default options), how many times the device decode calls each
kernel wrapper (K1 ``shift_compact_ops``, K2W ``wide_words``, K1F
``shift_compact_full``), and the keys of its decoded results; under
``multi``, one several-``-i`` CLI run over some of the entries. The
entries are written with :func:`recording`, :func:`write_entry` and
:func:`write_manifest` (``python tests/test_torch_video_store.py
--write``, on a machine with libavcodec and libx265).

The same store serves the encode side. :func:`served_encode` puts a
lookup in place of the HEVC encoder of ``build_fixture_stream``
(``utils.fixtures.encode_yuv420``), so that the port rebuilds the
store's streams where libx265 is absent:

    with served_encode(store):
        stream = build_fixture_stream(flagship_frames(), **FLAGSHIP_BUILD)

Each encode is keyed by :func:`encode_key` (the input planes and the
call's arguments); the manifest's ``encoded`` table maps the key to an
entry and the index of one of its stream's video units, and the lookup
returns that sub-bitstream as Annex-B bytes. :func:`record_encoded`
finds the table without an encoder.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import zipfile
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np

from ..bitio import Bitstream
from ..v3c.stream import SampleStreamV3CUnit
from ..v3c.syntax import V3CUnitType
from ..video.codec import VideoFrame

STORE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "video_store"
MANIFEST = "manifest.json"
#: the kernel wrappers whose calls an entry's manifest counts
KERNELS = ("K1", "K2W", "K1F")
#: the video units of a V3C stream, whose payloads are HEVC sub-bitstreams
VIDEO_UNITS = (V3CUnitType.OVD, V3CUnitType.GVD, V3CUnitType.AVD)
#: how ``flagship_1280_q8`` codes :func:`flagship_frames`
FLAGSHIP_BUILD = {"lossless": False, "qp": 8}


class StoreMiss(LookupError):
    """A ``decompress_video`` or ``encode_yuv420`` call whose key the
    store does not hold."""


def video_key(data, codec_id: int, bytestream_video_coder: bool = True,
              tile: int = 0) -> str:
    """The store's key of one ``decompress_video`` call."""
    digest = hashlib.sha256(bytes(data)).hexdigest()
    return f"{digest}:{int(codec_id)}:{int(bool(bytestream_video_coder))}:{int(tile)}"


def encode_key(frames, bit_depth: int = 8, lossless: bool = True,
               gop: int = 32, qp: int = 20, chroma444: bool = False,
               chroma422: bool = False) -> str:
    """The store's key of one ``encode_yuv420`` call (the same arguments,
    the same defaults): the SHA-256 of every input plane's dtype, shape
    and bytes, in order, and of the call's arguments."""
    h = hashlib.sha256()
    for planes in frames:
        for plane in planes:
            a = np.ascontiguousarray(plane)
            h.update(f"{a.dtype.str}{a.shape};".encode())
            h.update(a.tobytes())
    h.update(json.dumps([int(bit_depth), bool(lossless), int(gop), int(qp),
                         bool(chroma444), bool(chroma422)]).encode())
    return h.hexdigest()


def video_units(stream: bytes) -> List[bytes]:
    """The payloads of the stream's video units (:data:`VIDEO_UNITS`), in
    stream order: each a sub-bitstream of length-prefixed NAL units."""
    ssvu = SampleStreamV3CUnit.from_bitstream(Bitstream(bytes(stream)))
    return [u.data[4:] for u in ssvu.units if u.unit_type in VIDEO_UNITS]


def annexb(sub_bitstream: bytes, precision: int = 4) -> bytes:
    """The sub-bitstream's NAL units, each behind a 4-byte start code:
    the Annex-B bytes that ``v3c.writer.annexb_to_length_prefixed`` turns
    back into ``sub_bitstream``."""
    out = bytearray()
    i = 0
    while i < len(sub_bitstream):
        n = int.from_bytes(sub_bitstream[i:i + precision], "big")
        i += precision
        out += b"\x00\x00\x00\x01" + sub_bitstream[i:i + n]
        i += n
    return bytes(out)


def _frame_meta(f: VideoFrame) -> dict:
    return {"bit_depth": int(f.bit_depth),
            "chroma_w_shift": int(f.chroma_w_shift),
            "chroma_h_shift": int(f.chroma_h_shift),
            "is_rgb": bool(f.is_rgb)}


def _array_name(call: int, frame: int, plane: int) -> str:
    return f"c{call}_f{frame}_p{plane}"


@dataclass
class Entry:
    """One stream of the store and what its decode must give."""

    name: str
    stream: Path
    flags: List[str]
    params: Dict[str, object]
    #: per output file: ``{"name", "points", "sha256"}``
    outputs: List[dict]
    #: kernel wrapper calls of the device decode, by :data:`KERNELS`
    launches: Dict[str, int]
    #: per decoded result: ``{"key", "npz", "index", "frames": [frame
    #: meta, ...]}``, its planes in ``<npz>.npz`` as ``c<index>_f*_p*``
    calls: List[dict]


class VideoStore:
    """The store at ``root``, read from its manifest; the decoded frames
    of an entry load on its first lookup. Safe to call from the
    decoder's video threads."""

    def __init__(self, root=STORE_DIR):
        self.root = Path(root)
        manifest = json.loads((self.root / MANIFEST).read_text())
        self.multi = manifest.get("multi")
        self.entries: Dict[str, Entry] = {}
        self._index = {}
        for name, e in manifest["entries"].items():
            self.entries[name] = Entry(
                name=name, stream=(self.root / e["stream"]).resolve(),
                flags=e["flags"], params=e["params"], outputs=e["outputs"],
                launches=e["launches"], calls=e["calls"],
            )
            for call in e["calls"]:
                self._index[call["key"]] = call
        #: per ``encode_yuv420`` key: ``{"entry", "unit"}``, the entry
        #: whose stream holds the sub-bitstream and its video unit index
        self.encoded: Dict[str, dict] = manifest.get("encoded", {})
        self._arrays: Dict[str, dict] = {}
        self._units: Dict[str, List[bytes]] = {}
        self._lock = threading.Lock()
        #: lookups served
        self.hits = 0
        #: encodes served
        self.encode_hits = 0

    def _arrays_of(self, npz: str) -> dict:
        with self._lock:
            if npz not in self._arrays:
                with np.load(self.root / f"{npz}.npz") as z:
                    self._arrays[npz] = {k: z[k] for k in z.files}
            return self._arrays[npz]

    def frames(self, key: str) -> List[VideoFrame]:
        """The decoded result stored under ``key``, as new ``VideoFrame``
        objects holding copies of the stored planes (the caller may
        change them in place). Raises :class:`StoreMiss`."""
        try:
            call = self._index[key]
        except KeyError:
            raise StoreMiss(
                f"the video store {self.root} holds no decode of "
                f"sub-bitstream {key} (sha256:codec_id:bytestream:tile)"
            ) from None
        arrays = self._arrays_of(call["npz"])
        return [
            VideoFrame(
                planes=[arrays[_array_name(call["index"], f, p)].copy()
                        for p in range(3)],
                **meta,
            )
            for f, meta in enumerate(call["frames"])
        ]

    def lookup(self, data, codec_id: int, bytestream_video_coder: bool = True,
               tile: int = 0) -> List[VideoFrame]:
        """``decompress_video``'s result for these arguments, from
        :meth:`frames`; counted in :attr:`hits`."""
        frames = self.frames(
            video_key(data, codec_id, bytestream_video_coder, tile))
        with self._lock:
            self.hits += 1
        return frames

    def encoded_bitstream(self, key: str) -> bytes:
        """The Annex-B bytes of the sub-bitstream that the encode keyed
        ``key`` became in its entry's stream. Raises :class:`StoreMiss`."""
        try:
            where = self.encoded[key]
        except KeyError:
            raise StoreMiss(
                f"the video store {self.root} holds no encode {key} "
                f"(sha256 of the planes and arguments)"
            ) from None
        name = where["entry"]
        with self._lock:
            if name not in self._units:
                self._units[name] = video_units(
                    self.entries[name].stream.read_bytes())
            units = self._units[name]
        return annexb(units[where["unit"]])

    def encode(self, frames, *args, **kw) -> bytes:
        """``encode_yuv420``'s result for these arguments (its own), from
        :meth:`encoded_bitstream`; counted in :attr:`encode_hits`."""
        data = self.encoded_bitstream(encode_key(frames, *args, **kw))
        with self._lock:
            self.encode_hits += 1
        return data


@contextmanager
def served(store: VideoStore):
    """Decode with ``store`` in place of the video bridge: swaps
    ``runtime.pipeline.decompress_video`` for :meth:`VideoStore.lookup`
    and restores it on exit, on error too."""
    from ..runtime import pipeline

    original = pipeline.decompress_video
    pipeline.decompress_video = store.lookup
    try:
        yield store
    finally:
        pipeline.decompress_video = original


@contextmanager
def _encoder(encode: Callable[..., bytes]):
    """``encode`` in place of the HEVC encoder of ``build_fixture_stream``
    (``utils.fixtures.encode_yuv420``, the name it calls) while
    open; restored on exit, on error too."""
    from ..utils import fixtures

    original = fixtures.encode_yuv420
    fixtures.encode_yuv420 = encode
    try:
        yield
    finally:
        fixtures.encode_yuv420 = original


@contextmanager
def served_encode(store: VideoStore):
    """Build fixture streams with ``store`` in place of libx265: swaps
    ``utils.fixtures.encode_yuv420`` for :meth:`VideoStore.encode` (a
    missing key raises :class:`StoreMiss`; nothing falls through to the
    bridge) and restores it on exit, on error too."""
    with _encoder(store.encode):
        yield store


def record_encoded(name: str, stream: bytes,
                   build: Callable[[], bytes]) -> Dict[str, dict]:
    """The ``encoded`` table of entry ``name``, found without an encoder:
    ``build()``, the entry's recipe through the port's
    ``build_fixture_stream``, runs twice. In the first run the n-th encode
    returns a marker sub-bitstream, which shows the video unit of the
    stream that the call becomes (``build_fixture_stream`` writes the
    occupancy video first but encodes it after the others). In the
    second each encode
    returns that unit of ``stream``, the committed bytes, and the rebuilt
    stream must equal ``stream`` byte for byte, which proves the table.
    Raises ``ValueError`` where a unit is no single call's or the
    streams differ."""
    keys: List[str] = []

    def marker(frames, *args, **kw):
        keys.append(encode_key(frames, *args, **kw))
        return marker_unit(len(keys) - 1)

    with _encoder(marker):
        probe = build()
    calls = {annexb(u): k for k, u in enumerate(video_units(probe))}
    markers = [marker_unit(n) for n in range(len(keys))]
    if sorted(calls) != sorted(markers):
        raise ValueError(f"{name}: the video units of the stream are not "
                         f"its {len(keys)} encodes, one each")
    table = {}
    for n, key in enumerate(keys):
        table.setdefault(key, {"entry": name, "unit": calls[markers[n]]})
    units = video_units(stream)

    def committed(frames, *args, **kw):
        return annexb(units[table[encode_key(frames, *args, **kw)]["unit"]])

    with _encoder(committed):
        rebuilt = build()
    if rebuilt != bytes(stream):
        raise ValueError(f"{name}: the stream rebuilt from the committed "
                         f"sub-bitstreams differs from the committed one")
    return table


def marker_unit(n: int) -> bytes:
    """The Annex-B bytes of :func:`record_encoded`'s n-th marker."""
    return b"\x00\x00\x00\x01" + f"encode {n:08d}".encode()


def block_constant(plane: np.ndarray, block: int) -> np.ndarray:
    """Each ``block`` x ``block`` block of ``plane`` set to its top-left
    sample."""
    h, w = plane.shape
    corners = plane[::block, ::block]
    return np.repeat(np.repeat(corners, block, 0), block, 1)[:h, :w].copy()


def flagship_frames(make_synthetic_frame=None) -> list:
    """The frames of ``flagship_1280_q8``, which codes them with
    :data:`FLAGSHIP_BUILD`: two 1280^2 frames of 48 patches (two maps,
    resolution 16, precision 4, fill 0.7, one generator seeded 0), their
    geometry block-constant at 16x16 and their attributes at 16x16 in
    luma and 8x8 in chroma. ``make_synthetic_frame``: the scene generator,
    by default the port's ``utils.synthetic.make_synthetic_frame``."""
    if make_synthetic_frame is None:
        from ..utils.synthetic import make_synthetic_frame

    rng = np.random.default_rng(0)
    frames = []
    for i in range(2):
        sf = make_synthetic_frame(
            rng, width=1280, height=1280, occupancy_resolution=16,
            occupancy_precision=4, map_count=2, n_patches=48,
            occupancy_fill=0.7, frame_index=i,
        )
        sf.geo_planes = [block_constant(p, 16) for p in sf.geo_planes]
        sf.attr_planes = [
            [block_constant(y, 16), block_constant(u, 8),
             block_constant(v, 8)]
            for y, u, v in sf.attr_planes
        ]
        frames.append(sf)
    return frames


@contextmanager
def recording(calls: Dict[str, List[VideoFrame]]):
    """Decode through the bridge and keep a copy of each result in
    ``calls``, by :func:`video_key`."""
    from ..runtime import pipeline

    original = pipeline.decompress_video
    lock = threading.Lock()

    def record(data, codec_id, bytestream_video_coder=True, tile=0):
        frames = original(data, codec_id, bytestream_video_coder, tile)
        key = video_key(data, codec_id, bytestream_video_coder, tile)
        copies = [VideoFrame([p.copy() for p in f.planes], f.bit_depth,
                             f.chroma_w_shift, f.chroma_h_shift, f.is_rgb)
                  for f in frames]
        with lock:
            calls.setdefault(key, copies)
        return frames

    pipeline.decompress_video = record
    try:
        yield calls
    finally:
        pipeline.decompress_video = original


def _save_npz(path, arrays: dict) -> None:
    """``np.savez_compressed``'s format, compressed with LZMA in place of
    deflate (``np.load`` reads either)."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_LZMA) as zf:
        for name, a in arrays.items():
            with zf.open(f"{name}.npy", "w") as f:
                np.lib.format.write_array(f, np.ascontiguousarray(a),
                                          allow_pickle=False)


def write_entry(root, name: str, stream, calls: Dict[str, List[VideoFrame]],
                written: Dict[str, dict], **fields) -> dict:
    """Write under ``root`` the stream as ``<name>.v3c`` where ``stream``
    is bytes (a path is referred to where it lies), and ``<name>.npz``
    with the decoded results of ``calls`` that no entry in ``written``
    (each call's record, by key; updated here) holds yet. Returns the
    entry's manifest record (``fields``: flags, params, outputs,
    launches)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    if isinstance(stream, (bytes, bytearray)):
        (root / f"{name}.v3c").write_bytes(stream)
        stream = root / f"{name}.v3c"
    arrays = {}
    new = [(key, frames) for key, frames in sorted(calls.items())
           if key not in written]
    for c, (key, frames) in enumerate(new):
        written[key] = {"key": key, "npz": name, "index": c,
                        "frames": [_frame_meta(f) for f in frames]}
        for f, frame in enumerate(frames):
            for p, plane in enumerate(frame.planes):
                arrays[_array_name(c, f, p)] = plane
    if arrays:
        _save_npz(root / f"{name}.npz", arrays)
    return dict(stream=os.path.relpath(stream, root), **fields,
                calls=[written[key] for key in sorted(calls)])


def write_manifest(root, entries: Dict[str, dict], multi: dict,
                   encoded: Dict[str, dict]) -> None:
    (Path(root) / MANIFEST).write_text(json.dumps(
        {"entries": entries, "multi": multi, "encoded": encoded},
        indent=1) + "\n")


