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
from typing import Dict, List

import numpy as np

from ..video.codec import VideoFrame

STORE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "video_store"
MANIFEST = "manifest.json"
#: the kernel wrappers whose calls an entry's manifest counts
KERNELS = ("K1", "K2W", "K1F")


class StoreMiss(LookupError):
    """A ``decompress_video`` call whose key the store does not hold."""


def video_key(data, codec_id: int, bytestream_video_coder: bool = True,
              tile: int = 0) -> str:
    """The store's key of one ``decompress_video`` call."""
    digest = hashlib.sha256(bytes(data)).hexdigest()
    return f"{digest}:{int(codec_id)}:{int(bool(bytestream_video_coder))}:{int(tile)}"


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
        self._arrays: Dict[str, dict] = {}
        self._lock = threading.Lock()
        #: lookups served
        self.hits = 0

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


def write_manifest(root, entries: Dict[str, dict], multi: dict) -> None:
    (Path(root) / MANIFEST).write_text(
        json.dumps({"entries": entries, "multi": multi}, indent=1) + "\n")


