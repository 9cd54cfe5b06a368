"""Python binding for the native HEVC codec bridge (ctypes, no pybind11).

Decode path parity: reference ``LibavcodecDecoder`` (``src/decoder.rs:
1087-1157``) — but feeding libavcodec from memory instead of a tempfile.
Decoded planes are returned as NumPy arrays: ``uint8`` for 8-bit streams
(occupancy) and native-endian ``uint16`` for 10-bit streams (geometry /
attribute), matching the reference's ``Image<u8>``/``Image<u16>`` reads
(``src/decoder.rs:1002-1021``).

The module self-builds the shared library with ``make`` on first use,
under a name of its own (``libtpu_vpcc_torch_video.so``), so that it never
meets the JAX package's library of the same C symbols.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

log = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).resolve().parent / "native"
_LIB_PATH = _NATIVE_DIR / "libtpu_vpcc_torch_video.so"
_lib = None
_lib_lock = threading.Lock()


def _build_native() -> None:
    """Build to a name of this process's own, then rename it into place:
    processes that reach the first use together each build, and none
    can load a half-written file."""
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR), f"TARGET={tmp.name}"],
            check=True,
            capture_output=True,
            text=True,
        )
        os.replace(tmp, _LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        srcs = [_NATIVE_DIR / "video_codec.cc", _NATIVE_DIR / "pack_planes.cc"]
        newest = max(s.stat().st_mtime for s in srcs if s.exists())
        if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < newest:
            log.info("building native video codec bridge")
            _build_native()
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.vdec_open.restype = ctypes.c_void_p
        lib.vdec_open.argtypes = [ctypes.c_int]
        lib.vdec_open_threads.restype = ctypes.c_void_p
        lib.vdec_open_threads.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.vdec_decode.restype = ctypes.c_int
        lib.vdec_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.vdec_frame_count.restype = ctypes.c_int
        lib.vdec_frame_count.argtypes = [ctypes.c_void_p]
        lib.vdec_frame_info.restype = ctypes.c_int
        lib.vdec_frame_info.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vdec_copy_plane.restype = ctypes.c_int64
        lib.vdec_copy_plane.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.vdec_copy_plane_tiled.restype = ctypes.c_int64
        lib.vdec_copy_plane_tiled.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.vdec_thread_info.restype = ctypes.c_int
        lib.vdec_thread_info.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vdec_error.restype = ctypes.c_char_p
        lib.vdec_error.argtypes = [ctypes.c_void_p]
        lib.vdec_close.restype = None
        lib.vdec_close.argtypes = [ctypes.c_void_p]
        lib.venc_open.restype = ctypes.c_void_p
        lib.venc_open.argtypes = [ctypes.c_int] * 7
        lib.venc_encode_frame.restype = ctypes.c_int
        lib.venc_encode_frame.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.venc_flush.restype = ctypes.c_int
        lib.venc_flush.argtypes = [ctypes.c_void_p]
        lib.venc_output_size.restype = ctypes.c_int64
        lib.venc_output_size.argtypes = [ctypes.c_void_p]
        lib.venc_copy_output.restype = ctypes.c_int64
        lib.venc_copy_output.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.venc_error.restype = ctypes.c_char_p
        lib.venc_error.argtypes = [ctypes.c_void_p]
        lib.venc_close.restype = None
        lib.venc_close.argtypes = [ctypes.c_void_p]

        lib.vpp_pack_planes.restype = ctypes.c_int
        lib.vpp_pack_planes.argtypes = [
            ctypes.c_void_p, ctypes.c_int,                   # occ, es
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # geo0/1, es
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int,                                    # ay/au/av, es
            ctypes.c_void_p,                                 # swap mask
            ctypes.c_void_p,                                 # out
            ctypes.c_int64, ctypes.c_int64,                  # F, nb
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return lib


def native_pack_planes(occ_t, geo0_t, geo1_t, ay_t, au_t, av_t, cfg,
                       swap=None):
    """Native host pack into the cat-mode dispatch layout (the C twin of
    ``ops.tiled.pack_planes_host`` — ~10x the numpy form on one core).
    ``swap``: optional (F, nb) u8 mask; flagged blocks are written
    TRANSPOSED (the host orientation fix folded into the pack's
    per-pixel loop — free, unlike a separate transpose pass). Returns
    the (F, nb, 3*res*res) u32 cat, or None when the native library is
    unavailable (caller falls back to numpy)."""
    try:
        lib = _load()
    except Exception:  # no toolchain / libavcodec — numpy fallback
        return None

    res = cfg.occupancy_resolution
    F, nb = occ_t.shape[0], occ_t.shape[1]

    def prep(a):
        a = np.ascontiguousarray(a)
        assert a.dtype in (np.uint8, np.uint16), a.dtype
        return a, a.dtype.itemsize

    occ, occ_es = prep(occ_t)
    geo0, geo_es = prep(geo0_t)
    geo1, geo_es2 = prep(geo1_t)
    ay, attr_es = prep(ay_t)
    au, attr_es2 = prep(au_t)
    av, attr_es3 = prep(av_t)
    if geo_es2 != geo_es or attr_es2 != attr_es or attr_es3 != attr_es:
        return None  # mixed element sizes within a family: numpy handles it
    if swap is not None:
        swap = np.ascontiguousarray(swap, dtype=np.uint8)
        assert swap.shape == (F, nb), swap.shape
    out = np.empty((F, nb, 3 * res * res), dtype=np.uint32)
    rc = lib.vpp_pack_planes(
        occ.ctypes.data, occ_es,
        geo0.ctypes.data, geo1.ctypes.data, geo_es,
        ay.ctypes.data, au.ctypes.data, av.ctypes.data, attr_es,
        None if swap is None else swap.ctypes.data,
        out.ctypes.data,
        F, nb, res, cfg.occupancy_precision, cfg.chroma_shift,
        cfg.map_count,
    )
    return out if rc == 0 else None


@dataclass
class VideoFrame:
    """One decoded YUV frame, tightly packed planes.

    ``planes[0]`` is (h, w); chroma planes are (h >> ch_shift, w >> cw_shift).
    dtype is uint8 for 8-bit, uint16 for >8-bit content.
    """

    planes: List[np.ndarray]
    bit_depth: int
    chroma_w_shift: int
    chroma_h_shift: int
    is_rgb: bool = False  # GBR-family format (plane order G,B,R as decoded)

    @property
    def width(self) -> int:
        return self.planes[0].shape[1]

    @property
    def height(self) -> int:
        return self.planes[0].shape[0]


class VideoDecodeError(Exception):
    pass


def decode_annexb(
    data: bytes, codec_id: int = 1, tile: int = 0
) -> List[VideoFrame]:
    """Decode an Annex-B HEVC (codec_id=1) / H.264 (0) bytestream.

    Returns frames in output order. codec_id values follow the reference's
    ``CodecId`` mapping (``src/decoder.rs:891-910``).

    With ``tile > 0``, luma planes come back block-tiled as
    ``(n_blocks, tile, tile)`` and chroma planes as
    ``(n_blocks, tile//2, tile//2)`` — the layout the TPU reconstruction
    kernels consume; the tiling happens inside the native copy (free).
    """
    lib = _load()
    handle = lib.vdec_open(codec_id)
    if not handle:
        raise VideoDecodeError("failed to open native decoder")
    try:
        rc = lib.vdec_decode(handle, data, len(data))
        if rc != 0:
            raise VideoDecodeError(
                f"decode failed ({rc}): {lib.vdec_error(handle).decode()}"
            )
        frames: List[VideoFrame] = []
        n = lib.vdec_frame_count(handle)
        info = (ctypes.c_int * 6)()
        for i in range(n):
            lib.vdec_frame_info(handle, i, info)
            w, h, bit_depth, cws, chs = info[0], info[1], info[2], info[3], info[4]
            is_rgb = bool(info[5])
            dtype = np.uint16 if bit_depth > 8 else np.uint8
            planes = []
            for p in range(3):
                pw = w if p == 0 else w >> cws
                ph = h if p == 0 else h >> chs
                ptile = tile if p == 0 else tile >> cws
                if tile > 0 and pw % max(ptile, 1) == 0 and ph % max(ptile, 1) == 0:
                    nb = (ph // ptile) * (pw // ptile)
                    buf = np.empty((nb, ptile, ptile), dtype=dtype)
                    copied = lib.vdec_copy_plane_tiled(
                        handle, i, p, ptile,
                        buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes,
                    )
                else:
                    buf = np.empty((ph, pw), dtype=dtype)
                    copied = lib.vdec_copy_plane(
                        handle, i, p, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes
                    )
                if copied != buf.nbytes:
                    raise VideoDecodeError(f"plane copy failed: {copied}")
                planes.append(buf)
            frames.append(
                VideoFrame(
                    planes=planes,
                    bit_depth=bit_depth,
                    chroma_w_shift=cws,
                    chroma_h_shift=chs,
                    is_rgb=is_rgb,
                )
            )
        return frames
    finally:
        lib.vdec_close(handle)


def decoder_thread_info(codec_id: int = 1, threads: int = 0):
    """(resolved thread_count, active_thread_type bits) of a freshly
    opened decoder — 1 = frame threading, 2 = slice threading. Evidence
    that the host decode parallelizes on multi-core machines (this
    container has 1 core, so the auto-resolved count is 1 here; pass an
    explicit ``threads`` to assert the frame-threading request survives
    regardless of host core count)."""
    lib = _load()
    handle = lib.vdec_open_threads(codec_id, threads)
    if not handle:
        raise VideoDecodeError("failed to open native decoder")
    try:
        info = (ctypes.c_int * 2)()
        if lib.vdec_thread_info(handle, info) != 0:
            raise VideoDecodeError("thread info query failed")
        return int(info[0]), int(info[1])
    finally:
        lib.vdec_close(handle)


class VideoEncodeError(Exception):
    pass


def encode_yuv420(
    frames: List[List[np.ndarray]],
    bit_depth: int = 8,
    lossless: bool = True,
    gop: int = 32,
    qp: int = 20,
    chroma444: bool = False,
    chroma422: bool = False,
) -> bytes:
    """Encode YUV frames to an Annex-B HEVC bytestream via libx265.

    Each frame is [y, u, v] arrays: y is (h, w); u and v are (h//2, w//2)
    for 4:2:0 (the default), (h, w) with ``chroma444=True``, or
    (h, w//2) with ``chroma422=True``.
    dtype uint8 for 8-bit, uint16 (values < 1024) for 10-bit.
    """
    if not frames:
        raise VideoEncodeError("no frames")
    assert not (chroma444 and chroma422)
    lib = _load()
    h, w = frames[0][0].shape
    chroma_mode = 1 if chroma444 else 2 if chroma422 else 0
    handle = lib.venc_open(
        w, h, bit_depth, int(lossless), gop, qp, chroma_mode
    )
    if not handle:
        raise VideoEncodeError(
            f"libx265 unavailable for bit_depth={bit_depth} "
            f"chroma_mode={chroma_mode} (pixel format unsupported)"
        )
    try:
        dtype = np.uint16 if bit_depth > 8 else np.uint8
        for planes in frames:
            y, u, v = (np.ascontiguousarray(p, dtype=dtype) for p in planes)
            rc = lib.venc_encode_frame(
                handle,
                y.ctypes.data_as(ctypes.c_void_p),
                u.ctypes.data_as(ctypes.c_void_p),
                v.ctypes.data_as(ctypes.c_void_p),
            )
            if rc != 0:
                raise VideoEncodeError(
                    f"encode failed ({rc}): {lib.venc_error(handle).decode()}"
                )
        if lib.venc_flush(handle) != 0:
            raise VideoEncodeError("flush failed")
        size = lib.venc_output_size(handle)
        out = np.empty(size, dtype=np.uint8)
        lib.venc_copy_output(handle, out.ctypes.data_as(ctypes.c_void_p), size)
        return out.tobytes()
    finally:
        lib.venc_close(handle)


def encoder_supports(bit_depth: int) -> bool:
    """Whether libx265 in this environment can encode the bit depth."""
    lib = _load()
    handle = lib.venc_open(64, 64, bit_depth, 1, 32, 20, 0)
    if handle:
        lib.venc_close(handle)
        return True
    return False
