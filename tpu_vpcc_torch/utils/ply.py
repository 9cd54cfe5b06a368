"""PLY output, byte-compatible with the reference writer
(``src/writer.rs:32-74``): ASCII format, uint xyz, optional uchar rgb,
``element face 0`` stanza. Body formatting is NumPy-bulk instead of a
per-point write loop.

Framework extension: ``binary_little_endian`` output (the reference
stubs binary formats out, ``src/writer.rs:10-11``) — ~5x smaller files
and near-memcpy write speed; positions are declared ``ushort`` there
(they are u16 values; the ASCII header keeps ``uint`` for reference
byte-parity)."""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np

from ..reconstruction.pointset import PointSet3

FORMAT_ASCII = "ascii"
FORMAT_BINARY = "binary_little_endian"

# FRAMEWORK EXTENSION: secondary-attribute channels append extra vertex
# properties (uchar for u8 values, ushort for u16) after the rgb triple;
# streams without them keep reference byte-parity.
_PLY_TYPE = {1: "uchar", 2: "ushort"}


def _extra_header_lines(ps: PointSet3) -> list:
    lines = []
    for names, vals in ps.extra_attrs:
        t = _PLY_TYPE[vals.dtype.itemsize]
        lines += [f"property {t} {name}" for name in names]
    return lines


def write_ply(ps: PointSet3, path, fmt: str = FORMAT_ASCII) -> None:
    path = Path(path)
    with open(path, "wb") as f:
        f.write(format_ply(ps, fmt))


def format_ply(ps: PointSet3, fmt: str = FORMAT_ASCII) -> bytes:
    if fmt == FORMAT_BINARY:
        return _format_ply_binary(ps)
    if fmt != FORMAT_ASCII:
        raise ValueError(f"unknown PLY format {fmt!r}")
    buf = io.BytesIO()
    n = ps.point_count
    header = ["ply", "format ascii 1.0", f"element vertex {n}",
              "property uint x", "property uint y", "property uint z"]
    if ps.with_colors:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += _extra_header_lines(ps)
    header += ["element face 0", "property list uint8 int32 vertex_index", "end_header"]
    buf.write(("\n".join(header) + "\n").encode())
    if n:
        body = None if ps.extra_attrs else _format_body_native(ps)
        if body is None:
            body = _format_body_numpy(ps)
        buf.write(body)
    return buf.getvalue()


def _format_ply_binary(ps: PointSet3) -> bytes:
    n = ps.point_count
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property ushort x", "property ushort y", "property ushort z"]
    if ps.with_colors:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += _extra_header_lines(ps)
    header += ["element face 0", "property list uint8 int32 vertex_index",
               "end_header"]
    buf = io.BytesIO()
    buf.write(("\n".join(header) + "\n").encode())
    if n:
        pos = np.ascontiguousarray(ps.positions, dtype="<u2")
        fields = [("xyz", "<u2", 3)]
        if ps.with_colors:
            fields.append(("rgb", "u1", 3))
        for i, (names, vals) in enumerate(ps.extra_attrs):
            dt = "u1" if vals.dtype.itemsize == 1 else "<u2"
            fields.append((f"x{i}", dt, vals.shape[1]))
        if len(fields) == 1:
            buf.write(pos.tobytes())
        else:
            rec = np.empty(n, dtype=fields)
            rec["xyz"] = pos
            if ps.with_colors:
                rec["rgb"] = ps.colors
            for i, (_names, vals) in enumerate(ps.extra_attrs):
                rec[f"x{i}"] = vals
            buf.write(rec.tobytes())
    return buf.getvalue()


def read_ply(data: bytes) -> PointSet3:
    """Parse both formats this module writes (testing / tooling aid).

    Extra vertex properties beyond xyz/rgb (secondary attributes) come
    back one per ``extra_attrs`` entry as ``((name,), (n, 1) array)`` —
    the per-attribute channel grouping the writer had is not recorded
    in the PLY header."""
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode().splitlines()
    body = data[end:]
    n = 0
    binary = False
    props = []  # (ply_type, name) of the vertex element
    in_vertex = False
    for line in header:
        if line.startswith("format binary_little_endian"):
            binary = True
        elif line.startswith("element vertex"):
            n = int(line.split()[-1])
            in_vertex = True
        elif line.startswith("element "):
            in_vertex = False
        elif in_vertex and line.startswith("property "):
            _, t, name = line.split()
            props.append((t, name))
    names = [name for _t, name in props]
    assert names[:3] == ["x", "y", "z"], names
    has_colors = names[3:6] == ["red", "green", "blue"]
    extra_props = props[6:] if has_colors else props[3:]
    ps = PointSet3(with_colors=has_colors)
    if n == 0:
        return ps
    np_type = {"uchar": "u1", "ushort": "<u2", "uint": "<u4"}
    if binary:
        fields = [("xyz", np_type[props[0][0]], 3)]
        if has_colors:
            fields.append(("rgb", "u1", 3))
        fields += [
            (f"e{i}", np_type[t], 1) for i, (t, _name) in enumerate(extra_props)
        ]
        rec = np.frombuffer(body, dtype=fields, count=n)
        ps.positions = rec["xyz"].astype(np.uint16)
        if has_colors:
            ps.colors = rec["rgb"].copy()
        for i, (_t, name) in enumerate(extra_props):
            ps.extra_attrs.append(((name,), rec[f"e{i}"].copy()))
    else:
        vals = np.loadtxt(io.BytesIO(body), dtype=np.int64, max_rows=n, ndmin=2)
        ps.positions = vals[:, :3].astype(np.uint16)
        col0 = 3
        if has_colors:
            ps.colors = vals[:, 3:6].astype(np.uint8)
            col0 = 6
        for i, (t, name) in enumerate(extra_props):
            dt = np.uint8 if t == "uchar" else np.uint16
            ps.extra_attrs.append(
                ((name,), vals[:, col0 + i : col0 + i + 1].astype(dt))
            )
    return ps


#: bound once; per-frame writes skip the ctypes setup. False where the
#: bridge cannot load, so that no frame tries to build it again
_ply_lib = None


def _format_body_native(ps: PointSet3):
    """Fast ASCII body via the native bridge (~90x np.savetxt)."""
    global _ply_lib
    import ctypes

    if _ply_lib is False:
        return None
    if _ply_lib is None:
        try:
            from ..video.codec import _load

            lib = _load()
            if not hasattr(lib, "ply_format_body"):
                _ply_lib = False
                return None
            lib.ply_format_body.restype = ctypes.c_int64
            lib.ply_format_body.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64,
            ]
            _ply_lib = lib
        except Exception:
            _ply_lib = False
            return None
    lib = _ply_lib
    n = ps.point_count
    positions = np.ascontiguousarray(ps.positions, dtype=np.uint16)
    colors = (
        np.ascontiguousarray(ps.colors, dtype=np.uint8) if ps.with_colors else None
    )
    out = np.empty(n * 30, dtype=np.uint8)
    written = lib.ply_format_body(
        positions.ctypes.data_as(ctypes.c_void_p),
        colors.ctypes.data_as(ctypes.c_void_p) if colors is not None else None,
        n,
        out.ctypes.data_as(ctypes.c_void_p),
        out.nbytes,
    )
    if written < 0:
        return None
    return out[:written].tobytes()


def _format_body_numpy(ps: PointSet3) -> bytes:
    parts = [ps.positions.astype(np.int64)]
    if ps.with_colors:
        parts.append(ps.colors.astype(np.int64))
    parts += [vals.astype(np.int64) for _names, vals in ps.extra_attrs]
    cols = np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
    buf = io.BytesIO()
    np.savetxt(buf, cols, fmt="%d", delimiter=" ", newline="\n")
    return buf.getvalue()


def frame_output_path(base, frame_num: int) -> Path:
    """Reference CLI naming: directory → NNNN.ply, else replace %4d
    (``src/bin/decoder.rs:101-109``)."""
    base = Path(base)
    if base.is_dir():
        return base / f"{frame_num:04d}.ply"
    return base.parent / base.name.replace("%4d", f"{frame_num:04d}")
