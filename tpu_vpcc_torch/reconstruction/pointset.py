"""Point cloud containers (parity: ``src/codec.rs:20-138``).

NumPy-array-of-structs layout instead of the reference's Vec<Vector3>:
positions are a single ``(n, 3) uint16`` array, colors ``(n, 3) uint8``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class PointSet3:
    """One reconstructed point-cloud frame."""

    positions: np.ndarray = field(
        default_factory=lambda: np.empty((0, 3), dtype=np.uint16)
    )
    colors: np.ndarray = field(default_factory=lambda: np.empty((0, 3), dtype=np.uint8))
    colors16bit: np.ndarray = field(
        default_factory=lambda: np.empty((0, 3), dtype=np.uint16)
    )
    with_colors: bool = False
    # FRAMEWORK EXTENSION: secondary-attribute channels (the reference
    # only ever carries one color triple). Each entry is
    # ``(property_names, values)`` with values ``(n, len(names))`` u8
    # or u16 — the PLY writer emits them as extra vertex properties.
    extra_attrs: List[tuple] = field(default_factory=list)

    def __len__(self) -> int:
        return int(self.positions.shape[0])

    @property
    def point_count(self) -> int:
        return int(self.positions.shape[0])

    def convert_yuv16_to_rgb8(self) -> None:
        """YUV 10-bit → RGB 8-bit, BT.709, f64 with floor+clamp.

        Vectorized but operation-for-operation identical (IEEE f64) to the
        reference scalar loop (``src/codec.rs:661-687``): offsets 512,
        scale 1023, coefficient order preserved.
        """
        assert self.with_colors
        self.colors = convert_yuv10_to_rgb8(self.colors16bit)

    def copy_rgb16_to_rgb8(self) -> None:
        """``src/codec.rs:96-106`` (u8 truncation semantics)."""
        assert self.with_colors
        self.colors = (self.colors16bit & 0xFF).astype(np.uint8)

    @classmethod
    def concatenate(cls, parts: List["PointSet3"]) -> "PointSet3":
        if not parts:
            return cls()
        extra: List[tuple] = []
        if any(p.extra_attrs for p in parts):
            schema = [names for names, _ in parts[0].extra_attrs]
            if any(
                [n for n, _ in p.extra_attrs] != schema for p in parts
            ):
                raise ValueError(
                    "cannot concatenate point sets with differing "
                    "extra-attribute schemas"
                )
            extra = [
                (names, np.concatenate(
                    [p.extra_attrs[i][1] for p in parts]
                ))
                for i, (names, _) in enumerate(parts[0].extra_attrs)
            ]
        return cls(
            positions=np.concatenate([p.positions for p in parts]),
            colors=np.concatenate([p.colors for p in parts]),
            colors16bit=np.concatenate([p.colors16bit for p in parts]),
            with_colors=any(p.with_colors for p in parts),
            extra_attrs=extra,
        )


def convert_yuv10_to_rgb8(colors16: np.ndarray) -> np.ndarray:
    """BT.709 10-bit YUV → 8-bit RGB (``src/codec.rs:661-687``).

    Must stay in IEEE f64 with the exact expression shapes of the
    reference: r = y + 1.57480*(v-512); g = y - 0.18733*(u-512) -
    (0.46813*(v-512)); b = y + 1.85563*(u-512); out = clamp(floor(c/1023*255)).
    """
    y = colors16[:, 0].astype(np.float64)
    u = colors16[:, 1].astype(np.float64)
    v = colors16[:, 2].astype(np.float64)
    offset = 512.0
    scale = 1023.0
    r = y + 1.57480 * (v - offset)
    g = y - 0.18733 * (u - offset) - (0.46813 * (v - offset))
    b = y + 1.85563 * (u - offset)
    out = np.empty((colors16.shape[0], 3), dtype=np.uint8)
    for i, c in enumerate((r, g, b)):
        c = np.floor(c / scale * 255.0)
        out[:, i] = np.clip(c, 0.0, 255.0).astype(np.uint8)
    return out
