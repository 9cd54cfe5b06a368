"""What decides ``correct``: every frame the consumer received, held to
the reference's frame for the same pool position.

A frame's digest is its point count and the CRC-32s of its positions
((n, 3) uint16) and its colours ((n, 3) uint8) as bytes: equal digests
mean equal count, positions, colours and order, up to a CRC collision
(a wrong frame passes with odds of about 2**-32). The consumer's
checker thread digests each frame as it arrives, so the run need not
hold the frames; the reference's frames are digested the same way once
the window has closed.
"""

from __future__ import annotations

import queue
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

Digest = Tuple[int, int, int]
#: the digest of a frame whose arrays are not of the stated types
BAD = (-1, 0, 0)


def digest(positions, colours) -> Digest:
    """(count, crc of positions, crc of colours); :data:`BAD` unless the
    positions are (n, 3) uint16 and the colours (n, 3) uint8."""
    if (positions.dtype != np.uint16 or colours.dtype != np.uint8
            or positions.ndim != 2 or positions.shape[1:] != (3,)
            or colours.shape != positions.shape):
        return BAD
    p = np.ascontiguousarray(positions)
    c = np.ascontiguousarray(colours)
    return (int(p.shape[0]), zlib.crc32(p), zlib.crc32(c))


class Checker:
    """Digests received frames on a thread of its own (zlib releases the
    interpreter lock), keyed by the order they arrived in."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self.digests: Dict[int, Digest] = {}
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def put(self, index: int, frame) -> None:
        self._q.put((index, frame))

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            i, ps = item
            self.digests[i] = digest(ps.positions, ps.colors)

    def close(self, timeout: float = 600.0) -> None:
        self._q.put(None)
        self._t.join(timeout)
        if self._t.is_alive():
            raise RuntimeError("the checker thread did not finish")


def compare(received: Dict[int, Digest], expected: List[Optional[Digest]]
            ) -> Tuple[int, int]:
    """``(wrong, missing)``: ``expected[i]`` is the reference's digest of
    received frame i (None where the frame is not judged). A frame
    that never came is missing; one that came and differs is wrong."""
    wrong = missing = 0
    for i, want in enumerate(expected):
        if want is None:
            continue
        got = received.get(i)
        if got is None:
            missing += 1
        elif got != want:
            wrong += 1
    return wrong, missing
