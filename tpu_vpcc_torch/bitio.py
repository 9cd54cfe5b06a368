"""Bit-level IO for V3C/V-PCC bitstreams.

Host-side bit cursor with MSB-first semantics, 0th-order Exp-Golomb
(uvlc/svlc) codes, and the TMC2 ``byte_align`` quirk (a single bit is
consumed *before* aligning — see reference ``src/bitstream.rs:112-119``).

Parity reference: ``tmc2-rs src/bitstream.rs`` (C1 in SURVEY.md §2).
Unlike the reference's bit-by-bit loop (``src/bitstream.rs:143-151``) the
multi-bit read here is a constant number of Python int ops, which keeps the
cold parse path fast enough that no native extension is needed for it.
"""

from __future__ import annotations


class BitstreamError(Exception):
    """Raised on out-of-bounds reads or malformed data."""


class Bitstream:
    """MSB-first bit cursor over an immutable byte buffer.

    The cursor is (byte, bit) with ``bit`` in [0, 8); bit 0 is the MSB of
    the current byte, mirroring ``tmc2-rs`` ``Position`` semantics.
    """

    __slots__ = ("data", "byte_pos", "bit_pos")

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.byte_pos = 0
        self.bit_pos = 0

    @classmethod
    def from_file(cls, path) -> "Bitstream":
        with open(path, "rb") as f:
            return cls(f.read())

    # -- position ---------------------------------------------------------

    def reset(self) -> None:
        self.byte_pos = 0
        self.bit_pos = 0

    def tell(self):
        return (self.byte_pos, self.bit_pos)

    def seek(self, pos) -> None:
        self.byte_pos, self.bit_pos = pos

    @property
    def size(self) -> int:
        return len(self.data)

    def more_data(self) -> bool:
        """True while the byte cursor has not reached the end.

        Matches ``Bitstream::more_data`` (reference ``src/bitstream.rs:96``):
        compares the *byte* position only.
        """
        return self.byte_pos < len(self.data)

    def is_byte_aligned(self) -> bool:
        return self.bit_pos == 0

    def move_to_next_byte(self) -> None:
        self.byte_pos += 1
        self.bit_pos = 0

    # -- reads ------------------------------------------------------------

    def read(self, bits: int) -> int:
        """Read ``bits`` (<= 32) MSB-first and advance the cursor.

        Parity: ``Bitstream::read`` (``src/bitstream.rs:136-153``), without
        the per-bit loop: the value is extracted with one slice + shift.
        """
        if bits > 32:
            raise BitstreamError("Bitstream.read: bits > 32")
        if bits == 0:
            return 0
        start = self.byte_pos * 8 + self.bit_pos
        end = start + bits
        if end > len(self.data) * 8:
            raise BitstreamError(
                f"read past end: want {bits} bits at byte {self.byte_pos}.{self.bit_pos}, "
                f"size {len(self.data)}"
            )
        first_byte = start >> 3
        last_byte = (end + 7) >> 3
        window = int.from_bytes(self.data[first_byte:last_byte], "big")
        shift = last_byte * 8 - end
        val = (window >> shift) & ((1 << bits) - 1)
        self.byte_pos = end >> 3
        self.bit_pos = end & 7
        return val

    def peek(self, bits: int) -> int:
        pos = self.tell()
        val = self.read(bits)
        self.seek(pos)
        return val

    def read_slice(self, size: int) -> bytes:
        """Byte-aligned raw byte read (``src/bitstream.rs:163-167``)."""
        start = self.byte_pos
        if start + size > len(self.data):
            raise BitstreamError("read_slice past end")
        self.byte_pos += size
        return self.data[start : start + size]

    def read_uvlc(self) -> int:
        """0th-order Exp-Golomb unsigned (``src/bitstream.rs:170-179``)."""
        leading_zeros = 0
        while self.read(1) == 0:
            leading_zeros += 1
        if leading_zeros == 0:
            return 0
        return (1 << leading_zeros) - 1 + self.read(leading_zeros)

    def read_svlc(self) -> int:
        """Signed Exp-Golomb mapping (``src/bitstream.rs:182-189``)."""
        x = self.read_uvlc()
        if x & 1:
            return (x >> 1) + 1
        return -(x >> 1)

    def byte_align(self) -> None:
        """TMC2 byte-alignment quirk.

        Reads ONE bit first (the rbsp stop bit in TMC2's framing), then
        skips to the next byte boundary if not already aligned. Replicates
        ``src/bitstream.rs:112-119`` exactly — do not "fix" this.
        """
        self.read(1)
        if not self.is_byte_aligned():
            self.bit_pos = 0
            self.byte_pos += 1


class BitWriter:
    """MSB-first bit writer — the exact inverse of :class:`Bitstream`.

    Not present in the reference (it is decode-only); used here to author
    V3C test fixtures and as a standalone capability of the framework.
    """

    __slots__ = ("_buf", "_bit_pos")

    def __init__(self):
        self._buf = bytearray()
        self._bit_pos = 0  # bits used in the last byte, 0 => aligned

    def write(self, value: int, bits: int) -> None:
        if bits < 0 or value < 0 or value >= (1 << bits):
            raise BitstreamError(f"value {value} does not fit in {bits} bits")
        while bits > 0:
            if self._bit_pos == 0:
                self._buf.append(0)
            free = 8 - self._bit_pos
            take = min(free, bits)
            chunk = (value >> (bits - take)) & ((1 << take) - 1)
            self._buf[-1] |= chunk << (free - take)
            self._bit_pos = (self._bit_pos + take) & 7
            bits -= take

    def write_uvlc(self, value: int) -> None:
        if value < 0:
            raise BitstreamError("uvlc value must be >= 0")
        code = value + 1
        n = code.bit_length()
        self.write(0, n - 1)
        self.write(code, n)

    def write_svlc(self, value: int) -> None:
        # inverse of read_svlc: positive v -> 2v-1, non-positive v -> -2v
        self.write_uvlc(2 * value - 1 if value > 0 else -2 * value)

    def write_bytes(self, data: bytes) -> None:
        if self._bit_pos != 0:
            raise BitstreamError("write_bytes requires byte alignment")
        self._buf.extend(data)

    def byte_align(self) -> None:
        """Inverse of the TMC2 ``byte_align`` quirk: emit a 1 stop bit then
        zero-pad to the byte boundary (the reader consumes one bit and then
        aligns, so any padding works; a '1' marker matches rbsp trailing)."""
        self.write(1, 1)
        if self._bit_pos != 0:
            self.write(0, 8 - self._bit_pos)

    def is_byte_aligned(self) -> bool:
        return self._bit_pos == 0

    def pad_to_byte(self) -> None:
        """Zero-pad to the next byte boundary (no stop bit — cf.
        ``byte_align``, whose leading 1 bit mirrors the TMC2 quirk)."""
        if self._bit_pos != 0:
            self.write(0, 8 - self._bit_pos)

    def getvalue(self) -> bytes:
        return bytes(self._buf)

    def __len__(self) -> int:
        return len(self._buf)
