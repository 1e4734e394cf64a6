"""RBSP bit writer with Exp-Golomb coding (for parameter sets / headers).

Parity: reference TComBitStream.{h,cpp} (TComOutputBitstream) and
SyntaxElementWriter — headers are written once per frame so Python is the
right altitude; only slice data is native.
"""
from __future__ import annotations


class BitWriter:
    def __init__(self):
        self._bytes = bytearray()
        self._held = 0
        self._nbits = 0

    def u(self, value: int, bits: int) -> None:
        """Fixed-length unsigned (f(n)/u(n))."""
        for i in range(bits - 1, -1, -1):
            self._held = (self._held << 1) | ((value >> i) & 1)
            self._nbits += 1
            if self._nbits == 8:
                self._bytes.append(self._held)
                self._held = 0
                self._nbits = 0

    def ue(self, value: int) -> None:
        """Unsigned Exp-Golomb (ue(v))."""
        assert value >= 0
        code = value + 1
        length = code.bit_length()
        self.u(0, length - 1)
        self.u(code, length)

    def se(self, value: int) -> None:
        """Signed Exp-Golomb (se(v)): v -> 2|v| - (v>0)."""
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def flag(self, b) -> None:
        self.u(1 if b else 0, 1)

    def byte_align(self) -> None:
        """rbsp_trailing_bits: stop bit + zero alignment."""
        self.u(1, 1)
        while self._nbits:
            self.u(0, 1)

    def align_zero(self) -> None:
        while self._nbits:
            self.u(0, 1)

    @property
    def bit_count(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def bytes(self) -> bytes:
        assert self._nbits == 0, "unaligned RBSP"
        return bytes(self._bytes)
