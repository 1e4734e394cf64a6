"""RBSP bit reader with Exp-Golomb (header parsing).

Parity: reference TComBitStream (TComInputBitstream) + SyntaxElementParser /
TDecCAVLC.cpp — decoder-side mirror of entropy/bitwriter.py.
"""
from __future__ import annotations


class BitReader:
    def __init__(self, data: bytes):
        self._d = data
        self._pos = 0  # bit position

    def u(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            byte = self._d[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 40:
                raise ValueError("invalid exp-golomb code")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def flag(self) -> int:
        return self.u(1)

    def byte_align(self) -> None:
        while self._pos & 7:
            self._pos += 1

    @property
    def byte_pos(self) -> int:
        return (self._pos + 7) >> 3
