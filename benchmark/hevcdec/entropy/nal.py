"""NAL unit packaging and Annex-B byte-stream assembly.

Parity: reference NALwrite.cpp (emulation prevention) + AnnexBwrite.h
(start codes); reader side mirrors NALread.cpp/AnnexBread.cpp.
"""
from __future__ import annotations

from typing import List, Tuple


def rbsp_to_nal(rbsp: bytes, nal_type: int, temporal_id: int = 0,
                layer_id: int = 0) -> bytes:
    """Wrap an RBSP payload into a NAL unit: 2-byte header + emulation
    prevention (insert 0x03 after any 00 00 before 00/01/02/03)."""
    header = bytes([(nal_type << 1) | (layer_id >> 5),
                    ((layer_id & 31) << 3) | (temporal_id + 1)])
    out = bytearray(header)
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    # cabac_zero_word protection: trailing 00 00 would be ambiguous
    if zeros >= 2:
        out.append(3)
    return bytes(out)


def write_annexb(nals: List[bytes], first_in_au_flags: List[bool]) -> bytes:
    """Annex-B stream: 4-byte start code for first NAL of an access unit and
    parameter sets, 3-byte otherwise (matches the reference's writeAnnexB)."""
    out = bytearray()
    for nal, first in zip(nals, first_in_au_flags):
        out += b"\x00\x00\x00\x01" if first else b"\x00\x00\x01"
        out += nal
    return bytes(out)


def nal_to_rbsp(nal: bytes) -> Tuple[int, int, bytes]:
    """Strip the 2-byte header and emulation prevention bytes.
    Returns (nal_type, temporal_id, rbsp)."""
    nal_type = nal[0] >> 1
    temporal_id = (nal[1] & 7) - 1
    rbsp = bytearray()
    zeros = 0
    i = 2
    while i < len(nal):
        b = nal[i]
        if zeros >= 2 and b == 3:  # emulation_prevention_three_byte
            zeros = 0
            i += 1
            continue
        rbsp.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return nal_type, temporal_id, bytes(rbsp)


def split_annexb(stream: bytes) -> List[bytes]:
    """Split an Annex-B byte stream into NAL units (reference AnnexBread)."""
    nals = []
    i = 0
    n = len(stream)
    starts = []
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        end = starts[k + 1] - 3 if k + 1 < len(starts) else n
        # trim the leading zero of a 4-byte start code belonging to next NAL
        while end > s and stream[end - 1] == 0 and k + 1 < len(starts):
            end -= 1
        nals.append(stream[s:end])
    return nals


def escaped_sizes(rbsp: bytes, boundaries) -> list:
    """For WPP entry points: sizes (in NAL-payload bytes, i.e. WITH
    emulation-prevention bytes) of the regions between consecutive raw
    `boundaries` (byte positions within `rbsp`). The escaping state
    (zero-run) carries across regions exactly as rbsp_to_nal inserts it."""
    sizes = []
    zeros = 0
    esc = 0
    bi = 0
    marks = []
    for i, b in enumerate(rbsp):
        if bi < len(boundaries) and i == boundaries[bi]:
            marks.append(esc)
            bi += 1
        if zeros >= 2 and b <= 3:
            esc += 1
            zeros = 0
        esc += 1
        zeros = zeros + 1 if b == 0 else 0
    while bi < len(boundaries):
        marks.append(esc)
        bi += 1
    marks.append(esc)
    return [marks[i + 1] - marks[i] for i in range(len(marks) - 1)]
