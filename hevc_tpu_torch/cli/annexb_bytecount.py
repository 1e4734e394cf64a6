"""Annex-B NAL byte statistics tool with built-in parser selftest.

Parity: reference utils/annexBbytecount.cpp (test-vector table :39-68,
selftest() :70 — run on every invocation, same policy here).

Usage: python -m hevc_tpu_torch.cli.annexb_bytecount stream.bin
"""
from __future__ import annotations

import sys

from ..entropy.nal import split_annexb

# (stream bytes, expected NAL payload sizes) — exercises 3/4-byte start
# codes, trailing zeros and degenerate prefixes.
SELFTEST_VECTORS = [
    (b"", []),
    (b"\x00\x00\x01\x26\x01\x02", [3]),
    (b"\x00\x00\x00\x01\x26\x01\x02", [3]),
    # payloads exclude bytes absorbed by the following start-code prefix
    # (trailing_zero_8bits are stripped, matching the reference AnnexBread)
    (b"\x00\x00\x01\x26\x01\x00\x00\x01\x48\x05", [2, 2]),
    (b"\x00\x00\x00\x01\x26\x01\x00\x00\x00\x01\x48\x05", [2, 2]),
    (b"\x00\x00\x01\x40\x01\x00\x00\x00\x01\x42\x01", [2, 2]),
]


def selftest() -> bool:
    for data, expect in SELFTEST_VECTORS:
        got = [len(n) for n in split_annexb(data)]
        if got != expect:
            print(f"selftest FAILED: {data!r}: got {got} expect {expect}")
            return False
    return True


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not selftest():
        return 2
    print("selftest passed")
    if not argv:
        return 0
    data = open(argv[0], "rb").read()
    nals = split_annexb(data)
    by_type = {}
    for n in nals:
        t = n[0] >> 1
        cnt, size = by_type.get(t, (0, 0))
        by_type[t] = (cnt + 1, size + len(n))
    print(f"{'type':>5} {'count':>7} {'bytes':>10}")
    for t in sorted(by_type):
        cnt, size = by_type[t]
        print(f"{t:>5} {cnt:>7} {size:>10}")
    print(f"total NAL units: {len(nals)}, payload bytes: "
          f"{sum(len(n) for n in nals)}, stream bytes: {len(data)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
