"""Bitrate targeting: hit a target bitrate by iterating encoder parameters.

Parity: reference utils/BitrateTargeting (ExtractBitrates parses encoder
logs; GuessLambdaModifiers iterates lambda-modifiers,
GuessLambdaModifiersMain.cpp:46). This framework's equivalent iterates QP
with secant steps over real encodes of the given clip. The encodes run on
the card unless ``main(..., device="cpu")`` asks for the CPU.

Usage: python -m hevc_tpu_torch.cli.bitrate_targeting -i in.yuv -wdt W -hgt H \
           -f N --TargetKbps 500 [--FrameRate 30] [extra encoder args...]
"""
from __future__ import annotations

import os
import sys
import tempfile

from .encode import main as encode_main


def measure(args, qp: int, tmp: str, device="cuda") -> float:
    bs = os.path.join(tmp, f"q{qp}.bin")
    encode_main(args + ["-q", str(qp), "-b", bs], device=device)
    return os.path.getsize(bs) * 8


def main(argv=None, device="cuda") -> int:
    a = list(argv if argv is not None else sys.argv[1:])
    target_kbps = None
    fr = 30.0
    frames = None
    rest = []
    i = 0
    while i < len(a):
        if a[i] == "--TargetKbps":
            target_kbps = float(a[i + 1]); i += 2
        elif a[i] in ("-fr", "--FrameRate"):
            fr = float(a[i + 1]); rest += a[i:i + 2]; i += 2
        elif a[i] == "-f":
            frames = int(a[i + 1]); rest += a[i:i + 2]; i += 2
        else:
            rest.append(a[i]); i += 1
    assert target_kbps and frames, "--TargetKbps and -f required"
    target_bits = target_kbps * 1000.0 * frames / fr
    with tempfile.TemporaryDirectory() as tmp:
        lo, hi = 0, 51
        best = None
        for _ in range(7):  # bisection on monotone rate(QP)
            qp = (lo + hi) // 2
            bits = measure(rest, qp, tmp, device)
            err = bits / target_bits
            print(f"QP {qp}: {bits / 1000 * fr / frames:.1f} kbps "
                  f"(x{err:.3f} of target)")
            if best is None or abs(err - 1) < abs(best[1] - 1):
                best = (qp, err)
            if bits > target_bits:
                lo = qp + 1
            else:
                hi = qp - 1
            if lo > hi:
                break
        print(f"best QP {best[0]} at {best[1]:.3f}x target")
    return 0


if __name__ == "__main__":
    sys.exit(main())
