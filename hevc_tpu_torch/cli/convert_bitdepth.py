"""YUV bit-depth conversion tool.

Parity: reference utils/convert_NtoMbit_YCbCr.cpp.

Usage: python -m hevc_tpu_torch.cli.convert_bitdepth in.yuv out.yuv W H IN_BD OUT_BD
"""
from __future__ import annotations

import sys

from ..core.types import ChromaFormat
from ..io.yuv import YuvReader, YuvWriter


def main(argv=None) -> int:
    a = argv if argv is not None else sys.argv[1:]
    if len(a) != 6:
        print(__doc__)
        return 1
    inp, outp, w, h, ibd, obd = a[0], a[1], int(a[2]), int(a[3]), \
        int(a[4]), int(a[5])
    rd = YuvReader(inp, w, h, ChromaFormat.C420, file_bit_depth=ibd,
                   internal_bit_depth=obd)
    wr = YuvWriter(outp, file_bit_depth=obd, internal_bit_depth=obd)
    n = 0
    while True:
        planes = rd.read()
        if planes is None:
            break
        wr.write(planes)
        n += 1
    wr.close()
    print(f"converted {n} frames {ibd}->{obd} bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
