"""Decoder CLI. Parity: reference TAppDecoder (decmain.cpp, TAppDecTop);
with -stats it is the analyser build (the reference repo's NetBeans
"Analyser" configuration / TAppDecAnalyser), printing per-picture CU-mode
shares, depth histograms, MV activity and coefficient counts.

Usage: python -m hevc_tpu_torch.cli.decode -b in.bin [-o out.yuv] [-stats]
"""
from __future__ import annotations

import sys
import time

from ..decoder.top import DecoderTop
from ..io.yuv import YuvWriter


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    bs, out, stats = None, None, False
    i = 0
    while i < len(argv):
        if argv[i] == "-b":
            bs = argv[i + 1]; i += 2
        elif argv[i] == "-o":
            out = argv[i + 1]; i += 2
        elif argv[i] == "-stats":
            stats = True; i += 1
        else:
            raise ValueError(f"unknown arg {argv[i]}")
    assert bs, "-b bitstream required"
    dec = DecoderTop(collect_stats=stats)
    wr = None
    t0 = time.time()
    n = 0
    pend = []
    for frame in dec.decode_stream(open(bs, "rb").read()):
        status = dec.hash_status[n] if n < len(dec.hash_status) else "-"
        print(f"POC {n:4d} decoded [hash {status}]")
        if out and wr is None:
            bd = dec.sps.bit_depth_luma
            wr = YuvWriter(out, file_bit_depth=bd, internal_bit_depth=bd)
        if wr:
            if getattr(dec.sps, "vui_field_seq_flag", 0):
                # reinterleave field pairs into frames on output, like
                # the reference decoder app does for field_seq streams;
                # pic_timing pic_struct (1 top / 2 bottom) fixes parity
                pend.append(frame)
                if len(pend) == 2:
                    import numpy as np
                    first_top = True
                    if len(dec.pic_structs) >= n + 1:
                        first_top = dec.pic_structs[n - 1] != 2
                    top, bot = pend if first_top else pend[::-1]
                    woven = []
                    for t, b in zip(top, bot):
                        f = np.zeros((t.shape[0] * 2, t.shape[1]), t.dtype)
                        f[0::2] = t
                        f[1::2] = b
                        woven.append(f)
                    wr.write(woven)
                    pend.clear()
            else:
                wr.write(frame)
        n += 1
    dt = time.time() - t0
    if stats:
        print(f"{'poc':>4} {'typ':>3} {'qp':>3} {'bytes':>7} "
              f"{'skip%':>6} {'merge%':>6} {'intra%':>6} {'bi%':>4} "
              f"{'depths(64/32/16/8)':>20} {'avgMV':>6} {'coefY':>6}")
        for r in dec.stats:
            tot = max(1, r["skip4"] + r["merge4"] + r["intra4"]
                      + r["inter4"] - r["skip4"] - r["merge4"])
            n4 = max(1, r["intra4"] + r["inter4"])
            dh = "/".join(str(x * 100 // sum(r["depth_hist"]) if
                               sum(r["depth_hist"]) else 0)
                          for x in r["depth_hist"])
            amv = (r["abs_mv_sum"] / 4.0 / max(1, r["mv_blocks"]))
            print(f"{r['poc']:>4} {r['type'][:1]:>3} {r['qp']:>3} "
                  f"{r['slice_bytes']:>7} "
                  f"{100 * r['skip4'] // n4:>5}% "
                  f"{100 * r['merge4'] // n4:>5}% "
                  f"{100 * r['intra4'] // n4:>5}% "
                  f"{100 * r.get('bi4', 0) // n4:>3}% {dh:>20} "
                  f"{amv:>6.1f} {r['coeff_y']:>6}")
        # per-syntax-element bit breakdown (reference
        # TComCodingStatistics / RExt__DECODER_DEBUG_BIT_STATISTICS)
        from ..entropy.cabac import SYNTAX_STAT_NAMES
        total = int(dec.syntax_bits.sum())
        if total:
            print(f"\n{'syntax element':<22} {'bits':>10} {'%':>6}")
            order = sorted(range(len(SYNTAX_STAT_NAMES)),
                           key=lambda i: -int(dec.syntax_bits[i]))
            for i in order:
                b = int(dec.syntax_bits[i])
                if b:
                    print(f"{SYNTAX_STAT_NAMES[i]:<22} {b:>10} "
                          f"{100.0 * b / total:>5.1f}%")
            print(f"{'total (slice data)':<22} {total:>10}")
        # ---- stream-level reconciliation (reference TComCodingStatistics
        # NAL_UNIT_* rows): NAL bytes by type + start codes must cover the
        # file; CABAC category bits + slice headers cover the VCL bytes
        # up to emulation prevention and byte-alignment padding ----
        fsize = len(open(bs, "rb").read())
        nal_total = sum(dec.nal_bytes.values())
        sc = fsize - nal_total
        names = {32: "VPS", 33: "SPS", 34: "PPS", 39: "SEI(prefix)",
                 40: "SEI(suffix)", 35: "AUD"}
        print(f"\n{'NAL bytes by type':<22} {'bytes':>10}")
        vcl = 0
        for t in sorted(dec.nal_bytes):
            nm = names.get(t, f"VCL({t})" if t <= 21 else f"type{t}")
            if t <= 21:
                vcl += dec.nal_bytes[t]
            print(f"{nm:<22} {dec.nal_bytes[t]:>10}")
        print(f"{'start codes':<22} {sc:>10}")
        print(f"{'file total':<22} {fsize:>10}  (accounted "
              f"{nal_total + sc})")
        slack = vcl * 8 - int(dec.syntax_bits.sum()) \
            - dec.slice_header_bits
        print(f"VCL {vcl * 8} bits = slice headers "
              f"{dec.slice_header_bits} + slice data "
              f"{int(dec.syntax_bits.sum())} + "
              f"{slack} (NAL hdr/alignment/emulation/terminate)")
    bad = sum(1 for s in dec.hash_status if s != "OK")
    print(f"decoded {n} frames in {dt:.2f}s; hash failures: {bad}")
    if wr:
        wr.close()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
