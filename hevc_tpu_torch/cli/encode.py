"""Encoder CLI — reads the reference's cfg format.

Counterpart of hevc_tpu/cli/encode.py (reference TAppEncoder, encmain.cpp:53,
TAppEncTop frame loop). The device work runs on the card unless
``main(..., device="cpu")`` asks for the CPU.
Usage:  python -m hevc_tpu_torch.cli.encode -c cfg/encoder_intra_main.cfg \
            -i in.yuv -wdt 416 -hgt 240 -f 8 -b out.bin -o rec.yuv
"""
from __future__ import annotations

import sys
import time

from ..core.types import ChromaFormat
from ..encoder.top import EncoderTop
from ..io.cfg import parse_cli
from ..io.yuv import YuvReader, YuvWriter


def _weave(fields, top_first: int):
    """Interleave two decoded fields into one frame (the reference
    decoder app reinterleaves field_seq streams the same way)."""
    import numpy as np
    first, second = fields if top_first else fields[::-1]
    out = []
    for t, b in zip(first, second):
        f = np.zeros((t.shape[0] * 2, t.shape[1]), t.dtype)
        f[0::2] = t
        f[1::2] = b
        out.append(f)
    return out


def main(argv=None, device="cuda") -> int:
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    assert cfg.input_file and cfg.width and cfg.height, \
        "InputFile/SourceWidth/SourceHeight required"
    from ..io.cfg import ConfigError, validate
    try:
        validate(cfg)
    except ConfigError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 2
    rd = YuvReader(cfg.input_file, cfg.width, cfg.height,
                   ChromaFormat(cfg.internal_chroma_format),
                   file_bit_depth=cfg.input_bit_depth,
                   internal_bit_depth=cfg.internal_bit_depth)
    if cfg.frame_skip:
        rd.skip(cfg.frame_skip)
    wr = YuvWriter(cfg.recon_file,
                   cfg.output_bit_depth or cfg.internal_bit_depth,
                   cfg.internal_bit_depth) if cfg.recon_file else None
    if cfg.field_coding:
        # each frame is coded as two field pictures of half height
        # (reference TAppEncTop / TVideoIOYuv field path)
        cfg.height //= 2
    enc = EncoderTop(cfg, device=device)
    enc.warm_device_programs()
    n = cfg.frames_to_encode or rd.num_frames
    t0 = time.time()
    printed = 0

    pending_field = []

    def report():
        nonlocal printed
        while printed < len(enc.stats):
            s = enc.stats[printed]
            print(f"POC {s['poc']:4d} ( {s.get('type', 'I')}-SLICE, "
                  f"QP {s.get('qp', cfg.qp)} ) "
                  f"{s['bits']:10d} bits [Y {s['psnr'][0]:.4f} dB  "
                  f"U {s['psnr'][1]:.4f} dB  V {s['psnr'][2]:.4f} dB] "
                  f"[MD5 {s['md5']}]")
            printed += 1
        if wr is not None:
            for _, planes_out in enc.pop_recons():
                if cfg.field_coding:
                    pending_field.append(planes_out)
                    if len(pending_field) == 2:
                        wr.write(_weave(pending_field, cfg.top_field_first))
                        pending_field.clear()
                else:
                    wr.write(planes_out)

    with open(cfg.bitstream_file, "wb") as out:
        # lookahead pipeline: upcoming frames' device work (intra
        # prescreen / integer ME against the final references) is
        # dispatched ahead and computes under the current frame's host
        # work. All-intra frames are device-independent, so each is
        # prescreened as it is read, three ahead of the one being coded,
        # and its screen waits under its display index until
        # encode_frame codes it (a frame read with none waiting is
        # screened synchronously); inter stays at one frame (ME needs the
        # previous frame's final references).
        from collections import deque
        deep = cfg.intra_period == 1 and not cfg.field_coding
        look = 3 if deep else 1
        buf = deque()
        nread = 0

        def pull():
            nonlocal nread
            if nread < n:
                p = rd.read()
                nread += 1
                if p is not None:
                    if deep:
                        enc.prefetch_frame(p, picture=nread - 1)
                    buf.append(p)

        for _ in range(1 + look):
            pull()
        i = 0
        while buf and i < n:
            planes = buf.popleft()
            pull()
            if not deep and not cfg.field_coding and buf:
                # inter: the ME prefetch plans exactly ONE submission
                # ahead (next frame's planes paired with next frame's
                # reference plan) — prefetch the immediate next only
                enc.prefetch_frame(buf[0])
            if cfg.field_coding:
                first, second = (0, 1) if cfg.top_field_first else (1, 0)
                out.write(enc.encode_frame([pl[first::2] for pl in planes]))
                report()
                out.write(enc.encode_frame([pl[second::2] for pl in planes]))
            else:
                out.write(enc.encode_frame(planes))
            report()
            i += 1
        out.write(enc.flush())
        report()
    dt = time.time() - t0
    done = len(enc.stats)
    # sequence summary (reference TEncAnalyze::printOut, TEncAnalyze.h:139)
    fr = cfg.frame_rate or 30
    def _summary(rows, label):
        if not rows:
            return
        bits = sum(r["bits"] for r in rows)
        kbps = bits / len(rows) * fr / 1000.0
        ys = sum(r["psnr"][0] for r in rows) / len(rows)
        us = sum(r["psnr"][1] for r in rows) / len(rows)
        vs = sum(r["psnr"][2] for r in rows) / len(rows)
        print(f"{label:>12} {len(rows):>6} a {kbps:12.4f} {ys:8.4f} "
              f"{us:8.4f} {vs:8.4f}")
    print("\nSUMMARY --------------------------------------------------------")
    print(f"{'':>12} {'Frames':>6}   {'Bitrate kbps':>12} {'Y-PSNR':>8} "
          f"{'U-PSNR':>8} {'V-PSNR':>8}")
    _summary(enc.stats, "Total")
    for st in ("I", "P", "B"):
        _summary([r for r in enc.stats if r.get("type") == st],
                 f"{st}-Slices")
    print(f"\nencoded {done} frames in {dt:.2f}s ({done / dt:.3f} fps)")
    if wr:
        wr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
