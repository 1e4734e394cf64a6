"""The stream's comparison: the coded bytes of a run decoded by the
benchmark's own decoder (`benchmark/hevcdec`, a frozen copy of the
port's), set against the program's reconstructions.

Every picture of the stream up to the last one sampled is parsed (CABAC,
syntax, motion). Two sets of pictures are reconstructed from the bytes:
the IDR, from nothing but the stream, and one GOP of the bits range
drawn from the seed, whose references are the program's own
reconstructions (the decoder cannot afford to rebuild every picture of
a run; the hash check covers the others). Each reconstructed picture is compared sample by sample with
the program's reconstruction and with the hash SEI the stream carries
for it. Pictures are matched by display index (`DecoderTop.index`), not
by POC: a stream with many IDRs, such as all-intra, restarts its POC at
each, and in a stream with one IDR the two are the same.

`drop_bits` > 0 runs the control: the same decoder keeping every sample,
its references' too, at that lower precision."""
from __future__ import annotations

import random

import numpy as np

from ..hevcdec.decoder.top import DecoderTop
from . import reference as ref


def sample_pocs(seed: int, first: int, pictures: int, gop: int) -> list:
    """The display indices of one GOP of the range [first, first +
    pictures), drawn from the seed."""
    n = max(1, pictures // gop)
    g = random.Random(seed * 1000003 + 41).randrange(n)
    start = first + g * gop
    return list(range(start, min(start + gop, first + pictures)))


class _Done(Exception):
    """Every picture wanted has been decoded and checked."""


class _Sampled(DecoderTop):
    """Reconstructs the pictures wanted, takes the others as given, keeps
    whether each reconstructed picture matched its hash SEI, outputs
    nothing, and stops once every picture wanted is checked."""

    def __init__(self, given: dict, want: list, drop_bits: int):
        super().__init__(collect_stats=True, given=given,
                         drop_bits=drop_bits)
        self.want = want
        self.decoded = {}
        self.hash_ok = {}
        self._last = None

    def _store(self, sh, recon):
        super()._store(sh, recon)
        self.out_buf.clear()
        self._last = self.index(sh)
        if self._last not in self.given:
            self.decoded[self._last] = recon

    def _check_hash(self, planes, digests, hash_type):
        ok = super()._check_hash(planes, digests, hash_type)
        if self._last in self.decoded:
            self.hash_ok[self._last] = ok
            if len(self.hash_ok) == len(self.want):
                raise _Done
        return ok


def check(data: bytes, recons: dict, src: dict, pocs: list,
          bit_depth: int, drop_bits: int = 0) -> dict:
    """Decode `data` (the whole stream from its parameter sets) up to the
    last picture wanted, every picture parsed, the first IDR and `pocs`
    (display indices, as every key here) reconstructed.

    Returns {"samples": samples that differ from the program's
    reconstruction (all of a picture that was not reconstructed),
    "hashes": reconstructed pictures whose hash SEI does not match them
    (or that have none), "notes", "pocs": the pictures reconstructed,
    "psnr": {display index: luma PSNR of the decoded picture against the
    source}, "shares": the reconstructed P/B pictures' skip and merge
    shares of their 4x4 blocks}."""
    want = sorted({0, *pocs})
    given = {i: p for i, p in recons.items() if i not in want}
    dec = _Sampled(given, want, drop_bits)
    notes = []
    try:
        for _ in dec.decode_stream(data):
            pass
    except _Done:
        pass
    except Exception as e:              # a stream that does not decode
        notes.append(f"the stream does not decode: {type(e).__name__}: "
                     f"{str(e)[:200]}")
    samples = hashes = 0
    psnr = {}
    for i in want:
        mine = recons.get(i)
        got = dec.decoded.get(i)
        if mine is None:
            notes.append(f"picture {i}: the program kept no reconstruction")
            samples += 1
            hashes += 1
            continue
        size = sum(np.asarray(p).size for p in mine)
        if got is None or len(got) != len(mine) or any(
                np.shape(a) != np.shape(b) for a, b in zip(got, mine)):
            notes.append(f"picture {i} was not decoded at its size")
            samples += size
            hashes += 1
            continue
        n = sum(int((np.asarray(a) != np.asarray(b)).sum())
                for a, b in zip(got, mine))
        if n:
            notes.append(f"picture {i}: {n} decoded samples differ from "
                         "the reconstruction")
        samples += n
        if not dec.hash_ok.get(i, False):
            notes.append(f"picture {i}: the decoded picture does not match "
                         "its hash SEI")
            hashes += 1
        if i in src:
            psnr[i] = ref.psnr_y(src[i][0], got[0], bit_depth)
    inter = [r for r in dec.stats if r["type"] != "I"]
    blocks = sum(r["intra4"] + r["inter4"] for r in inter)
    shares = ({"skip": sum(r["skip4"] for r in inter) / blocks,
               "merge": sum(r["merge4"] for r in inter) / blocks}
              if blocks else {})
    return {"samples": samples, "hashes": hashes, "notes": notes,
            "pocs": want, "psnr": psnr, "shares": shares}
