"""The comparison that decides `correct`, and the end-to-end metrics that
the benchmark takes itself (from its clock, the bytes it got back and the
pictures it made).

Every number compared is a count of disagreements with the plain
reference, and each has the limit 0:
  hash_mismatch    coded pictures of the window and of the bits range
                   whose hash SEI does not match the program's
                   reconstruction (or that have none, or that no unit
                   carries), and decoded pictures (below) whose hash SEI
                   does not match the benchmark's decode;
  decode_mismatch  samples in which the benchmark's own decode of the
                   stream (`decode.py`: the IDR, and one GOP of the bits
                   range drawn from the seed) differs from the program's
                   reconstruction;
  search_mismatch  motion-vector entries of the sampled searches that
                   differ from the reference's, and reference planes
                   whose padding differs from an edge extension; in a
                   configuration with searches, a run whose window
                   checked none counts one;
  screen_mismatch  candidate modes and best costs of the prescreens
                   (every one of set-up: the warm-up's mid-level plane,
                   the IDR's and the warm-up pictures'; six sampled
                   from the window's, as the searches are) that differ;
                   a run that checked none counts one.
A search or prescreen whose source picture is none of the pictures the
benchmark made counts one as well."""
from __future__ import annotations

import hashlib
import statistics

import numpy as np

from . import decode
from . import reference as ref

LIMITS = {"hash_mismatch": 0, "decode_mismatch": 0, "search_mismatch": 0,
          "screen_mismatch": 0}


def _key(plane) -> bytes:
    return hashlib.md5(np.ascontiguousarray(plane, np.int16)).digest()


def evaluate(s, drop_bits: int = 0) -> dict:
    """The compared numbers of a finished run; `drop_bits` > 0 puts the
    reference at that lower sample precision in the program's place
    (the control): the decoder, the search and the prescreen."""
    bd = s.bit_depth
    by_src = {_key(p[0]): i for i, p in s.src.items()}
    coded = {i: s.recons[i] for i in s.coded}
    bad_hash, s.bits = ref.check_stream(s.data, coded, bd)
    pocs = decode.sample_pocs(s.seed, s.range[0], len(s.range), s.gop)
    s.decode = decode.check(s.head + s.data, s.recons, s.src, pocs, bd,
                            drop_bits)
    notes = list(s.decode["notes"])
    bad_search = 0
    checked = 0
    for rec in s.capture.searches:
        weighted = rec["wp"] is not None and any(
            t is not None for t in rec["wp"])
        if rec["grids"] is None or weighted:
            continue
        checked += 1
        idx = by_src.get(_key(rec["orig"]))
        if idx is None:
            bad_search += 1
            notes.append("a search's source is none of the pictures made")
            continue
        orig = s.src[idx][0]
        pad = rec["pad"]
        h, w = orig.shape
        for refp, got in zip(rec["refs"], rec["grids"]):
            mine = ref.pad_edge(refp[pad:pad + h, pad:pad + w], pad)
            if not np.array_equal(mine, refp):
                bad_search += 1
                notes.append(f"picture {idx}: a reference's padding differs")
            want = ref.search_grids(
                orig, mine, size=rec["size"], size2=rec["size2"],
                r=rec["r"], lam_fp=rec["lam_fp"], pad=pad,
                depth=rec["depth"], device=s.device, drop_bits=drop_bits)
            for k, (g, wgt) in enumerate(zip(got, want)):
                n = wgt.size if g is None else int((np.asarray(g) != wgt)
                                                   .sum())
                if n:
                    notes.append(f"picture {idx}: {n} entries of search "
                                 f"grid {k} differ")
                bad_search += n
    if checked == 0 and s.conf["searches"]:
        bad_search += 1
        notes.append("no search was checked")

    bad_screen = 0
    screened = 0
    for rec in s.capture.screens:
        if rec["out"] is None:
            continue
        screened += 1
        orig = rec["orig"]
        idx = by_src.get(_key(orig))
        if idx is not None:
            orig = s.src[idx][0]
        elif not (orig == (1 << (rec["bit_depth"] - 1))).all():
            bad_screen += 1
            notes.append("a prescreen's source is none of the pictures made")
            continue
        want = ref.screen(orig, rec["bit_depth"], rec["sqrt_lam"],
                          s.device, rec["log2s"], drop_bits)
        for log2, (cands, costs) in want.items():
            got = rec["out"].get(log2)
            n = (cands.size + costs.size if got is None else
                 int((got[0] != cands).sum()) + int((got[1] != costs).sum()))
            if n:
                notes.append(f"picture {idx}: {n} entries of the {1 << log2}"
                             f"x{1 << log2} prescreen differ")
            bad_screen += n
    if screened == 0:
        bad_screen += 1
        notes.append("no prescreen was checked")
    if bad_hash:
        notes.append(f"{bad_hash} coded pictures do not carry their "
                     "reconstruction's hash")
    s.checked = {"searches": checked, "screens": screened,
                 "decoded": s.decode["pocs"]}
    s.notes = notes
    return {"hash_mismatch": bad_hash + s.decode["hashes"],
            "decode_mismatch": s.decode["samples"],
            "search_mismatch": bad_search, "screen_mismatch": bad_screen}


def frame_ms_p90(t0: float, steps: list) -> float:
    """90th percentile of the gaps between steps' returns, in ms."""
    gaps = np.diff([t0] + steps) * 1e3
    if len(gaps) < 2:
        return float(gaps[0])
    return statistics.quantiles(gaps.tolist(), n=10,
                                method="inclusive")[8]


def end_to_end(s) -> dict:
    """{name: value} of every end-to-end metric the benchmark knows."""
    rng = s.range
    bits = [s.bits.get(i, s.stats_bits.get(i, 0)) for i in rng]
    psnr = [ref.psnr_y(s.src[i][0], s.recons[i][0], s.bit_depth)
            for i in rng]
    out = {"setup_s": s.setup_s,
           "fps": s.pictures / s.window_s,
           "kbit_per_frame": sum(bits) / len(rng) / 1e3,
           "psnr_y_db": float(np.mean(psnr))}
    out["frame_ms_p90"] = frame_ms_p90(s.t0, s.steps)
    return out
