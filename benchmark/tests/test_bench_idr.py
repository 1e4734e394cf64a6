"""Streams with many IDRs and the window's prescreens: an all-intra run
(every picture an IDR with POC 0) is decoded and compared picture by
picture, by display index; the window's prescreens are a fixed sample
of six, beside every prescreen of set-up; and a low-delay run keys its
pictures by POC and samples its searches as before."""
import re

import numpy as np

from conftest import tiny_cell

from benchmark import run
from benchmark.harness import check, decode, loop, spec
from benchmark.harness.capture import Capture
from benchmark.hevcdec.decoder.top import DecoderTop


def keep_sessions(monkeypatch) -> list:
    """Make `loop.run` hand its sessions to the test as well."""
    kept = []
    plain = loop.run

    def run_and_keep(*a, **k):
        kept.append(plain(*a, **k))
        return kept[-1]
    monkeypatch.setattr(loop, "run", run_and_keep)
    return kept


def test_all_intra_run_is_correct(tiny_intra, one_thread, monkeypatch,
                                  capsys):
    bench_dir, cell = tiny_intra
    sessions = keep_sessions(monkeypatch)
    rc, result = run.execute(spec.benchmark(), cell, 2 ** 31 + 91, 2.0,
                             False, device="cpu", bench_dir=bench_dir,
                             overrides={"range_pictures": 4})
    assert rc == 0 and result["correct"] is True, result
    s = sessions[0]
    sampled = decode.sample_pocs(s.seed, s.range[0], len(s.range), s.gop)
    assert s.decode["pocs"] == [0, *sampled] and len(sampled) == 1
    assert sorted(s.decode["psnr"]) == s.decode["pocs"]
    assert all(v > 25 for v in s.decode["psnr"].values()), s.decode
    assert not any("not decoded" in n for n in s.notes), s.notes
    err = capsys.readouterr().err
    assert re.search(r"decoded pictures \[0, \d+\] \(luma PSNR [\d.]+, "
                     r"[\d.]+\)", err), err[-2000:]
    # every window picture was screened; at most six of them are kept
    window = s.capture.screen_sample
    assert window.seen >= s.pictures
    assert len(window.kept) == min(6, window.seen)
    assert len(s.capture.setup_screens) >= 1 + int(s.conf["warmup_pictures"])
    assert s.checked["screens"] >= len(s.capture.setup_screens)


def test_window_screens_are_a_fixed_sample(monkeypatch):
    """Twenty screens in the window keep six of them, drawn from the
    seed; every screen of set-up is kept."""
    from hevc_tpu_torch.ops import intra_screen

    def fake(orig_y, bit_depth, sqrt_lam, log2s=(2, 3, 4, 5),
             device="cuda"):
        return lambda: {2: int(orig_y[0, 0])}
    monkeypatch.setattr(intra_screen, "screen_frame_async", fake)

    def drive(seed):
        cap = Capture(seed)
        cap.install()
        try:
            cap.recording = True
            for i in range(3):
                intra_screen.screen_frame_async(np.full((8, 8), i), 8, 1.0)()
            cap.recording = False
            cap.window = True
            for i in range(100, 120):
                intra_screen.screen_frame_async(np.full((8, 8), i), 8, 1.0)()
            cap.window = False
            intra_screen.screen_frame_async(np.full((8, 8), 7), 8, 1.0)()
        finally:
            cap.uninstall()
        assert intra_screen.screen_frame_async is fake
        return [r["out"][2] for r in cap.screens], cap

    kept, cap = drive(2 ** 31 + 3)
    assert kept[:3] == [0, 1, 2] and len(kept) == 9
    assert len(set(kept[3:])) == 6 and all(100 <= v < 120 for v in kept[3:])
    assert cap.screen_sample.seen == 20 and cap.search_sample.seen == 0
    # the screens drew nothing from the searches' generator
    assert (cap.search_sample.rng.getstate()
            == Capture(2 ** 31 + 3).search_sample.rng.getstate())
    assert drive(2 ** 31 + 3)[0] == kept
    assert drive(2 ** 31 + 4)[0] != kept


class _Indices(DecoderTop):
    """Parses a stream, every picture given, and keeps (display index,
    POC) of each picture."""

    def __init__(self, given):
        super().__init__(given=given)
        self.pairs = []

    def _store(self, sh, recon):
        super()._store(sh, recon)
        self.out_buf.clear()
        self.pairs.append((self.index(sh), sh.poc))


def test_low_delay_keys_by_poc_and_samples_searches_as_before(
        tiny_bench, one_thread):
    seed = 2 ** 31 + 13
    s = loop.run(tiny_cell("ldp_main.b1080_pan"), seed, 4.0, False,
                 t_start=0.0, device="cpu", bench_dir=tiny_bench,
                 overrides={"range_pictures": 4})
    numbers = check.evaluate(s)
    assert all(v == 0 for v in numbers.values()), (numbers, s.notes)
    dec = _Indices(s.recons)
    for _ in dec.decode_stream(s.head + s.data):
        pass
    assert dec.pairs and all(i == poc for i, poc in dec.pairs)
    assert [i for i, _ in dec.pairs] == list(range(len(dec.pairs)))
    sampled = decode.sample_pocs(seed, s.range[0], len(s.range), s.gop)
    assert s.decode["pocs"] == sorted({0, *sampled})
    # the searches' reservoir made the draws of one that never saw a
    # screen, so it kept the same calls
    searches = s.capture.search_sample
    assert s.capture.setup_screens and s.capture.screen_sample.seen == 0
    assert searches.seen > 6
    fresh = Capture(seed).search_sample
    for _ in range(searches.seen):
        fresh.offer(dict)
    assert fresh.rng.getstate() == searches.rng.getstate()
    assert len(searches.kept) == len(fresh.kept) == 6
