"""What the timed path's motion search and intra prescreen were given and
returned, recorded at the encoder's own entry points for the reference.

`install` wraps `ops.me_ssd.me_grids_multi2_async` and
`ops.intra_screen.screen_frame_async` of the encoder (module attributes
that the encoder looks up at each call). Every prescreen of set-up is
kept while `recording` is on (the warm-up's, the IDR's, the warm-up
pictures'). While `window` is on, searches and prescreens are each
sampled: a reservoir of `keep` calls, uniform over every call of the
window, drawn from the seed by a generator of their own, so the number
held stays fixed however long the window runs (an all-intra window
screens every picture). A prescreen's source plane is copied only when
the reservoir keeps it."""
from __future__ import annotations

import random

import numpy as np


class Reservoir:
    """A uniform sample of `keep` of the calls offered (reservoir
    sampling): the n-th call is kept with chance keep/n."""

    def __init__(self, rng: random.Random, keep: int):
        self.rng = rng
        self.keep = keep
        self.seen = 0
        self.kept = []

    def offer(self, make):
        """Count one call; where it is kept, the record `make()` builds
        takes its slot and is returned, else None."""
        self.seen += 1
        if len(self.kept) < self.keep:
            self.kept.append(make())
            return self.kept[-1]
        j = self.rng.randrange(self.seen)
        if j < self.keep:
            self.kept[j] = make()
            return self.kept[j]
        return None


class Capture:
    def __init__(self, seed: int, keep: int = 6):
        self.search_sample = Reservoir(random.Random(seed * 7919 + 17),
                                       keep)
        self.screen_sample = Reservoir(random.Random(seed * 7919 + 29),
                                       keep)
        self.setup_screens = []
        self.recording = False
        self.window = False
        self._undo = []

    @property
    def searches(self) -> list:
        return self.search_sample.kept

    @property
    def screens(self) -> list:
        """Set-up's prescreens, then the window's sample."""
        return self.setup_screens + self.screen_sample.kept

    def install(self) -> None:
        from hevc_tpu_torch.ops import intra_screen, me_ssd
        orig_search = me_ssd.me_grids_multi2_async
        orig_screen = intra_screen.screen_frame_async

        def search(orig_dev, ref_devs, size, size2, r, lam_fp, *, pad,
                   depth=8, mesh=None, wp=None, refine=False):
            collect = orig_search(orig_dev, ref_devs, size, size2, r,
                                  lam_fp, pad=pad, depth=depth, mesh=mesh,
                                  wp=wp, refine=refine)
            if not self.window:
                return collect
            rec = self.search_sample.offer(lambda: {
                "orig": orig_dev, "refs": list(ref_devs), "size": size,
                "size2": size2, "r": r, "lam_fp": lam_fp, "pad": pad,
                "depth": depth, "wp": wp, "grids": None})
            if rec is None:
                return collect

            def wrapped():
                out = collect()
                rec["grids"] = [tuple(g[:4]) for g in out]
                return out
            return wrapped

        def screen(orig_y, bit_depth, sqrt_lam, log2s=(2, 3, 4, 5),
                   device="cuda"):
            resolve = orig_screen(orig_y, bit_depth, sqrt_lam, log2s,
                                  device)

            def make():
                return {"orig": np.array(orig_y, copy=True),
                        "bit_depth": bit_depth, "sqrt_lam": sqrt_lam,
                        "log2s": tuple(log2s), "out": None}
            if self.window:
                rec = self.screen_sample.offer(make)
            elif self.recording:
                rec = make()
                self.setup_screens.append(rec)
            else:
                rec = None
            if rec is None:
                return resolve

            def wrapped():
                out = resolve()
                rec["out"] = out
                return out
            return wrapped

        me_ssd.me_grids_multi2_async = search
        intra_screen.screen_frame_async = screen
        self._undo = [(me_ssd, "me_grids_multi2_async", orig_search),
                      (intra_screen, "screen_frame_async", orig_screen)]

    def uninstall(self) -> None:
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        self._undo = []

    def to_host(self) -> None:
        """Copy the sampled searches' planes to the host, so that the
        encoder's device state can be freed before the reference runs."""
        for rec in self.searches:
            rec["orig"] = rec["orig"].cpu().numpy()
            rec["refs"] = [t.cpu().numpy() for t in rec["refs"]]
