"""What the timed path's motion search and intra prescreen were given and
returned, recorded at the encoder's own entry points for the reference.

`install` wraps `ops.me_ssd.me_grids_multi2_async` and
`ops.intra_screen.screen_frame_async` of the encoder (module attributes
that the encoder looks up at each call). Searches are sampled while
recording is on: a reservoir of `keep` calls, uniform over every call,
drawn from the seed, so the number held stays fixed however long the
window runs. Every prescreen call is kept (one an intra picture).
Searches are recorded while `searching` is on (the window), prescreens
while `recording` is on (set-up, for the IDR's, and the window)."""
from __future__ import annotations

import random

import numpy as np


class Capture:
    def __init__(self, seed: int, keep: int = 6):
        self.rng = random.Random(seed * 7919 + 17)
        self.keep = keep
        self.seen = 0
        self.searches = []
        self.screens = []
        self.recording = False
        self.searching = False
        self._undo = []

    def install(self) -> None:
        from hevc_tpu_torch.ops import intra_screen, me_ssd
        orig_search = me_ssd.me_grids_multi2_async
        orig_screen = intra_screen.screen_frame_async

        def search(orig_dev, ref_devs, size, size2, r, lam_fp, *, pad,
                   depth=8, mesh=None, wp=None, refine=False):
            collect = orig_search(orig_dev, ref_devs, size, size2, r,
                                  lam_fp, pad=pad, depth=depth, mesh=mesh,
                                  wp=wp, refine=refine)
            if not self.searching:
                return collect
            rec = self._slot({
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
            if not self.recording:
                return resolve
            rec = {"orig": np.array(orig_y, copy=True),
                   "bit_depth": bit_depth, "sqrt_lam": sqrt_lam,
                   "log2s": tuple(log2s), "out": None}
            self.screens.append(rec)

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

    def _slot(self, rec: dict):
        """Reservoir sampling: the n-th call is kept with chance keep/n."""
        self.seen += 1
        if len(self.searches) < self.keep:
            self.searches.append(rec)
            return rec
        j = self.rng.randrange(self.seen)
        if j < self.keep:
            self.searches[j] = rec
            return rec
        return None

    def to_host(self) -> None:
        """Copy the sampled searches' planes to the host, so that the
        encoder's device state can be freed before the reference runs."""
        for rec in self.searches:
            rec["orig"] = rec["orig"].cpu().numpy()
            rec["refs"] = [t.cpu().numpy() for t in rec["refs"]]
