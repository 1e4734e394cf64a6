"""Every inter picture's integer motion search has one owner,
EncoderTop._picture_search, and one route: me_ssd.me_grids_multi2_async
over the unique references of L0 and L1. With the one-frame lookahead the
lookahead's dispatches cover each of those references once and the picture
waits on them; without it (HEVC_TPU_ME_PREFETCH=0, random access, a
weighted picture, parallel.encode_clip's lookahead mode) the picture makes
one call over all of them. The encoder's counters say which route each
picture took, and every stream equals hevc_tpu's on the CPU."""
import dataclasses

import numpy as np
import pytest

from hevc_tpu import parallel as jax_parallel
from hevc_tpu.encoder.top import EncoderTop as JaxEncoderTop
from hevc_tpu.io.cfg import EncoderConfig as JaxEncoderConfig
from hevc_tpu.io.cfg import parse_cfg_file as jax_parse_cfg_file
from hevc_tpu_torch import parallel
from hevc_tpu_torch.encoder import native_frame
from hevc_tpu_torch.encoder.top import EncoderTop
from hevc_tpu_torch.io.cfg import config_from_reference
from hevc_tpu_torch.ops import me_ssd
from hevc_tpu_torch.utils.timing import timers
from test_torch_helpers import (CFG_DIR, LDP_CFG, moving_frames,
                                no_jax_cache_writes,
                                one_torch_thread,  # noqa: F401
                                private_reference_native)  # noqa: F401


class Route:
    """Records each search through me_ssd.me_grids_multi2_async (the
    picture whose source it searched, its reference planes, its weights),
    the unique references each picture's owner was asked for, and the
    encoder's counters. `lookahead`: whether the encoder may run its
    lookahead (parallel.encode_clip's lookahead mode does not)."""

    def __init__(self, monkeypatch, frames, lookahead=True):
        self.calls, self.uniq = [], {}
        self.lookahead = lookahead
        src = {np.asarray(f[0], np.uint8).tobytes(): i
               for i, f in enumerate(frames)}
        search = me_ssd.me_grids_multi2_async

        def spy(orig, refs, *a, **k):
            self.calls.append((src[orig.numpy().tobytes()],
                               [id(r) for r in refs], k.get("wp")))
            return search(orig, refs, *a, **k)
        monkeypatch.setattr(me_ssd, "me_grids_multi2_async", spy)
        owner = EncoderTop._picture_search

        def owner_spy(enc, display_poc, src_y, ref_l0, ref_l1, *a):
            self.uniq[display_poc] = len({p for p, _ in ref_l0 + ref_l1})
            return owner(enc, display_poc, src_y, ref_l0, ref_l1, *a)
        monkeypatch.setattr(EncoderTop, "_picture_search", owner_spy)
        self.count = {}
        self._monkeypatch = monkeypatch
        timers.reset()
        monkeypatch.setattr(timers, "enabled", True)

    def stop(self):
        """Keep the counters of the encode just run and stop counting."""
        self.count = dict(timers.count)
        self._monkeypatch.setattr(timers, "enabled", False)

    def of(self, picture):
        """(lookahead calls, one-picture calls) of a picture: the
        one-picture searches pass a weight per reference, the lookahead's
        none."""
        mine = [c for c in self.calls if c[0] == picture]
        if not self.lookahead:
            return [], mine
        return ([c for c in mine if c[2] is None],
                [c for c in mine if c[2] is not None])

    def check(self, lookahead_taken):
        """Each inter picture searched its unique references once: spread
        over the lookahead's calls for the pictures in `lookahead_taken`,
        in one call for the others; the counters agree."""
        assert self.count.get("me_searched", 0) == len(self.uniq)
        assert (self.count.get("me_lookahead_taken", 0)
                == len(lookahead_taken))
        for pic, n in self.uniq.items():
            ahead, sync = self.of(pic)
            if pic in lookahead_taken:
                ids = [i for c in ahead for i in c[1]]
                assert sync == [] and len(set(ids)) == len(ids) == n, pic
            else:
                assert len(sync) == 1 and len(sync[0][1]) == n, pic


def _ldp_cfg(w, h, n):
    cfg = jax_parse_cfg_file(LDP_CFG, JaxEncoderConfig())
    cfg.width, cfg.height, cfg.frames_to_encode = w, h, n
    return cfg


def _fade(n, w, h, seed=11):
    """Blocky 8-bit texture panning by (3, 2) under a gain ramp (the
    weighted-prediction analysis finds weights), flat chroma."""
    rng = np.random.default_rng(seed)
    base = np.repeat(np.repeat(rng.integers(40, 220, (h // 4 + 12,
                                                      w // 4 + 12)), 4, 0),
                     4, 1).astype(np.float64)
    out = []
    for t in range(n):
        y = base[8 + 2 * t:8 + 2 * t + h, 8 + 3 * t:8 + 3 * t + w]
        y = np.clip(y * (1.0 - 0.12 * t), 0, 255).astype(np.uint8)
        c = np.full((h // 2, w // 2), 128, np.uint8)
        out.append([y, c, c.copy()])
    return out


def _encode(enc, frames, lookahead):
    """encode_frame over the clip; with `lookahead`, each picture's
    successor is prefetched just before it, as the CLI and the benchmark
    do."""
    out = b""
    for i, f in enumerate(frames):
        if lookahead and i + 1 < len(frames):
            enc.prefetch_frame(frames[i + 1])
        out += enc.encode_frame(f)
    return out + enc.flush()


def _pair(monkeypatch, cfg, frames, lookahead):
    """The port's stream, with its search route recorded, and hevc_tpu's
    (its device orchestration on JAX-CPU when the lookahead runs)."""
    route = Route(monkeypatch, frames)
    got = _encode(EncoderTop(config_from_reference(dataclasses.asdict(cfg)),
                             device="cpu"), frames, lookahead)
    route.stop()
    monkeypatch.setenv("HEVC_TPU_ME_PREFETCH_CPU", "1")
    with no_jax_cache_writes():
        enc = JaxEncoderTop(cfg)
        ref = b""
        for i, f in enumerate(frames):
            if lookahead and i + 1 < len(frames):
                enc.prefetch_frame(frames[i + 1])
            ref += enc.encode_frame(f)
        ref += enc.flush()
    return route, got, ref


@pytest.mark.parametrize("prefetch", ["1", "0"])
def test_ldp_search_route(monkeypatch, prefetch):
    """Low-delay P with 1 to 4 references: with the lookahead every P
    picture waits on it; with HEVC_TPU_ME_PREFETCH=0 each searches in one
    call."""
    monkeypatch.setenv("HEVC_TPU_ME_PREFETCH", prefetch)
    n = 7
    route, got, ref = _pair(monkeypatch, _ldp_cfg(128, 80, n),
                            moving_frames(n, 128, 80, seed=4), True)
    assert len(got) > 0 and got == ref
    assert sorted(route.uniq.values()) == [1, 2, 2, 2, 2, 3]
    route.check(set(route.uniq) if prefetch == "1" else set())


def test_ra_search_route(monkeypatch):
    """Random access: no lookahead, one call a B picture over the unique
    pictures of L0 and L1 (both lists hold past and future pictures)."""
    cfg = jax_parse_cfg_file(f"{CFG_DIR}/encoder_randomaccess_main.cfg",
                             JaxEncoderConfig())
    cfg.width, cfg.height, cfg.frames_to_encode = 96, 64, 9
    cfg.search_range = 16
    route, got, ref = _pair(monkeypatch, cfg, moving_frames(9, 96, 64,
                                                            seed=7), True)
    assert len(got) > 0 and got == ref
    assert len(route.uniq) == 8 and max(route.uniq.values()) > 2
    route.check(set())


def test_weighted_search_route(monkeypatch):
    """A fade under WeightedPredP=1 with the lookahead: a picture with
    weights drops the lookahead's unweighted search and searches once,
    weighted; the others wait on the lookahead."""
    n = 5
    cfg = _ldp_cfg(192, 128, n)
    cfg.search_range, cfg.weighted_pred_p = 12, 1
    route, got, ref = _pair(monkeypatch, cfg, _fade(n, 192, 128), True)
    assert len(got) > 0 and got == ref
    weighted = {c[0] for c in route.calls
                if c[2] is not None and any(t is not None for t in c[2])}
    assert weighted
    route.check(set(route.uniq) - weighted)


@pytest.mark.parametrize("w,h,weighted", [(96, 64, False),
                                          (192, 16, True)])
def test_provider_search_route(monkeypatch, w, h, weighted):
    """parallel.encode_clip's lookahead mode: list-0 reference 0's CU
    grid is the provider's (the frame-axis search against the source
    picture before), every picture searches in one call, and the stream
    equals hevc_tpu.parallel's. At 192x16 only the 16 grid fits the
    picture: the weighted references are weighted all the same, as the
    per-reference search of hevc_tpu weighs them."""
    n = 4
    cfg = _ldp_cfg(w, h, n)
    cfg.search_range = 12
    cfg.weighted_pred_p = int(weighted)
    frames = _fade(n, w, h) if weighted else moving_frames(n, w, h, seed=2)
    with no_jax_cache_writes():
        ref, _ = jax_parallel.encode_clip(cfg, frames, lookahead=True)
    route = Route(monkeypatch, frames, lookahead=False)
    provided, engine_l0 = [], []
    frames_search = parallel.me_grids_frames

    def frames_spy(*a, **k):
        gx, gy = frames_search(*a, **k)
        provided.append(gx)
        return gx, gy
    monkeypatch.setattr(parallel, "me_grids_frames", frames_spy)
    engine = native_frame.NativeCtuEngine

    def engine_spy(sp, ep, senc, orig, recon, r0, r1, me_x, *a):
        engine_l0.append(me_x[0] if me_x else None)
        return engine(sp, ep, senc, orig, recon, r0, r1, me_x, *a)
    monkeypatch.setattr(native_frame, "NativeCtuEngine", engine_spy)
    applied = []
    wp_apply_multi = me_ssd.wp_apply_multi

    def wp_spy(planes, wpvs, depth):
        applied.extend(tuple(int(v) for v in t) != (1, 0, 0) for t in wpvs)
        return wp_apply_multi(planes, wpvs, depth)
    monkeypatch.setattr(me_ssd, "wp_apply_multi", wp_spy)
    got, _ = parallel.encode_clip(config_from_reference(
        dataclasses.asdict(cfg)), frames, lookahead=True, device="cpu")
    route.stop()
    assert len(got) > 0 and got == ref
    route.check(set())
    inter = engine_l0[1:]
    assert len(inter) == n - 1
    # the provider's grids are views of its one [F, ny, nx] array (empty
    # where the CU grid does not fit the picture)
    assert all(g is not None and g.shape == provided[0].shape[1:]
               and (g.size == 0 or np.shares_memory(g, provided[0]))
               for g in inter)
    assert any(applied) == weighted
