"""The one generator of every traffic mix: an endless stream of synthetic
4:2:0 pictures made from a seed and a mix's parameters.

The content follows `clip_frames` of the repo's chip smoke test (a
box-blurred random texture with static grain, a textured square pasted
over it, chroma planes derived from the luma), made endless: the
background is blurred with wrap-around edges, so it tiles seamlessly and
a pan of any length reads a fixed-size plane. Pictures are made one at a
time, on the host, in display order; nothing is written to disk.

The blurred structure of every texture comes from the mix's own
`content_seed`, so every run codes the same scene at the same statistics.
The run's seed draws the static grain on it, where in the clip the run
starts (a picture in [0, offset_span)), and the sensor noise: different
seeds give different pictures of one scene, the same work in another
draw, and the bits a picture costs do not swing with the seed.

A mix file (benchmark/traffic/<name>.json) holds:
  width, height         picture size in luma samples
  content_seed          seed of the textures' structure
  offset_span           the run starts at picture t0 of the clip, t0 drawn
                        from the seed in [0, offset_span) (0: at 0)
  background            {"blur": [k1, k2], "contrast": c, "grain": sigma}
  pan                   [dy, dx] background motion a picture
  objects               [{"side_frac": f, "start_frac": [fy, fx],
                          "velocity": [dy, dx], "texture": {...}}]
                        a square of side f * min(h, w), at fy * (h - side),
                        fx * (w - side) in picture 0 of the clip, moving
                        and turning back at the picture's edges
  sensor_noise          sigma of Gaussian noise added to every picture's
                        luma (0: none): a view at a random offset of one
                        noise field drawn from the seed, a fresh draw for
                        each picture at the cost of one addition
  chroma                {"cb": [div, add], "cr": [div, add]}
"""
from __future__ import annotations

import numpy as np


def _box(a: np.ndarray, k: int, wrap: bool) -> np.ndarray:
    """k x k box blur, separable, via cumulative sums; edges padded by
    wrap-around (a tileable result) or by edge replication."""
    p = k // 2
    a = np.pad(a, ((p, k - 1 - p), (p, k - 1 - p)),
               mode="wrap" if wrap else "edge")
    c = np.concatenate([np.zeros((1, a.shape[1])), a.cumsum(0)])
    a = (c[k:] - c[:-k]) / k
    c = np.concatenate([np.zeros((a.shape[0], 1)), a.cumsum(1)], axis=1)
    return (c[:, k:] - c[:, :-k]) / k


def texture(content, grain_rng, h: int, w: int, blur=(9, 5), contrast=6.0,
            grain=3.0, wrap=False) -> np.ndarray:
    """uint8 [h, w]: blurred uniform noise from `content`, stretched about
    128, plus static Gaussian grain from `grain_rng` (clip_frames'
    `_texture` at its defaults)."""
    t = content.random((h, w)) * 255.0
    for k in blur:
        t = _box(t, int(k), wrap)
    t = (t - t.mean()) * float(contrast) + 128.0 + grain_rng.normal(
        0.0, float(grain), (h, w))
    return np.clip(t, 0, 255).astype(np.uint8)


def deep_plane(p: np.ndarray, bit_depth: int) -> np.ndarray:
    """A uint8 plane as bit_depth-bit int16 samples: s << k | s & (2^k - 1),
    k = bit_depth - 8 (chip smoke test's `deep_plane`). At 8 bits the
    samples as they are, in int16, as a YUV reader hands them over."""
    k = bit_depth - 8
    return ((p.astype(np.int16) << k) | (p & ((1 << k) - 1))).astype(
        np.int16)


def _bounce(p: int, span: int) -> int:
    """Position p folded into [0, span] (a path that turns back at both
    ends, so an object never jumps across the picture)."""
    m = p % (2 * span)
    return m if m <= span else 2 * span - m


class Stream:
    """Picture t of a mix, for t = 0, 1, 2, ... (call `next()` in order).

    The same seed and parameters give the same pictures. Every picture
    costs one copy of the background view, the pasted objects, the
    chroma arithmetic and, where the mix has sensor noise, the addition
    of one view of the noise field."""

    def __init__(self, mix: dict, seed: int, bit_depth: int = 8):
        self.h, self.w = int(mix["height"]), int(mix["width"])
        self.bit_depth = bit_depth
        content = np.random.default_rng(int(mix["content_seed"]))
        draw = np.random.default_rng([seed, 2])
        bg = mix["background"]
        hb, wb = 2 * self.h, 2 * self.w
        base = texture(content, draw, hb, wb, bg["blur"], bg["contrast"],
                       bg["grain"], wrap=True)
        # tile once more so that any (y, x) start in [0, hb) x [0, wb)
        # reads a contiguous h x w view
        self._bg = np.pad(base, ((0, self.h), (0, self.w)), mode="wrap")
        self._hb, self._wb = hb, wb
        self.pan = [int(v) for v in mix["pan"]]
        self.objects = []
        for ob in mix.get("objects", []):
            s = max(16, int(min(self.h, self.w) * float(ob["side_frac"])))
            tx = ob.get("texture", {})
            fg = texture(content, draw, s, s, tx.get("blur", bg["blur"]),
                         tx.get("contrast", bg["contrast"]),
                         tx.get("grain", bg["grain"]))
            oy = int((self.h - s) * float(ob["start_frac"][0]))
            ox = int((self.w - s) * float(ob["start_frac"][1]))
            self.objects.append((fg, s, oy, ox,
                                 [int(v) for v in ob["velocity"]]))
        self.noise = float(mix.get("sensor_noise", 0.0))
        self._noise_rng = np.random.default_rng([seed, 1])
        if self.noise:
            field = np.rint(self._noise_rng.standard_normal((self.h, self.w))
                            * self.noise).clip(-127, 127).astype(np.int16)
            self._field = np.pad(field, ((0, self.h), (0, self.w)),
                                 mode="wrap")
        ch = mix["chroma"]
        self.cb = [int(v) for v in ch["cb"]]
        self.cr = [int(v) for v in ch["cr"]]
        span = int(mix.get("offset_span", 0))
        self.t0 = int(draw.integers(span)) if span else 0
        self.t = 0

    def next(self) -> list:
        """[Y, Cb, Cr] of the next picture, int16 planes of bit_depth-bit
        samples."""
        t = self.t0 + self.t
        self.t += 1
        h, w = self.h, self.w
        y0 = (self.pan[0] * t) % self._hb
        x0 = (self.pan[1] * t) % self._wb
        y = self._bg[y0:y0 + h, x0:x0 + w].copy()
        for fg, s, oy, ox, (vy, vx) in self.objects:
            py = _bounce(oy + vy * t, h - s)
            px = _bounce(ox + vx * t, w - s)
            y[py:py + s, px:px + s] = fg
        if self.noise:
            ny, nx = self._noise_rng.integers(0, (h, w))
            n = self._field[ny:ny + h, nx:nx + w]
            y = np.clip(y + n, 0, 255).astype(np.uint8)
        u = (y[::2, ::2] // self.cb[0] + self.cb[1]).astype(np.uint8)
        v = (y[1::2, ::2] // self.cr[0] + self.cr[1]).astype(np.uint8)
        return [deep_plane(p, self.bit_depth) for p in (y, u, v)]
