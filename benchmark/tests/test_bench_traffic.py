"""The traffic generator: the same seed gives the same pictures, the sizes
follow the mix, and the stream does not depend on how far it is read."""
import numpy as np

from benchmark.harness import spec
from benchmark.harness.traffic import Stream


def mix(w=96, h=64, **kw):
    m = {"width": w, "height": h, "content_seed": 11, "offset_span": 8,
         "background": {"blur": [9, 5], "contrast": 6.0, "grain": 3.0},
         "pan": [2, 3],
         "objects": [{"side_frac": 0.25, "start_frac": [0.4, 0.9],
                      "velocity": [3, -5]}],
         "sensor_noise": 0.0, "chroma": {"cb": [2, 40], "cr": [3, 70]}}
    m.update(kw)
    return m


def take(stream, n):
    return [stream.next() for _ in range(n)]


def test_seed_draws_grain_and_start_not_the_structure():
    a = Stream(mix(objects=[]), 1)
    b = Stream(mix(objects=[]), 2)
    assert not np.array_equal(a.next()[0], b.next()[0])
    # the blurred structure is the mix's: the two backgrounds differ by
    # grain alone (sigma 3), far less than the texture's own spread
    d = a._bg.astype(float) - b._bg.astype(float)
    assert d.std() < 6 and a._bg.std() > 20


def test_offset_starts_the_clip_later():
    m = mix(objects=[], offset_span=0)
    s0 = Stream(m, 5)
    frames = [s0.next()[0] for _ in range(4)]
    s = Stream(dict(m, offset_span=8), 5)
    s.t0 = 3
    assert np.array_equal(s.next()[0], frames[3])


def test_deterministic_per_seed():
    big = 2 ** 31 + 12345
    a = take(Stream(mix(sensor_noise=2.0), big), 5)
    b = take(Stream(mix(sensor_noise=2.0), big), 5)
    c = take(Stream(mix(sensor_noise=2.0), big + 1), 5)
    for pa, pb, pc in zip(a, b, c):
        for x, y in zip(pa, pb):
            assert np.array_equal(x, y)
        assert not np.array_equal(pa[0], pc[0])


def test_sizes_and_depths():
    for bd, top in ((8, 255), (10, 1023)):
        y, u, v = Stream(mix(), 7, bd).next()
        assert y.shape == (64, 96) and u.shape == v.shape == (32, 48)
        assert y.dtype == u.dtype == np.int16
        assert 0 <= y.min() and y.max() <= top


def test_ten_bit_samples_widen_the_eight_bit_ones():
    y8 = Stream(mix(), 3, 8).next()[0]
    y10 = Stream(mix(), 3, 10).next()[0]
    assert np.array_equal(y10 >> 2, y8)
    assert np.array_equal(y10 & 3, y8 & 3)


def test_pan_moves_the_background():
    m = mix(objects=[], offset_span=0)
    s = Stream(m, 5)
    p0, p1 = s.next()[0], s.next()[0]
    assert np.array_equal(p1[:-2, :-3], p0[2:, 3:])


def test_static_mix_without_noise_repeats():
    m = mix(pan=[0, 0], objects=[])
    s = Stream(m, 5)
    assert np.array_equal(s.next()[0], s.next()[0])


def test_the_benchmark_mixes_have_their_class_sizes():
    assert (spec.traffic("b1080_pan")["width"],
            spec.traffic("b1080_pan")["height"]) == (1920, 1080)
    assert (spec.traffic("e720_static")["width"],
            spec.traffic("e720_static")["height"]) == (1280, 720)
