"""One run of a cell: set-up, the measured window, the rest of the bits
range, and everything the reference and the metrics read afterwards.

The window drives the entry that the encoder's CLI drives
(`cli/encode.py`): one picture pulled ahead, `EncoderTop.prefetch_frame`
on it, then `encode_frame` on the current one. A step is one call that
returns coded bytes: one picture in low delay, a GOP burst in random
access. The window ends at the return of the step that crosses the run's
length, so every counted picture is whole."""
from __future__ import annotations

import time
from collections import deque

from . import spec
from .capture import Capture
from .traffic import Stream


class Session:
    """What a run leaves for the reference and the metrics."""


def encoder_config(conf: dict, mix: dict):
    from hevc_tpu_torch.io.cfg import parse_cli, validate
    argv = ["-c", conf["cfg_path"], "-wdt", str(mix["width"]),
            "-hgt", str(mix["height"]), "-f", "1000000",
            f"--InputBitDepth={conf['bit_depth']}"]
    argv += [f"--{k}={v}" for k, v in conf.get("args", {}).items()]
    cfg = parse_cli(argv)
    validate(cfg)
    return cfg


def run(cell: dict, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", overrides=None,
        bench_dir: str = spec.BENCH_DIR) -> Session:
    """Set up, measure and finish the bits range of one cell. `overrides`
    (tests only) replaces entries of the configuration file."""
    conf = spec.config(cell["config"], bench_dir)
    conf.update(overrides or {})
    mix = spec.traffic(cell["traffic"], bench_dir)
    import torch
    from hevc_tpu_torch.encoder.top import EncoderTop
    from hevc_tpu_torch.utils.timing import timers

    s = Session()
    s.conf, s.mix, s.device = conf, mix, device
    s.bit_depth = conf["bit_depth"]
    cfg = encoder_config(conf, mix)
    s.ctu, s.search_range = cfg.ctu_size, cfg.search_range
    s.gop, s.seed = cfg.gop_size, seed
    cap = Capture(seed)
    cap.install()
    s.capture = cap
    try:
        _run(s, seed, seconds, trace, t_start, cfg, EncoderTop, timers,
             torch)
    finally:
        cap.uninstall()
    return s


def _run(s, seed, seconds, trace, t_start, cfg, EncoderTop, timers, torch):
    conf, mix = s.conf, s.mix
    cuda = s.device == "cuda"
    stream = Stream(mix, seed, s.bit_depth)
    s.src = {}

    def pull():
        planes = stream.next()
        s.src[stream.t - 1] = planes
        return planes

    # set-up: the encoder, its device programs, and the warm-up pictures
    s.capture.recording = True          # the IDR's prescreen is checked
    enc = EncoderTop(cfg, device=s.device)
    enc.warm_device_programs()
    buf = deque([pull(), pull()])

    def step() -> bytes:
        planes = buf.popleft()
        buf.append(pull())
        enc.prefetch_frame(buf[0])
        return enc.encode_frame(planes)

    warm = int(conf["warmup_pictures"])
    head = [step() for _ in range(warm)]
    if len(enc.stats) != warm:
        raise RuntimeError(f"{len(enc.stats)} of {warm} warm-up pictures "
                           "were coded in set-up")
    s.recons = {}
    for idx, planes in enc.pop_recons():
        s.recons[idx] = planes
    if cuda:
        torch.cuda.synchronize()
    s.capture.recording = False
    s.setup_s = time.perf_counter() - t_start

    # the window
    from hevc_tpu_torch.entropy.cabac import engine_frame_stats
    prof = undo_spans = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from .trace import WINDOW_SPAN, spans_on
        timers.reset()
        timers.enabled = True
        undo_spans = spans_on(timers)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function(WINDOW_SPAN)
        span.__enter__()
        eng0 = engine_frame_stats(s.bit_depth > 14)
    s.capture.recording = s.capture.searching = True
    coded0 = len(enc.stats)
    chunks = []
    s.steps = []
    t0 = time.perf_counter()
    while True:
        out = step()
        if not out:
            continue
        t = time.perf_counter()
        chunks.append(out)
        s.steps.append(t)
        if t - t0 >= seconds:
            break
    s.window_s = s.steps[-1] - t0
    s.t0 = t0
    s.pictures = len(enc.stats) - coded0
    s.capture.recording = s.capture.searching = False
    if trace:
        eng1 = engine_frame_stats(s.bit_depth > 14)
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        timers.enabled = False
        undo_spans()
        s.sections = dict(timers.total)
        s.engine = {k: eng1[k] - eng0[k] for k in eng0}
        from .trace import reduce_profile
        s.profile = reduce_profile(prof)
        del prof
    s.memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # untimed: code on to the end of the bits range
    s.range = list(range(warm, warm + int(conf["range_pictures"])))
    while len(enc.stats) < s.range[-1] + 1:
        out = step()
        if out:
            chunks.append(out)
    for idx, planes in enc.pop_recons():
        s.recons[idx] = planes
    s.coded = [st["poc"] for st in enc.stats[coded0:]]
    s.stats_bits = {st["poc"]: st["bits"] for st in enc.stats}
    s.head = b"".join(head)
    s.data = b"".join(chunks)
    s.capture.to_host()
    del enc, buf
    if cuda:
        import gc
        gc.collect()
        torch.cuda.empty_cache()
