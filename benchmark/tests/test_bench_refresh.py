"""Each configuration's refresh pictures follow the HM keys that its cfg
copy and its `args` state, `IntraPeriod` and `DecodingRefreshType`.

The expected keys are read from the `.cfg` copy with `args` over it, and
each key admits the NAL unit types that HM's `TEncGOP::getNalUnitType`
gives or, where the port does not follow the key yet, the types the port
codes. So these cases hold before and after the port learns to read the
keys. A change to how the port codes refresh pictures runs this module:
it is outside the tier-1 command."""
import pytest

from benchmark.harness import loop, spec
from benchmark.harness.reference import split_nals
from benchmark.harness.traffic import Stream

W, H = 128, 80
TRAIL = (0, 1)          # TRAIL_N, TRAIL_R
LEADING = range(6, 10)  # RADL_N, RADL_R, RASL_N, RASL_R
IRAP = range(16, 24)
IDR = (19, 20)          # IDR_W_RADL, IDR_N_LP
KEYS = ("IntraPeriod", "DecodingRefreshType")


def cfg_keys(path: str) -> dict:
    """The refresh keys of a cfg file, as integers."""
    keys = {}
    with open(path) as fh:
        for line in fh:
            key, sep, value = line.split("#")[0].partition(":")
            if sep and key.strip() in KEYS:
                keys[key.strip()] = int(value)
    return keys


def picture_types(data: bytes) -> list:
    """The NAL unit type of each picture's first slice segment, in
    decoding order."""
    types = []
    for nal, _ in split_nals(data):
        ntype = (nal[0] >> 1) & 0x3F
        if ntype < 32 and len(nal) > 2 and nal[2] & 0x80:
            types.append(ntype)
    return types


def later_types(intra_period: int, refresh_type: int):
    """The NAL types admitted after the first picture (an IDR)."""
    if intra_period <= 0:
        return TRAIL           # no IRAP after the first, so no leading
    if intra_period == 1 and refresh_type == 2:
        return IDR             # an IDR at every intra period
    if intra_period == 1 and refresh_type == 0:
        return IDR + TRAIL     # the port's IDRs; HM's trailing I pictures
    pytest.fail(f"no rule yet for IntraPeriod {intra_period} with "
                f"DecodingRefreshType {refresh_type}")


@pytest.mark.parametrize("name", ["intra_main", "ldp_main", "ra_main10"])
def test_refresh_pictures_follow_the_keys(name, one_thread):
    conf = spec.config(name)
    published = cfg_keys(conf["cfg_path"])
    keys = dict(published, **{k: v for k, v in conf["args"].items()
                              if k in KEYS})
    mix = dict(spec.traffic("b1080_pan"), width=W, height=H)
    cfg = loop.encoder_config(conf, mix)
    assert (cfg.intra_period, cfg.decoding_refresh_type) == (
        keys["IntraPeriod"], keys["DecodingRefreshType"])

    # where the published cfg asks for periodic refresh, code past the
    # first picture at which it would fall
    n = max(published["IntraPeriod"], 4) + 1
    from hevc_tpu_torch.encoder.top import EncoderTop
    stream = Stream(mix, 2 ** 31 + 26, conf["bit_depth"])
    enc = EncoderTop(cfg, device="cpu")
    chunks = [enc.encode_frame(stream.next()) for _ in range(n)]
    types = picture_types(b"".join(chunks + [enc.flush()]))
    assert len(types) == n, types
    assert types[0] in IDR, types
    allowed = later_types(keys["IntraPeriod"], keys["DecodingRefreshType"])
    assert all(t in allowed for t in types[1:]), (allowed, types)
    assert not any(t in LEADING for t in types), types
