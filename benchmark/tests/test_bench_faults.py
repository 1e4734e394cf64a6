"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (after its look for a card) on the CPU at a tiny
size, once for each fault an encoder cell can have: a motion vector, a
prescreen candidate or a picture's hash altered where it is produced,
a reconstruction altered where it is produced (after the hash, or before
it, so that hash and reconstruction agree and only a decode of the
stream tells), a coded bit altered where it is produced, and half of the
pictures of the steps left out of the bytes."""
import pytest

from conftest import tiny_cell

from benchmark import run
from benchmark.harness import spec


def drive(cell, bench_dir):
    rc, result = run.execute(spec.benchmark(), tiny_cell(cell), 2 ** 31 + 5,
                             0.5, False, device="cpu", bench_dir=bench_dir,
                             overrides={"range_pictures": 4})
    assert rc == 0
    return result


def alter_search(monkeypatch):
    from hevc_tpu_torch.ops import me_ssd
    plain = me_ssd.me_grids_multi2_async

    def broken(*a, **k):
        collect = plain(*a, **k)

        def c():
            out = collect()
            out[0][0][0, 0] += 1
            return out
        return c
    monkeypatch.setattr(me_ssd, "me_grids_multi2_async", broken)


def alter_screen(monkeypatch):
    from hevc_tpu_torch.ops import intra_screen
    plain = intra_screen.screen_frame_async

    def broken(*a, **k):
        resolve = plain(*a, **k)

        def r():
            out = resolve()
            out[3][0][0, 0, 0] = (out[3][0][0, 0, 0] + 1) % 35
            return out
        return r
    monkeypatch.setattr(intra_screen, "screen_frame_async", broken)


def alter_hash(monkeypatch):
    from hevc_tpu_torch.entropy import sei
    plain = sei.picture_md5
    calls = []

    def broken(*a, **k):
        d = plain(*a, **k)
        calls.append(1)
        if len(calls) == 6:          # the first picture after warm-up
            d[0] = bytes([d[0][0] ^ 1]) + d[0][1:]
        return d
    monkeypatch.setattr(sei, "picture_md5", broken)


def alter_recon(monkeypatch):
    from hevc_tpu_torch.encoder.top import EncoderTop
    plain = EncoderTop.pop_recons

    def broken(self):
        out = plain(self)
        for idx, planes in out:
            if idx == 6:
                planes[0] = planes[0].copy()
                planes[0][3, 3] += 1
        return out
    monkeypatch.setattr(EncoderTop, "pop_recons", broken)


def alter_filter(monkeypatch):
    from hevc_tpu_torch.entropy import cabac
    plain = cabac.sao_apply_native

    def broken(*a, **k):
        out = plain(*a, **k)
        out[0][5, 5] = out[0][5, 5] ^ 1
        return out
    monkeypatch.setattr(cabac, "sao_apply_native", broken)


def alter_bits(monkeypatch):
    from hevc_tpu_torch.encoder.top import EncoderTop
    plain = EncoderTop.encode_frame

    def broken(self, planes):
        out = plain(self, planes)
        if len(self.stats) <= 5 or not out:
            return out
        # one bit in the middle of the first slice's data
        start = out.find(b"\x00\x00\x01")
        while start >= 0 and ((out[start + 3] >> 1) & 0x3F) >= 32:
            start = out.find(b"\x00\x00\x01", start + 3)
        end = out.find(b"\x00\x00\x01", start + 3)
        k = (start + 3 + end) // 2
        return out[:k] + bytes([out[k] ^ 0x10]) + out[k + 1:]
    monkeypatch.setattr(EncoderTop, "encode_frame", broken)


def drop_half(monkeypatch):
    from hevc_tpu_torch.encoder.top import EncoderTop
    plain = EncoderTop.encode_frame
    steps = []

    def broken(self, planes):
        out = plain(self, planes)
        if out:
            steps.append(1)
            if len(steps) % 2 == 0:
                return b""
        return out
    monkeypatch.setattr(EncoderTop, "encode_frame", broken)


FAULTS = {"search": alter_search, "screen": alter_screen,
          "hash": alter_hash, "recon": alter_recon, "filter": alter_filter,
          "bits": alter_bits, "half": drop_half}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch, tiny_bench, one_thread):
    cell = ("ra_main10.b1080_pan" if fault == "screen"
            else "ldp_main.b1080_pan")
    FAULTS[fault](monkeypatch)
    assert drive(cell, tiny_bench)["correct"] is False


def test_sound_run_is_correct(tiny_bench, one_thread):
    r = drive("ldp_main.b1080_pan", tiny_bench)
    assert r["correct"] is True
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) == {"kbit_per_frame", "psnr_y_db", "setup_s"}
