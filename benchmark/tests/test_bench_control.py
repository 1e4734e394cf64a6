"""The comparison separates the program from its control: on a CPU run of
each configuration at a tiny size, the program reads 0 on every number
and the control (the reference at the nearest lower sample precision in
the program's place) fails them. The card test runs the same at the
cells' own sizes."""
import pytest

from conftest import tiny_cell

from benchmark import control


@pytest.mark.parametrize("cell", ["ldp_main.b1080_pan",
                                  "ra_main10.b1080_pan"])
def test_control_fails_where_the_program_passes(cell, tiny_bench,
                                                one_thread):
    r = control.readings(tiny_cell(cell), 2 ** 31 + 77, 0.5, device="cpu",
                         bench_dir=tiny_bench,
                         overrides={"range_pictures": 4})
    assert r["program"] == {"hash_mismatch": 0, "decode_mismatch": 0,
                            "search_mismatch": 0, "screen_mismatch": 0}, r
    assert all(v > 0 for v in r["control"].values()), r


def test_control_fails_all_intra_where_the_program_passes(tiny_intra,
                                                          one_thread):
    """The same for a configuration that only the copy knows, all-intra
    (every picture an IDR with POC 0): it has no searches, so the
    control fails every other number."""
    bench_dir, cell = tiny_intra
    r = control.readings(cell, 2 ** 31 + 77, 0.5, device="cpu",
                         bench_dir=bench_dir,
                         overrides={"range_pictures": 4})
    assert r["program"] == {"hash_mismatch": 0, "decode_mismatch": 0,
                            "search_mismatch": 0, "screen_mismatch": 0}, r
    assert r["control"]["search_mismatch"] == 0, r
    assert all(v > 0 for k, v in r["control"].items()
               if k != "search_mismatch"), r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ldp_main.b1080_pan",
                                  "ra_main10.b1080_pan",
                                  "ldp_main.e720_static"])
def test_control_fails_at_cell_size(cell, card):
    from benchmark.harness import spec
    c = spec.cell(spec.benchmark(), cell)
    for seed in (101, 102, 103):
        r = control.readings(c, seed, 3.0)
        assert all(v == 0 for v in r["program"].values()), r
        assert any(v > 0 for v in r["control"].values()), r
