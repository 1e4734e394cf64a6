"""Each roofline's operation and byte count against a hand count at a
small shape."""
import pytest

from benchmark.harness import roofline


CTX = {"ctu": 64, "search_range": 4, "width": 96, "height": 64}


def test_grids():
    g = roofline.search_grids(CTX)
    # 32x32 blocks: (64 - 32) // 32 + 1 = 2 rows, (96 - 32) // 32 + 1 = 3
    assert g[32] == (4, 2, 3)
    # 16x16 blocks at min(4, 16) = 4: 4 rows, 6 columns
    assert g[16] == (4, 4, 6)


def test_ssd_table_counts_by_hand():
    nbytes, ops = roofline.ssd_cost(CTX, 32, deep=False)
    # 6 blocks, 9 x 9 offsets, 32 x 32 multiply-adds of 2 operations each
    assert ops == 2 * 6 * 81 * 1024
    # roi (2-1)*32+40 = 72 rows, (3-1)*32+40 = 104 columns of one byte,
    # 6 blocks of 1024 bytes, a table of 6 * 81 int32
    assert nbytes == 72 * 104 + 6 * 1024 + 6 * 81 * 4


def test_ssd_table_deep_counts_three_products_of_two_byte_samples():
    nbytes, ops = roofline.ssd_cost(CTX, 16, deep=True)
    # 24 blocks, 9 x 9 offsets, 16 x 16, three int8 products
    assert ops == 3 * 2 * 24 * 81 * 256
    # roi (4-1)*16+24 = 72 by (6-1)*16+24 = 104, two bytes a sample
    assert nbytes == 72 * 104 * 2 + 24 * 256 * 2 + 24 * 81 * 4


def test_argmin_counts_by_hand():
    nbytes, ops = roofline.argmin_cost(CTX, 32)
    assert ops == 16 * 6 * 81
    assert nbytes == 6 * 81 * 4 + 81 * 4 + 6 * 4


def test_bound_and_share():
    b = roofline.bound_s(3.35e12, 0.0, roofline.INT8_TC_OPS)
    assert b == pytest.approx(1.0)
    b = roofline.bound_s(0.0, 1979e12, roofline.INT8_TC_OPS)
    assert b == pytest.approx(1.0)
    assert roofline.share(0.5, 1.0) == pytest.approx(50.0)
    assert roofline.share(0.5, 0.0) is None
