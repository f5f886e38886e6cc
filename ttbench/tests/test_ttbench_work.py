"""The work counts of ``ttbench/work`` against counts made by hand at
small shapes, and the roofline shares that follow from them."""
import math
from types import SimpleNamespace

import pytest

from ttbench import harness
from ttbench.metrics import roofline
from ttbench.trace import TraceSummary
from ttbench.work import counts


def test_dense_stream_by_hand():
    # shape (4, 3, 2), ranks 2 / 3: X 24 floats; left DRM cores
    # (1,4,2) (2,3,2) = 8 + 12, right cores over (2, 3, 4): (1,2,3)
    # (3,3,3) = 6 + 27; Psi (1,4,3) (2,3,3) (2,2,1) = 12 + 18 + 4, Omega
    # (2,3) x 2 = 12; TT (1,4,2) (2,3,2) (2,2,1) = 8 + 12 + 4.
    w = counts.dense_stream((4, 3, 2), 2, 3)
    assert w["bytes"] == 4 * (24 + 20 + 33 + 34 + 12 + 24)
    assert w["flops"] == 2 * 24 * (2 + 3)


def test_sparse_stta_by_hand():
    # shape (5, 4, 6), 10 nonzeros, int64 indices, float32 values, ranks
    # 2 / 3: Psi products 1*3 + 2*3 + 2*1, Omega 2*3 + 2*3 a nonzero.
    w = counts.sparse_stta((5, 4, 6), 10, 8, 4, 2, 3)
    psi, omega = 3 + 6 + 2, 6 + 6
    out = (1 * 5 * 3 + 2 * 4 * 3 + 2 * 6 * 1) + 12 + (5 * 2 + 2 * 4 * 2
                                                      + 2 * 6)
    assert w["flops"] == 2 * 10 * (psi + omega)
    assert w["bytes"] == 10 * (3 * 8 + 4) + 4 * out


def test_sparse_stta_trims_the_left_ranks():
    # ranks above what the shape holds: left rank 9 on (2, 3, 4) trims to
    # (2, 4)
    w = counts.sparse_stta((2, 3, 4), 1, 8, 4, 9, 10)
    assert w["flops"] == 2 * ((1 * 10 + 2 * 10 + 4 * 1) + (2 * 10 + 4 * 10))


def test_sparse_hmt_by_hand():
    # shape (5, 4, 6), rank 2: Psi 1*2 + 2*2 + 2*1, one chain step 2*2;
    # QRs of (5, 2) and (8, 2).
    w = counts.sparse_hmt((5, 4, 6), 10, 8, 4, 2)
    qr = (2 * 5 * 4 - 16 / 3) + (2 * 8 * 4 - 16 / 3)
    assert math.isclose(w["flops"], 2 * 10 * (2 + 4 + 2 + 4) + qr)
    assert w["bytes"] == 10 * (3 * 8 + 4) + 4 * (10 + 16 + 12)


@pytest.mark.parametrize("cell", ["dense-1e10.stream", "frostt-uber.stta",
                                  "frostt-uber.hmt",
                                  "frostt-uber.stta-sign"])
def test_cells_have_counts_and_a_share_of_at_most_100(cell):
    c = harness.Cell(harness.load_json(harness.HERE.parent /
                                       "BENCHMARK.json"), cell)
    work = c.method.work(c.config, c.traffic)
    assert work["bytes"] > 0 and work["flops"] > 0
    least = roofline.least_s(work)
    # a device busy for exactly the least time reads 100 %
    run = SimpleNamespace(work=work, trace=TraceSummary(
        n_requests=3, window_s=1.0, busy_s=3 * least, device_events=9))
    assert math.isclose(roofline.share(run), 100.0)


def test_coo_bytes_follow_the_configuration():
    config = {"shape": [5, 4, 6], "nnz": 10, "dtype": "float32",
              "index_dtype": "int64"}
    assert counts.coo(config) == ([5, 4, 6], 10, 8, 4)
    config.update(dtype="float64", index_dtype="int32")
    assert counts.coo(config)[2:] == (4, 8)


def test_main_shapes():
    w = counts.dense_stream((4864, 128, 128, 128), 32, 64)
    # 40.8 GB read at 3.35 TB/s bounds the stream: 12.2 ms
    assert 0.0121 < roofline.least_s(w) < 0.0123
    w = counts.sparse_stta((183, 24, 1140, 1717), 3309696, 8, 4, 20, 40)
    # 4060 multiply-adds a nonzero: flops bound the sketch, 54 us
    assert w["flops"] == 2 * 3309696 * 4060
