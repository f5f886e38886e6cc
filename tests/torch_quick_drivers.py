"""Shared by ``tests/test_torch_drivers_*.py``: run one experiment driver
with ``quick=True`` in both packages on the CPU and hold the port's rows to
the JAX package's, and to the port's committed CPU rows
(``tests/data/torch_quick_cpu/<csv>.csv``, which ``chip_smoke.py`` phase 16
holds the card's rows to).

Tolerances (float64): the key cells equal; ``error`` within 1e-8 relative
plus 1e-12 absolute (the same sketches summed in another order, through
pseudo-inverses and QRs); the TT inner-product error (``fast_error_func``)
within 1e-6 absolute, since it is the square root of a difference that
cancels to rounding noise near exact recovery (1.5e-7 apart measured, some
rows 0.0); the cookie's GMRES residuals within 1e-7 relative, as phase 13
holds eight iterations of the card against the CPU.
"""
import json
from pathlib import Path

import numpy as np
import pandas as pd

ROOT = Path(__file__).resolve().parents[1]
QUICK_DIR = ROOT / "tests" / "data" / "torch_quick_cpu"
CSV_NAMES = {"cp": "cp_tensor"}


def csv_name(driver):
    return CSV_NAMES.get(driver, driver) + ".csv"


def error_tolerance(row):
    """``(rtol, atol)`` of one row's ``error`` (see the module note)."""
    if str(row.get("error_func")) == "fast_error_func":
        return 0.0, 1e-6
    if str(row.get("name")).startswith("GMRES"):
        return 1e-7, 0.0
    return 1e-8, 1e-12


def _list(cell):
    return np.asarray(json.loads(cell), dtype=float)


def assert_rows_match(ours: pd.DataFrame, ref: pd.DataFrame) -> None:
    assert list(ours.columns) == list(ref.columns)
    assert len(ours) == len(ref)
    keys = [c for c in ref.columns if c not in ("error", "time_taken")
            and not c.startswith(("final_true_error", "final_round_time"))]
    pd.testing.assert_frame_equal(ours[keys], ref[keys])
    for (_, a), (_, b) in zip(ours.iterrows(), ref.iterrows()):
        rtol, atol = error_tolerance(b)
        assert abs(a["error"] - b["error"]) <= rtol * abs(b["error"]) + atol, (
            dict(b), a["error"])
        for c in ref.columns:
            if c.startswith("final_true_error"):
                x, y = _list(a[c]), _list(b[c])
                assert np.all(np.abs(x - y) <= 1e-7 * np.abs(y)), c


def run_both(driver, tmp_path, **kwargs):
    """The driver's CSV from each package (quick, no progress bar)."""
    from tt_sketch_torch.experiments.drivers import DRIVERS
    from tt_sketch_tpu.experiments.drivers import DRIVERS as JDRIVERS

    frames = []
    for tag, drivers in (("ours", DRIVERS), ("ref", JDRIVERS)):
        out = tmp_path / tag
        exp = drivers[driver](out=str(out), quick=True, progress=False,
                              **kwargs)
        assert len(exp.data) > 0
        frames.append(pd.read_csv(out / csv_name(driver),
                                  float_precision="round_trip"))
    return frames


def check_driver(driver, tmp_path):
    ours, ref = run_both(driver, tmp_path)
    assert_rows_match(ours, ref)
    committed = pd.read_csv(QUICK_DIR / csv_name(driver),
                            float_precision="round_trip")
    assert_rows_match(ours, committed)
