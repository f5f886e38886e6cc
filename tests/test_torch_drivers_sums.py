"""The TT-sum, TT + sparse, timings and Gaussian order-scaling sweeps with
``quick=True``: the port's rows against the JAX package's and against its
committed CPU rows (``torch_quick_drivers`` says how close).  One file per
group of drivers, so that the JAX package's compiles spread over the test
workers."""
import pytest

from tt_sketch_torch import config
from torch_quick_drivers import check_driver


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


@pytest.mark.parametrize("driver", ["tt_sum", "tt_plus_sparse", "timings",
                                    "timings_vs_error",
                                    "dimension_scaling_gaussian"])
def test_quick_driver_equals_jax(driver, tmp_path):
    check_driver(driver, tmp_path)


def test_quick_frostt_driver_equals_jax(tmp_path):
    """``run_frostt`` with a tiny ``uber.tns.gz`` in its cache (as
    ``tests/test_experiments.py`` drops one): ``nips`` is skipped, uber's
    rank-5 STTA and HMT rows (float64, Gaussian DRMs) equal the JAX
    package's."""
    import gzip

    import numpy as np

    from torch_quick_drivers import assert_rows_match, run_both

    rng = np.random.default_rng(0)
    shape = (183, 24, 1140, 1717)
    inds = np.stack([rng.integers(0, s, 500) for s in shape])
    vals = rng.normal(size=500)
    cache = tmp_path / "cache"
    cache.mkdir()
    with gzip.open(cache / "uber.tns.gz", "wt") as fh:
        fh.writelines(" ".join(str(i + 1) for i in inds[:, k])
                      + f" {float(vals[k])!r}\n" for k in range(500))
    ours, ref = run_both("frostt", tmp_path, names=["uber", "nips"],
                         cache_dir=str(cache))
    assert list(ours["dataset"]) == ["uber", "uber"]
    assert list(ours["name"]) == ["STTA", "HMT"]
    assert_rows_match(ours, ref)
