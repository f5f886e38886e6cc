"""The CP sweep and the right-oversampling sweep with ``quick=True``: the
port's rows against the JAX package's and against its committed CPU rows
(``torch_quick_drivers`` says how close).  One file per group of drivers, so
that the JAX package's compiles spread over the test workers."""
import pytest

from tt_sketch_torch import config
from torch_quick_drivers import check_driver


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


@pytest.mark.parametrize("driver", ["cp", "right_oversampling"])
def test_quick_driver_equals_jax(driver, tmp_path):
    check_driver(driver, tmp_path)
