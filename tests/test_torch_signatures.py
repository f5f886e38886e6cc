"""Calls written for the JAX package work in the port: ``load_frostt``'s
``download=``, ``SparseTensor.astype``'s ``index_dtype=`` and
``slab_stream_sketch``'s positional ``dtype``, each called as the JAX
package's experiment drivers and dense engine write it
(``tt_sketch_tpu/experiments/drivers.py:467`` and ``:482``,
``tt_sketch_tpu/kernels/dense_engine.py:320``), against the JAX package.

Tolerances: float64 sketches atol 1e-11 (sums in another order, as
``tests/test_torch_dense_engine.py``); loaded data and cast entries exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_sketch_torch import config
from tt_sketch_torch.data.frostt import load_frostt
from tt_sketch_torch.drm import TensorTrainDRM
from tt_sketch_torch.kernels.dense_engine import slab_stream_sketch
from tt_sketch_tpu.data.frostt import load_frostt as j_load_frostt
from tt_sketch_tpu.drm import TensorTrainDRM as JDRM
from tt_sketch_tpu.kernels.dense_engine import (
    slab_stream_sketch as j_slab_stream_sketch,
)

SHAPE = (11, 9, 30, 25)


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


@pytest.fixture
def cache_dir(tmp_path):
    rng = np.random.default_rng(3)
    idx = np.stack([rng.integers(0, s, 700) for s in SHAPE]).astype(np.int64)
    np.savez(tmp_path / "uber-synthetic.npz", indices=idx,
             entries=rng.standard_normal(700), shape=np.asarray(SHAPE),
             synth_version=np.asarray(2))
    return tmp_path


def test_load_frostt_takes_download(cache_dir):
    # drivers.py:467, with the JAX dtype of its f32 run
    ours = load_frostt("uber-synthetic", cache_dir=cache_dir, download=False,
                       psi_plan=True, plan_kwargs=dict(threshold=16))
    ref = j_load_frostt("uber-synthetic", cache_dir=cache_dir,
                        download=False, psi_plan=True,
                        plan_kwargs=dict(threshold=16))
    np.testing.assert_array_equal(ours.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(ours.entries.numpy(),
                                  np.asarray(ref.entries))
    assert ([p is None for p in ours.psi_plan]
            == [p is None for p in ref.psi_plan] == [True, True, False,
                                                     False])
    # the JAX package's positional order: name, cache_dir, download
    assert load_frostt("uber-synthetic", cache_dir, False).nnz == 700


@pytest.mark.parametrize("download", [False, True])
def test_missing_file_raises_whatever_download_says(tmp_path, download):
    with pytest.raises(FileNotFoundError) as err:
        load_frostt("uber-synthetic", cache_dir=tmp_path, download=download)
    assert ("no downloader" in str(err.value)) == download


def test_astype_takes_index_dtype(cache_dir):
    # drivers.py:482 passes the JAX package's int32; the port's indices
    # stay int64
    t = load_frostt("uber-synthetic", cache_dir=cache_dir, psi_plan=True,
                    plan_kwargs=dict(threshold=16))
    ours = t.astype(torch.float32, index_dtype=torch.int32)
    ref = j_load_frostt("uber-synthetic", cache_dir=cache_dir,
                        download=False, psi_plan=True,
                        plan_kwargs=dict(threshold=16)
                        ).astype(jnp.float32, index_dtype=jnp.int32)
    assert ours.indices.dtype == torch.int64
    np.testing.assert_array_equal(ours.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(ours.entries.numpy(),
                                  np.asarray(ref.entries))
    for p, q in zip(ours.psi_plan, ref.psi_plan):
        if p is not None:
            np.testing.assert_array_equal(p.sorted_entries.numpy(),
                                          np.asarray(q.sorted_entries))


def test_slab_stream_sketch_takes_dtype_positionally():
    shape = (8, 5, 6, 7)
    X = np.random.default_rng(0).standard_normal(shape)
    ld = TensorTrainDRM(3, shape=shape, transpose=False, seed=1)
    rd = TensorTrainDRM(6, shape=shape, transpose=True, seed=2)
    jld = JDRM(3, shape=shape, transpose=False, seed=1)
    jrd = JDRM(6, shape=shape, transpose=True, seed=2)
    Xt = torch.from_numpy(X)
    # the JAX package's positional call: (slab_fn, n_slabs, shape,
    # left_cores, right_cores, dtype, engine)
    ours = slab_stream_sketch(lambda i: Xt[2 * i: 2 * i + 2], 4, shape,
                              ld.cores, rd.cores, torch.float64, "bisect")
    ref = j_slab_stream_sketch(lambda i: jnp.asarray(X[2 * i: 2 * i + 2]),
                               4, shape, jld.cores, jrd.cores, jnp.float64,
                               "bisect")
    for a, b in zip(ours.Psi_cores + ours.Omega_mats,
                    list(ref.Psi_cores) + list(ref.Omega_mats)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-11)
