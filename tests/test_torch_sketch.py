"""stream_sketch / SketchedTensorTrain / assemble_sketched_tt of the port
against the JAX package (mirrors the STTA parts of tests/test_sketching.py).

Tolerances: float64 Ψ/Ω and recovered cores to 1e-12; exact recovery of a
low-rank tensor to 1e-9 relative error; seeds exact.
"""
import numpy as np
import pytest
import torch

import tt_sketch_tpu as jts
from tt_sketch_torch import config
from tt_sketch_torch.engine.dispatch import SketchMethod, general_sketch
from tt_sketch_torch.engine.sketch import (
    SketchedTensorTrain,
    _derive_right_seed,
    assemble_sketched_tt,
    stream_sketch,
)
from tt_sketch_torch.formats import DenseTensor, TensorTrain
from tt_sketch_torch.interop import container_from_numpy
from tt_sketch_tpu.engine.sketch import _derive_right_seed as j_derive

SHAPE = (8, 5, 6, 7)


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _tensors(fmt, seed=0, rank=3):
    tt = TensorTrain.random(SHAPE, rank, seed=seed)
    jtt = jts.TensorTrain.random(SHAPE, rank, seed=seed)
    if fmt == "tt":
        return tt, jtt
    return DenseTensor(tt.to_dense()), jts.DenseTensor(jtt.to_dense())


def _close(ours, ref, atol=1e-12):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)


@pytest.mark.parametrize("fmt", ["dense", "tt"])
@pytest.mark.parametrize("ranks", [(4, 7), (7, 4)])
def test_stream_sketch_matches_jax(fmt, ranks):
    X, jX = _tensors(fmt)
    sk = stream_sketch(X, *ranks, seed=5)
    jsk = jts.stream_sketch(jX, *ranks, seed=5)
    assert sk.left_rank == jsk.left_rank and sk.right_rank == jsk.right_rank
    _close(sk.Psi_cores, jsk.Psi_cores)
    _close(sk.Omega_mats, jsk.Omega_mats)
    _close(sk.to_tt().cores, jsk.to_tt().cores)
    assert sk.to_tt().error(X, relative=True) < 1e-9


@pytest.mark.parametrize("fmt", ["dense", "tt"])
def test_linearity_of_add(fmt):
    X, _ = _tensors(fmt, seed=0)
    Y, _ = _tensors(fmt, seed=1, rank=1)
    summed = stream_sketch(X, 4, 7, seed=3) + Y
    if fmt == "dense":
        both = DenseTensor(X.data + Y.data)
    else:
        both = X.add(Y)
    direct = stream_sketch(both, 4, 7, seed=3)
    _close(summed.Psi_cores, [p.numpy() for p in direct.Psi_cores], atol=1e-12)
    _close(summed.Omega_mats, [o.numpy() for o in direct.Omega_mats],
           atol=1e-12)
    assert summed.to_tt().error(both, relative=True) < 1e-9


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**32 - 1])
@pytest.mark.parametrize("d", [2, 4, 11])
def test_derive_right_seed_equal(seed, d):
    assert _derive_right_seed(seed, d) == j_derive(seed, d)


@pytest.mark.parametrize("direction", ["right", "left"])
def test_assemble_from_jax_sketch(direction):
    _, jX = _tensors("dense")
    jsk = jts.stream_sketch(jX, 4, 7, seed=8)
    cont = container_from_numpy(
        [np.asarray(p) for p in jsk.Psi_cores],
        [np.asarray(o) for o in jsk.Omega_mats],
    )
    ours = assemble_sketched_tt(cont, direction=direction)
    ref = jts.assemble_sketched_tt(jsk.sketch_, direction=direction)
    _close(ours, ref)
    with pytest.raises(ValueError, match="direction"):
        assemble_sketched_tt(cont, direction="up")


def test_sketched_tt_algebra():
    X, jX = _tensors("tt")
    sk = stream_sketch(X, 4, 7, seed=2)
    jsk = jts.stream_sketch(jX, 4, 7, seed=2)
    _close((sk * 3.0).Psi_cores, (jsk * 3.0).Psi_cores)
    _close(sk.T.Psi_cores, jsk.T.Psi_cores)
    _close(sk.C_cores("left"), jsk.C_cores("left"))
    assert sk.size == jsk.size
    assert abs(sk.dot(X) - jsk.dot(jX)) < 1e-12
    assert sk.T.left_rank == jsk.T.left_rank
    np.testing.assert_allclose(sk.to_dense().numpy(), np.asarray(jsk.to_dense()),
                               atol=1e-12)


def test_return_drm_and_given_drms():
    X, _ = _tensors("dense")
    sk, ld, rd = stream_sketch(X, 4, 7, seed=1, return_drm=True)
    again = stream_sketch(X, 4, 7, left_drm=ld, right_drm=rd)
    _close(again.Psi_cores, [p.numpy() for p in sk.Psi_cores])
    with pytest.raises(ValueError, match="does not match"):
        stream_sketch(X, 3, 7, left_drm=ld, right_drm=rd)
    with pytest.raises(ValueError, match="consistently"):
        stream_sketch(X, (4, 8, 4), (7, 7, 7), seed=1)


def test_placement_mismatch_raises():
    X, _ = _tensors("dense")
    with pytest.raises(ValueError, match="dtype"):
        stream_sketch(X, 4, 7, seed=1, dtype=torch.float32)
    # the orthogonal method is ported (tests/test_torch_sequential.py): the
    # same placement check guards it
    sk, ld, rd = stream_sketch(X, 4, 7, seed=1, return_drm=True)
    assert len(general_sketch(X, ld, rd, SketchMethod.orthogonal).Psi_cores) \
        == len(SHAPE)
    with pytest.raises(ValueError, match="dtype"):
        general_sketch(DenseTensor(X.data.float()), ld, rd,
                       SketchMethod.orthogonal)


def test_no_card_means_an_error_not_the_cpu(monkeypatch):
    # the package default stays "cuda": with no card, entry points raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config.set_default_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TensorTrain.random(SHAPE, 3, seed=0)
    X = DenseTensor(torch.zeros(SHAPE, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_sketch(X, 4, 7, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        DenseTensor.random(SHAPE, seed=0)
    # an explicit CPU request still works
    assert TensorTrain.random(SHAPE, 3, seed=0, device="cpu").device.type == "cpu"


def test_sketched_tt_is_a_tensor():
    X, _ = _tensors("dense")
    sk = stream_sketch(X, 4, 7, seed=4)
    assert isinstance(sk, SketchedTensorTrain)
    assert "Sketched tensor train" in repr(sk)
    assert sk.error(X, relative=True) < 1e-9
