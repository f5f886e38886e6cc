"""Checkpoints and streaming sessions of ``tt_sketch_torch``
(``serialization.py``, ``streaming.py``) on the CPU, within the port and
across packages: a checkpoint written by either package loads in the
other, and a session checkpointed by the JAX package resumes in the port.

Sparse inputs are made from seeds with numpy and built in both packages.
Tolerances, with their reasons:

- arrays through a checkpoint, TT-DRM cores regenerated from metadata, a
  resumed stream against an uninterrupted one in the same package: exact;
- a stream continued in the other package: 1e-12 relative (float64 sums
  in another order; the float64 hash DRMs' ``ndtri`` differs between the
  packages in the last bit);
- recovered tensors: 1e-10 relative (pseudo-inverses in another library).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_sketch_torch import config, serialization as ser, stream_sketch
from tt_sketch_torch.drm import (
    SparseGaussianDRM,
    SparseSignDRM,
    TensorTrainDRM,
)
from tt_sketch_torch.formats import SparseTensor, TensorTrain
from tt_sketch_torch.streaming import StreamingSketchSession
from tt_sketch_tpu import serialization as jser
from tt_sketch_tpu import stream_sketch as jstream_sketch
from tt_sketch_tpu.drm import SparseGaussianDRM as JGauss
from tt_sketch_tpu.drm import SparseSignDRM as JSign
from tt_sketch_tpu.formats import SparseTensor as JSparse
from tt_sketch_tpu.formats import TensorTrain as JTrain
from tt_sketch_tpu.streaming import StreamingSketchSession as JSession

SHAPE = (6, 7, 8, 5)
CROSS_TOL = 1e-12
REC_TOL = 1e-10
DRM_TYPES = {"tt": (TensorTrainDRM, None), "gauss": (SparseGaussianDRM,
                                                      JGauss),
             "sign": (SparseSignDRM, JSign)}


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _coo(seed, shape=SHAPE, nnz=60):
    rng = np.random.default_rng(seed)
    flat = rng.choice(int(np.prod(shape)), size=nnz, replace=False)
    return np.stack(np.unravel_index(flat, shape)), rng.standard_normal(nnz)


def _pair(seed, shape=SHAPE, nnz=60):
    """The same sparse tensor in the port and in the JAX package."""
    idx, ent = _coo(seed, shape, nnz)
    return SparseTensor(shape, idx, ent), JSparse(shape, idx, ent)


def _parts(sk):
    return list(sk.sketch_.Psi_cores) + list(sk.sketch_.Omega_mats)


def _assert_parts_equal(a, b):
    for x, y in zip(_parts(a), _parts(b), strict=True):
        assert torch.equal(x, y)


def _assert_parts_close(ours, ref, tol=CROSS_TOL):
    for x, y in zip(_parts(ours), _parts(ref), strict=True):
        y = np.asarray(y)
        assert x.shape == y.shape
        scale = max(np.linalg.norm(y), 1e-300)
        assert np.linalg.norm(x.numpy() - y) / scale <= tol


def _dense_rel(tt, ref):
    a, b = tt.to_dense().numpy(), np.asarray(ref.to_dense())
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- within the port ---------------------------------------------------------

def test_tt_roundtrip(tmp_path):
    tt = TensorTrain.random(SHAPE, rank=3, seed=0)
    ser.save_tt(tmp_path / "tt.npz", tt)
    again = ser.load_tt(tmp_path / "tt.npz")
    assert all(torch.equal(a, b) for a, b in zip(tt.cores, again.cores))
    assert ser.load_tt(tmp_path / "tt.npz", device="cpu").device.type == "cpu"


@pytest.mark.parametrize("drm", sorted(DRM_TYPES))
def test_sketch_roundtrip_and_resume(tmp_path, drm):
    """A loaded sketch continues the stream exactly as the saved one."""
    drm_type = DRM_TYPES[drm][0]
    (A, _), (B, _) = _pair(1), _pair(2)
    kw = dict(seed=42, left_drm_type=drm_type, right_drm_type=drm_type)
    part = stream_sketch(A, 4, 8, **kw)
    ser.save_sketch(tmp_path / "s.npz", part)
    assert not (tmp_path / "s.npz.tmp").exists()
    loaded = ser.load_sketch(tmp_path / "s.npz")
    _assert_parts_equal(loaded, part)
    for mine, theirs in ((loaded.left_drm, part.left_drm),
                         (loaded.right_drm, part.right_drm)):
        assert type(mine) is type(theirs)
        for key in ("rank", "true_rank", "rank_min", "rank_max", "shape",
                    "transpose", "seed", "dtype", "device"):
            assert getattr(mine, key) == getattr(theirs, key), key
    _assert_parts_equal(loaded + B, part + B)
    full = stream_sketch(A + B, 4, 8, **kw)
    err = (loaded + B).to_tt().error(full.to_tt(), relative=True)
    assert err < REC_TOL


def test_sparse_sign_nnz_restored_verbatim(tmp_path):
    A, _ = _pair(3)
    ldrm = SparseSignDRM(4, SHAPE, False, seed=7,
                         num_non_zero_per_row=(2, 3, 1))
    rdrm = SparseSignDRM(8, SHAPE, True, seed=8,
                         num_non_zero_per_row=(5, 2, 4))
    sk = stream_sketch(A, 4, 8, left_drm=ldrm, right_drm=rdrm)
    ser.save_sketch(tmp_path / "s.npz", sk)
    loaded = ser.load_sketch(tmp_path / "s.npz")
    assert loaded.left_drm.nnz == (2, 3, 1)
    assert loaded.right_drm.nnz == (5, 2, 4)
    B, _ = _pair(4)
    _assert_parts_equal(loaded + B, sk + B)


def test_rank_increase_after_load(tmp_path):
    A, _ = _pair(5)
    sk = stream_sketch(A, 3, 6, seed=9, left_drm_type=SparseGaussianDRM,
                       right_drm_type=SparseGaussianDRM)
    ser.save_sketch(tmp_path / "g.npz", sk)
    grown = ser.load_sketch(tmp_path / "g.npz").increase_rank(A, 5, 10)
    _assert_parts_equal(grown, sk.increase_rank(A, 5, 10))


def test_wrong_kind_and_newer_version_errors(tmp_path):
    ser.save_tt(tmp_path / "x.npz", TensorTrain.random(SHAPE, 2, seed=1))
    with pytest.raises(ValueError, match="not a sketch checkpoint"):
        ser.load_sketch(tmp_path / "x.npz")
    A, _ = _pair(6)
    ser.save_sketch(tmp_path / "s.npz", stream_sketch(A, 3, 6, seed=1))
    with pytest.raises(ValueError, match="not a TT checkpoint"):
        ser.load_tt(tmp_path / "s.npz")
    with np.load(tmp_path / "s.npz") as data:
        arrays = dict(data)
    meta = json.loads(bytes(arrays["meta"]).decode())
    meta["version"] = 2
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(tmp_path / "v2.npz", **arrays)
    with pytest.raises(ValueError, match="newer than this library"):
        ser.load_sketch(tmp_path / "v2.npz")
    with pytest.raises(ValueError, match="newer than this library"):
        jser.load_sketch(tmp_path / "v2.npz")


def test_failed_write_keeps_the_last_checkpoint(tmp_path, monkeypatch):
    (A, _), (B, _) = _pair(7), _pair(8)
    path = tmp_path / "s.npz"
    first = stream_sketch(A, 3, 6, seed=2)
    ser.save_sketch(path, first)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ser.np, "savez", broken)
    with pytest.raises(OSError):
        ser.save_sketch(path, first + B)
    monkeypatch.undo()
    _assert_parts_equal(ser.load_sketch(path), first)


def test_no_card_means_an_error_for_checkpoints_and_sessions(
        tmp_path, monkeypatch):
    A, _ = _pair(9)
    ser.save_sketch(tmp_path / "s.npz", stream_sketch(A, 3, 6, seed=1))
    session = StreamingSketchSession(SHAPE, 3, 6, seed=1,
                                     checkpoint_path=tmp_path / "c.npz")
    session.consume(A)
    ser.save_tt(tmp_path / "t.npz", TensorTrain.random(SHAPE, 2, seed=1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config.set_default_device("cuda")
    for run in (lambda: ser.load_sketch(tmp_path / "s.npz"),
                lambda: ser.load_tt(tmp_path / "t.npz"),
                lambda: StreamingSketchSession(SHAPE, 3, 6, seed=1),
                lambda: StreamingSketchSession.resume(tmp_path / "c.npz")):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()
    cpu = StreamingSketchSession.resume(tmp_path / "c.npz", device="cpu")
    assert cpu.n_consumed == 1
    assert cpu.result().Psi_cores[0].device.type == "cpu"
    assert ser.load_sketch(tmp_path / "s.npz",
                           device="cpu").left_drm.device.type == "cpu"


# -- across packages -----------------------------------------------------------

@pytest.mark.parametrize("drm", sorted(DRM_TYPES))
def test_jax_checkpoint_loads_in_the_port(tmp_path, drm):
    mine, theirs = DRM_TYPES[drm]
    (A, jA), (B, jB) = _pair(11), _pair(12)
    kw = {} if theirs is None else dict(left_drm_type=theirs,
                                        right_drm_type=theirs)
    jsk = jstream_sketch(jA, 4, 8, seed=5, **kw)
    jser.save_sketch(tmp_path / "j.npz", jsk)
    sk = ser.load_sketch(tmp_path / "j.npz")
    for x, y in zip(_parts(sk), _parts(jsk), strict=True):
        assert np.array_equal(x.numpy(), np.asarray(y))
    assert type(sk.left_drm) is mine and type(sk.right_drm) is mine
    assert sk.left_drm.dtype == sk.right_drm.dtype == torch.float64
    if drm == "tt":
        for ours, ref in ((sk.left_drm, jsk.left_drm),
                          (sk.right_drm, jsk.right_drm)):
            for a, b in zip(ours.cores, ref.cores, strict=True):
                assert np.array_equal(a.numpy(), np.asarray(b))
    if drm == "sign":
        assert sk.left_drm.nnz == tuple(jsk.left_drm.nnz)
    # the regenerated DRMs go on with the JAX package's rows
    _assert_parts_close(sk + B, jsk + jB)
    # and sketch what the port's own DRMs of the same seed sketch
    mine_kw = {} if theirs is None else dict(left_drm_type=mine,
                                             right_drm_type=mine)
    _assert_parts_equal(
        stream_sketch(B, 4, 8, left_drm=sk.left_drm, right_drm=sk.right_drm),
        stream_sketch(B, 4, 8, seed=5, **mine_kw))


@pytest.mark.parametrize("drm", sorted(DRM_TYPES))
def test_port_checkpoint_loads_in_jax(tmp_path, drm):
    mine, theirs = DRM_TYPES[drm]
    (A, _), (B, jB) = _pair(13), _pair(14)
    kw = {} if theirs is None else dict(left_drm_type=mine,
                                        right_drm_type=mine)
    sk = stream_sketch(A, 4, 8, seed=6, **kw)
    ser.save_sketch(tmp_path / "t.npz", sk)
    jsk = jser.load_sketch(tmp_path / "t.npz")
    for x, y in zip(_parts(sk), _parts(jsk), strict=True):
        assert np.array_equal(x.numpy(), np.asarray(y))
    assert type(jsk.left_drm).__name__ == mine.__name__
    assert jsk.left_drm.dtype == jnp.float64
    if drm == "tt":
        for a, b in zip(sk.right_drm.cores, jsk.right_drm.cores,
                        strict=True):
            assert np.array_equal(a.numpy(), np.asarray(b))
    _assert_parts_close(sk + B, jsk + jB)


def test_port_tt_loads_in_jax_and_back(tmp_path):
    tt = TensorTrain.random(SHAPE, 3, seed=4)
    ser.save_tt(tmp_path / "a.npz", tt)
    jt = jser.load_tt(tmp_path / "a.npz")
    assert all(np.array_equal(a.numpy(), np.asarray(b))
               for a, b in zip(tt.cores, jt.cores))
    jser.save_tt(tmp_path / "b.npz", JTrain.random(SHAPE, 3, seed=4))
    back = ser.load_tt(tmp_path / "b.npz")
    assert all(torch.equal(a, b) for a, b in zip(tt.cores, back.cores))


# -- streaming sessions ------------------------------------------------------------

SESSION_SHAPE = (8, 9, 10, 7)


def _session_pieces():
    """``tests/test_serialization.py``'s stream: 400 nnz in 5 pieces, in
    both packages."""
    rng = np.random.default_rng(0)
    nnz = 400
    idx = np.stack([rng.integers(0, s, nnz) for s in SESSION_SHAPE])
    ent = rng.standard_normal(nnz)
    X = SparseTensor(SESSION_SHAPE, idx, ent)
    jX = JSparse(SESSION_SHAPE, idx, ent)
    return X, X.split(5).tensors, jX, jX.split(5).tensors


@pytest.mark.parametrize("drm", ["tt", "gauss"])
def test_session_crash_resume(tmp_path, drm):
    """Resume from a checkpoint == the uninterrupted run, bit for bit."""
    drm_type = DRM_TYPES[drm][0]
    kw = dict(left_drm_type=drm_type, right_drm_type=drm_type)
    X, pieces, _, _ = _session_pieces()
    s1 = StreamingSketchSession(SESSION_SHAPE, 6, 12, seed=3, **kw)
    for p in pieces:
        s1.consume(p)
    ck = tmp_path / "stream.npz"
    s2 = StreamingSketchSession(SESSION_SHAPE, 6, 12, seed=3,
                                checkpoint_path=ck, checkpoint_every=2, **kw)
    for p in pieces[:3]:
        s2.consume(p)
    del s2  # a crash after piece 3: the checkpoint after 2 survives
    s3 = StreamingSketchSession.resume(ck)
    assert s3.n_consumed == 2 and s3.checkpoint_every == 1
    for p in pieces[s3.n_consumed:]:
        s3.consume(p)
    _assert_parts_equal(s3.result(), s1.result())
    tt1, tt3 = s1.result().to_tt(), s3.result().to_tt()
    assert all(torch.equal(a, b) for a, b in zip(tt1.cores, tt3.cores))
    # and the session equals sketching the whole tensor at once
    whole = stream_sketch(X, 6, 12, seed=3, **kw).to_tt()
    assert tt1.error(whole, relative=True) < REC_TOL


def test_session_errors(tmp_path):
    X, pieces, _, _ = _session_pieces()
    s = StreamingSketchSession(SESSION_SHAPE, 6, 12, seed=3)
    with pytest.raises(ValueError, match="nothing consumed"):
        s.result()
    with pytest.raises(ValueError, match="no checkpoint_path"):
        s.checkpoint()
    with pytest.raises(ValueError, match="piece shape"):
        s.consume(SparseTensor((8, 9, 10, 6), np.zeros((4, 1), np.int64),
                               np.ones(1)))
    ser.save_sketch(tmp_path / "plain.npz",
                    stream_sketch(pieces[0], 6, 12, seed=3))
    with pytest.raises(ValueError, match="not a streaming-session"):
        StreamingSketchSession.resume(tmp_path / "plain.npz")


def test_jax_session_resumes_in_the_port(tmp_path):
    """The JAX package checkpoints after 2 of 5 pieces; the port resumes the
    checkpoint with the same seed-derived DRMs and finishes the stream."""
    _, pieces, _, jpieces = _session_pieces()
    ref = JSession(SESSION_SHAPE, 6, 12, seed=3)
    for p in jpieces:
        ref.consume(p)
    ck = tmp_path / "jax.npz"
    crashed = JSession(SESSION_SHAPE, 6, 12, seed=3, checkpoint_path=ck,
                       checkpoint_every=2)
    for p in jpieces[:3]:
        crashed.consume(p)
    del crashed
    s = StreamingSketchSession.resume(ck)
    assert s.n_consumed == 2
    for p in pieces[s.n_consumed:]:
        s.consume(p)
    _assert_parts_close(s.result(), ref.result())
    assert _dense_rel(s.result().to_tt(), ref.result().to_tt()) <= REC_TOL
    # the port's checkpoint of the finished stream resumes in the JAX
    # package with the same cursor
    s.checkpoint()
    back = JSession.resume(ck)
    assert back.n_consumed == 5
    _assert_parts_close(s.result(), back.result(), tol=0.0)
