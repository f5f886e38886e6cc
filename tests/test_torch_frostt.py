"""The port's FROSTT loader (``tt_sketch_torch/data/frostt.py``) against the
JAX package's: the registry, ``_grid_sizes`` and ``_synthesize`` (host
numpy, bit for bit; the committed stand-ins ``data/*.npz`` regenerated
exactly), ``parse_tns`` of ``.tns`` and ``.tns.gz`` files, and the cache
flow of ``load_frostt``: a missing or stale synthetic file regenerated and
cached, a ``.tns.gz`` parsed and cached as ``.npz``, and no network.

Every file is written under ``tmp_path``.  Tolerances: none, the arrays are
equal (``np.array_equal``).  ``_synthesize``'s values end in a
``np.tensordot``, whose last bit depends on how many threads OpenBLAS splits
it over; the committed stand-ins were written with two, so the generators
run under ``threadpool_limits(2)`` here.
"""
import gzip
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from tt_sketch_torch import config
from tt_sketch_torch.data import frostt
from tt_sketch_tpu.data import frostt as jfrostt

REPO = Path(__file__).resolve().parents[1]
NAMES = sorted(jfrostt.FROSTT_TENSORS)
SYNTHETIC = ("uber-synthetic", "nips-synthetic", "lbnl-synthetic")


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = config.default_device()
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _write_tns(path, indices, entries, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        for idx, e in zip(indices.T, entries):
            f.write(" ".join(str(i + 1) for i in idx) + f" {float(e)!r}\n")


def _toy(shape, nnz, seed):
    rng = np.random.default_rng(seed)
    flat = rng.choice(int(np.prod(shape)), nnz, replace=False)
    return np.stack(np.unravel_index(flat, shape)), rng.standard_normal(nnz)


def _tiny(name, url, monkeypatch, nnz=300, shape=(7, 5, 9, 11)):
    """Register one small entry in both packages' registries."""
    for mod in (frostt, jfrostt):
        monkeypatch.setitem(mod.FROSTT_TENSORS, name,
                            mod.FrosttInfo(name, url, nnz, shape))
    return frostt.FROSTT_TENSORS[name], jfrostt.FROSTT_TENSORS[name]


def test_registry_equals_jax():
    assert list(frostt.FROSTT_TENSORS) == list(jfrostt.FROSTT_TENSORS)
    for name, info in jfrostt.FROSTT_TENSORS.items():
        ours = frostt.FROSTT_TENSORS[name]
        assert (ours.name, ours.url, ours.nnz, ours.shape) == (
            info.name, info.url, info.nnz, info.shape)
    assert frostt._SYNTH_VERSION == jfrostt._SYNTH_VERSION == 2


@pytest.mark.parametrize("name", NAMES)
def test_grid_sizes_and_synthesize_equal_jax(name):
    info = frostt.FROSTT_TENSORS[name]
    jinfo = jfrostt.FROSTT_TENSORS[name]
    assert frostt._grid_sizes(info.shape, info.nnz) == jfrostt._grid_sizes(
        jinfo.shape, jinfo.nnz)
    with threadpool_limits(2, user_api="blas"):
        idx, vals = frostt._synthesize(info)
        jidx, jvals = jfrostt._synthesize(jinfo)
    assert idx.dtype == jidx.dtype and vals.dtype == jvals.dtype
    assert np.array_equal(idx, jidx) and np.array_equal(vals, jvals)
    if name in SYNTHETIC:
        # the committed stand-in is this generator's output, bit for bit
        with np.load(REPO / "data" / f"{name}.npz") as data:
            assert int(data["synth_version"]) == 2
            assert tuple(data["shape"]) == info.shape
            assert np.array_equal(data["indices"], idx)
            assert np.array_equal(data["entries"], vals)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("given_shape", [False, True])
def test_parse_tns_equals_jax(tmp_path, gz, given_shape):
    shape = (6, 5, 7, 4)
    indices, entries = _toy(shape, 50, seed=int(gz) + 2 * int(given_shape))
    path = tmp_path / ("toy.tns.gz" if gz else "toy.tns")
    _write_tns(path, indices, entries, gz=gz)
    kw = {"shape": shape} if given_shape else {}
    ours = frostt.parse_tns(path, **kw)
    ref = jfrostt.parse_tns(path, **kw)
    assert ours.shape == tuple(ref.shape)
    assert ours.device.type == "cpu"
    assert np.array_equal(ours.indices.numpy(), np.asarray(ref.indices))
    assert np.array_equal(ours.entries.numpy(), np.asarray(ref.entries))
    assert np.array_equal(ours.entries.numpy(), entries)


def test_parse_tns_of_an_empty_file_raises(tmp_path):
    path = tmp_path / "empty.tns"
    path.write_text("")
    with pytest.raises(ValueError, match="no nonzeros"):
        frostt.parse_tns(path)


def test_missing_synthetic_file_is_synthesized_and_cached(tmp_path,
                                                          monkeypatch):
    info, jinfo = _tiny("tiny-synthetic", "synthetic://tiny", monkeypatch)
    t = frostt.load_frostt("tiny-synthetic", cache_dir=tmp_path / "a")
    jt = jfrostt.load_frostt("tiny-synthetic", cache_dir=tmp_path / "b")
    assert t.shape == info.shape
    assert np.array_equal(t.indices.numpy(), np.asarray(jt.indices))
    assert np.array_equal(t.entries.numpy(), np.asarray(jt.entries))
    with np.load(tmp_path / "a" / "tiny-synthetic.npz") as ours, \
            np.load(tmp_path / "b" / "tiny-synthetic.npz") as ref:
        assert sorted(ours.files) == sorted(ref.files)
        for key in ref.files:
            assert np.array_equal(ours[key], ref[key])
    # a second load reads the cache: a changed file is what it returns
    with np.load(tmp_path / "a" / "tiny-synthetic.npz") as data:
        arrays = dict(data)
    arrays["entries"] = arrays["entries"] * 2.0
    np.savez(tmp_path / "a" / "tiny-synthetic.npz", **arrays)
    again = frostt.load_frostt("tiny-synthetic", cache_dir=tmp_path / "a")
    assert np.array_equal(again.entries.numpy(), 2.0 * t.entries.numpy())


@pytest.mark.parametrize("version", [None, 1])
def test_stale_synthetic_file_is_regenerated(tmp_path, monkeypatch, version):
    info, _ = _tiny("tiny-synthetic", "synthetic-scatter://tiny", monkeypatch)
    stale = dict(indices=np.zeros((4, 3), np.int64), entries=np.ones(3),
                 shape=np.asarray(info.shape))
    if version is not None:
        stale["synth_version"] = np.asarray(version)
    np.savez(tmp_path / "tiny-synthetic.npz", **stale)
    t = frostt.load_frostt("tiny-synthetic", cache_dir=tmp_path,
                           psi_plan=True, plan_kwargs=dict(threshold=8))
    idx, vals = jfrostt._synthesize(jfrostt.FROSTT_TENSORS["tiny-synthetic"])
    assert np.array_equal(t.indices.numpy(), idx)
    assert np.array_equal(t.entries.numpy(), vals)
    assert [p is None for p in t.psi_plan] == [True, True, False, False]
    with np.load(tmp_path / "tiny-synthetic.npz") as data:
        assert int(data["synth_version"]) == 2
        assert np.array_equal(data["indices"], idx)


def test_tns_gz_is_parsed_and_cached_as_npz(tmp_path):
    shape = frostt.FROSTT_TENSORS["uber"].shape
    rng = np.random.default_rng(0)
    indices = np.stack([rng.integers(0, s, 400) for s in shape])
    entries = rng.standard_normal(400)
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        _write_tns(tmp_path / d / "uber.tns.gz", indices, entries, gz=True)
    t = frostt.load_frostt("uber", cache_dir=tmp_path / "a", download=False)
    jt = jfrostt.load_frostt("uber", cache_dir=tmp_path / "b", download=False)
    assert t.shape == tuple(jt.shape) == shape
    assert np.array_equal(t.indices.numpy(), np.asarray(jt.indices))
    assert np.array_equal(t.entries.numpy(), np.asarray(jt.entries))
    with np.load(tmp_path / "a" / "uber.npz") as ours, \
            np.load(tmp_path / "b" / "uber.npz") as ref:
        assert sorted(ours.files) == sorted(ref.files) == [
            "entries", "indices", "shape"]
        for key in ref.files:
            assert np.array_equal(ours[key], ref[key])
    # the cached .npz is read without the .tns.gz
    (tmp_path / "a" / "uber.tns.gz").unlink()
    again = frostt.load_frostt("uber", cache_dir=tmp_path / "a")
    assert np.array_equal(again.entries.numpy(), entries)


@pytest.mark.parametrize("download", [False, True])
def test_no_network_whatever_download_says(tmp_path, monkeypatch, download):
    def no_network(*args, **kwargs):
        raise AssertionError("the port must not open a URL")

    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    with pytest.raises(FileNotFoundError) as err:
        frostt.load_frostt("nips", cache_dir=tmp_path, download=download)
    msg = str(err.value)
    assert frostt.FROSTT_TENSORS["nips"].url in msg
    assert str(tmp_path / "nips.tns.gz") in msg
    assert ("no downloader" in msg) == download
    assert not any(tmp_path.iterdir())


def test_unknown_name_raises_key_error(tmp_path):
    with pytest.raises(KeyError):
        frostt.load_frostt("uber-pickups", cache_dir=tmp_path)
