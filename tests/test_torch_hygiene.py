"""The port stands alone: neither ``tt_sketch_torch`` nor ``chip_smoke.py``
imports JAX or the JAX package, and the CUDA toolchain is touched only when
a kernel is first launched."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tt_sketch_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_smoke_dist.py",
    ROOT / "tests" / "torch_dist_worker.py",
]
FORBIDDEN = ("jax", "jaxlib", "tt_sketch_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_out():
    code = (
        "import sys, tt_sketch_torch\n"
        "from tt_sketch_torch import stream_sketch, TensorTrainDRM\n"
        "import tt_sketch_torch.kernels.dense_engine\n"
        "import tt_sketch_torch.interop\n"
        "import tt_sketch_torch.data.frostt\n"
        "import tt_sketch_torch.kernels.sketch_kernels\n"
        "from tt_sketch_torch import SparseTensor, SparseGaussianDRM\n"
        "from tt_sketch_torch import SparseSignDRM\n"
        "import tt_sketch_torch.kernels.sparse_sign\n"
        "from tt_sketch_torch import hmt_sketch, orthogonal_sketch\n"
        "import tt_sketch_torch.kernels.chain_step\n"
        "import tt_sketch_torch.kernels.projector_diag\n"
        "import tt_sketch_torch.kernels.segment_psi\n"
        "import tt_sketch_torch.kernels.jacobi_svd\n"
        "from tt_sketch_torch import TensorSum, CPTensor, TuckerTensor\n"
        "from tt_sketch_torch import DenseGaussianDRM, ALL_DRM\n"
        "from tt_sketch_torch import blocked_stream_sketch\n"
        "from tt_sketch_torch import get_drm_capabilities\n"
        "from tt_sketch_torch import tt_svd, MPO, TTLinearMap, TTPrecond\n"
        "from tt_sketch_torch import TTLinearMapSum, round_tt_sum\n"
        "from tt_sketch_torch import tt_sum_gmres, hilbert_tensor\n"
        "from tt_sketch_torch import sqrt_tensor, power_decay_tensor\n"
        "from tt_sketch_torch.solvers import CookieMap\n"
        "from tt_sketch_torch.solvers import prepare_synthetic_cookie_problem\n"
        "from tt_sketch_torch.utils import projector, reference_random_normal\n"
        "from tt_sketch_torch.interop import mpo_from_numpy\n"
        "from tt_sketch_torch import StreamingSketchSession, StageTimer\n"
        "from tt_sketch_torch import save_sketch, load_sketch, save_tt\n"
        "from tt_sketch_torch import load_tt, uniform_stream_sketch\n"
        "from tt_sketch_torch import uniform_hmt_sketch\n"
        "import tt_sketch_torch.engine.uniform\n"
        "import tt_sketch_torch.serialization, tt_sketch_torch.streaming\n"
        "import tt_sketch_torch.profiling\n"
        "import tt_sketch_torch.dist, tt_sketch_torch.dist.sharded\n"
        "from tt_sketch_torch.dist import initialize_multihost, global_mesh\n"
        "from tt_sketch_torch.dist import make_global\n"
        "from tt_sketch_torch.dist import make_sharded_sparse_sketcher\n"
        "from tt_sketch_torch.dist import sharded_sparse_stream_sketch\n"
        "from tt_sketch_torch.dist import sharded_dense_stream_sketch\n"
        "from tt_sketch_torch.dist import sharded_tt_sum_stream_sketch\n"
        "from tt_sketch_torch.kernels.sparse_plan import "
        "build_shard_psi_plans\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tt_sketch_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "from tt_sketch_torch.kernels import cuda_build\n"
        "assert not cuda_build.build_info\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_kernel_source_is_in_the_package():
    from tt_sketch_torch.kernels.cuda_build import BUILD_DIR, CSRC

    for name in ("dual_project.cu", "lazy_gaussian.cu", "sparse_sign.cu",
                 "sparse_psi.cu", "chain_step.cu", "jacobi_svd.cu",
                 "segment_psi.cu", "hash_rng.cuh", "runtime.cuh"):
        assert (CSRC / name).is_file()
    # builds land under build/, which .gitignore lists
    assert BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_digest_follows_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh changes every library's digest, so no stale
    build is reused."""
    import shutil

    from tt_sketch_torch.kernels import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    names = ("lazy_gaussian", "sparse_sign", "sparse_psi", "dual_project",
             "chain_step")
    before = {n: cuda_build.source_digest(n) for n in names}
    assert before == {n: cuda_build.source_digest(n) for n in names}
    header = csrc / "hash_rng.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build.source_digest(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    (csrc / "lazy_gaussian.cu").write_text(
        (csrc / "lazy_gaussian.cu").read_text() + "\n")
    assert cuda_build.source_digest("lazy_gaussian") != after["lazy_gaussian"]
    assert cuda_build.source_digest("sparse_psi") == after["sparse_psi"]
    # the sign generator lives in the shared header: both libraries that
    # run it include it, so the digest above is what rebuilds them
    assert "sign_column" in header.read_text()
    for name in ("sparse_sign", "sparse_psi"):
        assert '#include "hash_rng.cuh"' in (csrc / f"{name}.cu").read_text()


def test_dist_touches_no_card_and_no_compiler():
    """Importing the sharded sketches and the smoke's rank worker neither
    initializes CUDA nor starts nvcc, and joins no process group."""
    code = (
        "import sys, subprocess\n"
        "calls = []\n"
        "real = subprocess.Popen.__init__\n"
        "def spy(self, args, *a, **k):\n"
        "    calls.append(args)\n"
        "    return real(self, args, *a, **k)\n"
        "subprocess.Popen.__init__ = spy\n"
        "import torch, torch.distributed as dist\n"
        "import tt_sketch_torch.dist\n"
        "import chip_smoke_dist\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not dist.is_initialized()\n"
        "assert not calls, calls\n"
        "from tt_sketch_torch.kernels import cuda_build\n"
        "assert not cuda_build.build_info and not cuda_build._libraries\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tt_sketch_tpu', 'triton')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


# -- the binding seam: kernels/cuda_build.py and csrc/runtime.cuh ------------

KERNELS = ROOT / "tt_sketch_torch" / "kernels"
CSRC = ROOT / "tt_sketch_torch" / "csrc"
WRAPPER_FILES = sorted(p for p in KERNELS.glob("*.py")
                       if p.name != "cuda_build.py")
CUDA_SOURCES = sorted(CSRC.glob("*.cu"))
#: what only the seam may call or name: loading a library, reading a
#: stream handle
SEAM_NAMES = ("CDLL", "load_library", "current_stream", "cuda_stream",
              "_cuda_getCurrentRawStream", "current_stream_handle")
#: calls that switch the device, which only the seam makes
SEAM_CALLS = ("torch.cuda.device", "torch.cuda.set_device",
              "torch.cuda.current_stream", "ctypes.CDLL")
#: wrapper module -> the library of csrc/ whose entries its table declares
WRAPPER_LIBRARIES = {
    "lazy_gaussian": "lazy_gaussian", "sparse_sign": "sparse_sign",
    "sparse_psi": "sparse_psi", "segment_psi": "segment_psi",
    "chain_step": "chain_step", "jacobi_svd": "jacobi_svd",
    "dual_project": "dual_project", "projector_diag": "dual_project",
}


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


@pytest.mark.parametrize("path", WRAPPER_FILES, ids=lambda p: p.name)
def test_wrapper_binds_only_through_the_seam(path):
    """A kernel module loads no library, reads no stream handle, switches no
    device and declares no ``tt_cuda_error_string``: ``cuda_build`` does."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        name = (node.attr if isinstance(node, ast.Attribute)
                else node.id if isinstance(node, ast.Name)
                else node.name if isinstance(node, ast.alias) else None)
        if name in SEAM_NAMES:
            bad.append(name)
        if isinstance(node, ast.Call) and _dotted(node.func) in SEAM_CALLS:
            bad.append(_dotted(node.func))
        if "tt_cuda_error_string" in (
                name, getattr(node, "value", None)
                if isinstance(node, ast.Constant) else None):
            bad.append("tt_cuda_error_string")
    assert not bad, f"{path.name} does the seam's work: {sorted(set(bad))}"


@pytest.mark.parametrize("path", WRAPPER_FILES, ids=lambda p: p.name)
def test_wrapper_imports_no_private_name_of_a_sibling(path):
    """No kernel module reaches into another's private names, by import or
    through the imported module."""
    tree = ast.parse(path.read_text(), filename=str(path))
    package = "tt_sketch_torch.kernels"
    siblings, bad = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (
                node.module or "").startswith(package):
            for alias in node.names:
                if node.module == package:
                    siblings.add(alias.asname or alias.name)
                elif alias.name.startswith("_"):
                    bad.append(f"{node.module}.{alias.name}")
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith(package + ".") and alias.asname:
                    siblings.add(alias.asname)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in siblings and node.attr.startswith("_")
                and not node.attr.startswith("__")):
            bad.append(f"{node.value.id}.{node.attr}")
    assert not bad, f"{path.name} reaches into {bad}"


@pytest.mark.parametrize("path", CUDA_SOURCES, ids=lambda p: p.name)
def test_cuda_source_shares_the_runtime_header(path):
    """A library's source includes ``runtime.cuh`` and neither defines the
    error string nor asks the device for an attribute itself."""
    src = path.read_text()
    assert '#include "runtime.cuh"' in src
    assert "tt_cuda_error_string" not in src
    assert "cudaDeviceGetAttribute" not in src


def test_runtime_header_holds_the_error_string_and_device_limits():
    src = (CSRC / "runtime.cuh").read_text()
    assert src.count('extern "C" const char* tt_cuda_error_string(int err)') \
        == 1
    for attr in ("cudaDevAttrMultiProcessorCount",
                 "cudaDevAttrMaxSharedMemoryPerMultiprocessor",
                 "cudaDevAttrReservedSharedMemoryPerBlock"):
        assert attr in src
    # asked once per device index and kept
    assert "static int held[MAX_DEVICES]" in src


def _c_entries(library):
    """C entry -> (return type, parameter types) of ``csrc/<library>.cu``."""
    import re

    src = (CSRC / f"{library}.cu").read_text()
    out = {}
    for ret, name, params in re.findall(
            r"^(int|int64_t) (tt_\w+)\(([^)]*)\)\s*\{", src, re.M):
        params = [" ".join(p.split()) for p in params.split(",")]
        out[name] = (ret, [] if params == ["void"] else params)
    return out


class _StandInLibrary:
    """A library whose every entry is a plain object that takes the
    ``argtypes`` and ``restype`` declared on it."""

    def __getattr__(self, entry):
        import types

        fn = types.SimpleNamespace()
        setattr(self, entry, fn)
        return fn


@pytest.mark.parametrize("module", sorted(WRAPPER_LIBRARIES))
def test_signature_table_matches_the_c_entries(module, monkeypatch):
    """Each wrapper's ``_library`` hands ``cuda_build.library`` a table that
    declares its C entries as the source defines them (pointers as
    pointers, int64_t as c_int64, int as c_int), and the seam adds the
    error string."""
    import ctypes
    import importlib

    from tt_sketch_torch.kernels import cuda_build

    loaded = []

    def load(name):
        loaded.append(name)
        return _StandInLibrary()

    monkeypatch.setattr(cuda_build, "load_library", load)
    mod = importlib.import_module(f"tt_sketch_torch.kernels.{module}")
    lib = mod._library.__wrapped__()
    assert loaded == [WRAPPER_LIBRARIES[module]]
    declared = {k: v for k, v in vars(lib).items() if k.startswith("tt_")}
    err = declared.pop("tt_cuda_error_string")
    assert (err.argtypes, err.restype) == ([ctypes.c_int], ctypes.c_char_p)
    entries = _c_entries(WRAPPER_LIBRARIES[module])
    assert declared and set(declared) <= set(entries)
    scalar = {"int": ctypes.c_int, "int64_t": ctypes.c_int64}
    for entry, fn in declared.items():
        ret, params = entries[entry]
        assert fn.restype is scalar[ret], entry
        assert len(fn.argtypes) == len(params), entry
        for ctype, param in zip(fn.argtypes, params):
            if "*" in param:
                assert ctype is ctypes.c_void_p or issubclass(
                    ctype, ctypes._Pointer), (entry, param)
            else:
                assert ctype is scalar[param.rsplit(" ", 1)[0]], (entry,
                                                                  param)


def test_library_loads_through_the_swappable_loader(monkeypatch):
    """``cuda_build.library`` loads through the module-level
    ``load_library`` at call time (the A/B tool swaps it to load a variant
    build) and declares every entry of the table."""
    import ctypes

    from tt_sketch_torch.kernels import cuda_build

    variant = _StandInLibrary()
    monkeypatch.setattr(cuda_build, "load_library", lambda name: variant)
    lib = cuda_build.library("anything", {
        "tt_entry": ([cuda_build.PTR, cuda_build.I64], cuda_build.I32)})
    assert lib is variant
    assert lib.tt_entry.argtypes == [ctypes.c_void_p, ctypes.c_int64]
    assert lib.tt_entry.restype is ctypes.c_int


class _FailingLibrary:
    """A stand-in kernel library whose ``tt_run`` returns CUDA error 700."""

    def __init__(self):
        self.calls = []

    def tt_run(self, *args):
        self.calls.append(args)
        return 700 if args[0] < 0 else 0

    def tt_cuda_error_string(self, err):
        return f"stand-in error text {err}".encode()


def _no_card(monkeypatch):
    import contextlib

    from tt_sketch_torch.kernels import cuda_build

    switched = []
    monkeypatch.setattr(
        cuda_build, "on_device",
        lambda device: switched.append(device) or contextlib.nullcontext())
    monkeypatch.setattr(cuda_build, "current_stream_handle",
                        lambda index: 4242 + index)
    return cuda_build, switched


def test_launch_passes_the_stream_last_on_the_device(monkeypatch):
    import torch

    cuda_build, switched = _no_card(monkeypatch)
    lib = _FailingLibrary()
    device = torch.device("cuda", 1)
    assert cuda_build.launch(lib, "tt_run", device, 5, None, 7,
                             what="stand_in") is None
    assert lib.calls == [(5, None, 7, 4243)]
    assert switched == [device]


def test_launch_raises_naming_the_kernel_and_the_error(monkeypatch):
    import torch

    cuda_build, _ = _no_card(monkeypatch)
    with pytest.raises(RuntimeError) as info:
        cuda_build.launch(_FailingLibrary(), "tt_run", torch.device("cuda", 0),
                          -1, what="psi_segment")
    assert str(info.value) == ("psi_segment kernel failed to launch: CUDA "
                               "error 700 (stand-in error text 700)")


def test_check_raises_only_on_an_error_code():
    from tt_sketch_torch.kernels import cuda_build

    cuda_build.check(_FailingLibrary(), 0, "tt_psi_oneside_schedule")
    with pytest.raises(RuntimeError, match=r"^tt_psi_oneside_schedule kernel "
                       r"failed to launch: CUDA error 1 \(stand-in error "
                       r"text 1\)$"):
        cuda_build.check(_FailingLibrary(), 1, "tt_psi_oneside_schedule")


@pytest.mark.parametrize("case", ["ok", "device", "dtype", "ndim", "strided"])
def test_check_int64(case):
    import torch

    from tt_sketch_torch.kernels.cuda_build import check_int64

    t = {"ok": torch.arange(6), "device": torch.arange(6, device="meta"),
         "dtype": torch.arange(6, dtype=torch.int32),
         "ndim": torch.arange(6).reshape(2, 3),
         "strided": torch.arange(12)[::2]}[case]
    cpu = torch.device("cpu")
    if case == "ok":
        check_int64("flat", t, cpu)
        return
    message = ("flat lies on meta; all operands must lie on cpu"
               if case == "device" else
               "flat must be a contiguous 1-D int64 tensor, got "
               f"{t.dtype} of shape {tuple(t.shape)}")
    with pytest.raises(ValueError) as info:
        check_int64("flat", t, cpu)
    assert str(info.value) == message
