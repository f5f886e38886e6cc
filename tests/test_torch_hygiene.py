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
                 "hash_rng.cuh"):
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
