"""Build the port's CUDA sources into plain-C shared libraries at first use.

Each ``tt_sketch_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into ``build/tt_sketch_torch/<name>-<hash>.so`` at the repo root
(``build/`` is git-ignored) and loaded with ``ctypes``.  The hash covers the
source and the flags, so an edited source is rebuilt and nothing else is.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tt_sketch_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libraries: Dict[str, ctypes.CDLL] = {}
#: per source name: (seconds spent building, nvcc's output) of the build in
#: this process; absent when the library was already built.
build_info: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name in _libraries:
        return _libraries[name]
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    target = BUILD_DIR / f"{name}-{digest}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {source}:\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        build_info[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(target))
    _libraries[name] = lib
    return lib
