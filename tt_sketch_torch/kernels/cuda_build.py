"""Build the port's CUDA sources into plain-C shared libraries at first use,
and bind, launch and check their entries: the one seam between the kernel
wrappers and ``csrc/``.

Each ``tt_sketch_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into ``build/tt_sketch_torch/<name>-<hash>.so`` at the repo root
(``build/`` is git-ignored) and loaded with ``ctypes``.  The hash covers the
source, every shared header ``csrc/*.cuh`` and the flags, so an edited
source or header is rebuilt and nothing else is.  ``build_libraries``
starts one ``nvcc`` per source, all at once.  Nothing here runs at import
time.

A wrapper binds its library with ``library(name, signatures)`` (its C
entries' ``(argtypes, restype)``), launches an entry with ``launch`` (on
the operands' device and its current stream, raising on the CUDA error the
entry returns) and checks its int64 operands with ``check_int64``.  Every
library exports ``tt_cuda_error_string`` and asks the device for its
limits through ``csrc/runtime.cuh``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Mapping, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tt_sketch_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: the C types of the signature tables
PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: the entry every library exports (``csrc/runtime.cuh``)
_ERROR_STRING = {"tt_cuda_error_string": ([I32], ctypes.c_char_p)}

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


def source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_digest(name)}.so"


def build_libraries(names) -> None:
    """Build every library of ``names`` that is not built yet, one ``nvcc``
    process per source, all started together."""
    pending = [n for n in dict.fromkeys(names) if not _target(n).exists()]
    if not pending:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for name in pending:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((name, tmp, proc, time.perf_counter()))
        failed = []
        for name, tmp, proc, t0 in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build csrc/{name}.cu:\n{out}")
                continue
            os.replace(tmp, _target(name))
            build_info[name] = (time.perf_counter() - t0, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for name, tmp, proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name in _libraries:
        return _libraries[name]
    build_libraries([name])
    lib = ctypes.CDLL(str(_target(name)))
    _libraries[name] = lib
    return lib


def on_device(device):
    """A context that makes ``device`` current: ``torch.cuda.device`` where
    it is not current already, else nothing (the switch costs the host
    about 2.6 µs a call)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def current_stream_handle(device_index: int) -> int:
    """The raw handle of the current CUDA stream of ``device_index``: what
    ``torch.cuda.current_stream(device_index).cuda_stream`` gives, without
    building a ``Stream`` object (about 5 µs of host time a call on the
    H100 machine's host)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def library(name: str,
            signatures: Mapping[str, Tuple[Sequence, object]]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with ``signatures`` (C entry ->
    ``(argtypes, restype)``) and ``tt_cuda_error_string`` declared.

    Loads through the module-level ``load_library``, which builds and loads
    each name once per process; a wrapper's ``_library`` caches the
    declared library."""
    lib = load_library(name)
    for entry, (argtypes, restype) in {**signatures, **_ERROR_STRING}.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def check(lib, err: int, what: str) -> None:
    """Raise if ``err``, the return code of one of ``lib``'s entries, is a
    CUDA error; ``what`` names the kernel in the message."""
    if err != 0:
        raise RuntimeError(
            f"{what} kernel failed to launch: CUDA error {err} "
            f"({lib.tt_cuda_error_string(err).decode()})")


def launch(lib, entry: str, device, *args, what: str) -> None:
    """Call ``lib``'s C entry ``entry`` with ``args`` and, as its last
    argument, the current stream of ``device``, with ``device`` current;
    ``check`` the error it returns."""
    with on_device(device):
        err = getattr(lib, entry)(*args, current_stream_handle(device.index))
    check(lib, err, what)


def check_int64(name: str, t, device) -> None:
    """Raise unless operand ``name`` is a contiguous 1-D int64 tensor on
    ``device``."""
    if t.device != device:
        raise ValueError(
            f"{name} lies on {t.device}; all operands must lie on {device}")
    if t.dtype != torch.int64 or t.ndim != 1 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous 1-D int64 tensor, got {t.dtype} "
            f"of shape {tuple(t.shape)}")
