"""Per-algorithm experiment tasks (counterpart of
``tt_sketch_tpu/experiments/tasks.py``).

Each task has signature ``(input_tensor, **params) -> dict`` with at least
``{"error", "time_taken"}``: the wall time of the algorithm alone, to the
completion of the device its result lies on (the error computation
excluded).  ``dtype`` may be a torch dtype, a numpy dtype or its name;
``compile`` is accepted and does nothing, as in the sketch entry points.
The uniform tasks' default DRM stream is the port's ``"torch"``: the JAX
package's ``"jax"`` stream has no counterpart (the drivers pass
``"hash"``, whose draws are the JAX package's).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from tt_sketch_torch.engine import uniform as uni
from tt_sketch_torch.engine.sketch import (
    hmt_sketch,
    orthogonal_sketch,
    stream_sketch,
)
from tt_sketch_torch.formats import TensorTrain
from tt_sketch_torch.solvers.tt_svd import tt_svd

ErrorFunc = Optional[Callable[[Any, Any], float]]


def torch_dtype(dtype) -> Optional[torch.dtype]:
    """``dtype`` (a torch dtype, a numpy dtype or its name, or None) as a
    torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finish(tt, input_tensor, start_time, error_func: ErrorFunc):
    _synchronize(tt.cores[0].device)
    time_taken = time.perf_counter() - start_time
    if error_func is not None:
        error = error_func(tt, input_tensor)
    else:
        error = tt.error(input_tensor, relative=True)
    return {"error": float(error), "time_taken": time_taken}


def experiment_stream_sketch(
    input_tensor,
    left_rank=None,
    right_rank=None,
    left_drm_type=None,
    right_drm_type=None,
    seed: Optional[int] = None,
    error_func: ErrorFunc = None,
    recompression_rank: Optional[int] = None,
    dtype=None,
    compile: bool = False,
    **kwargs,
) -> Dict[str, Any]:
    start = time.perf_counter()
    sketched = stream_sketch(
        input_tensor,
        left_rank=left_rank,
        right_rank=right_rank,
        left_drm_type=left_drm_type,
        right_drm_type=right_drm_type,
        seed=seed,
        dtype=torch_dtype(dtype),
        compile=compile,
    )
    tt = sketched.to_tt()
    if recompression_rank is not None:
        tt = tt.round(max_rank=recompression_rank)
    return _finish(tt, input_tensor, start, error_func)


def experiment_orthogonal_sketch(
    input_tensor,
    left_rank=None,
    right_rank=None,
    left_drm_type=None,
    right_drm_type=None,
    seed: Optional[int] = None,
    error_func: ErrorFunc = None,
    recompression_rank: Optional[int] = None,
    dtype=None,
    **kwargs,
) -> Dict[str, Any]:
    start = time.perf_counter()
    tt = orthogonal_sketch(
        input_tensor,
        left_rank=left_rank,
        right_rank=right_rank,
        left_drm_type=left_drm_type,
        right_drm_type=right_drm_type,
        seed=seed,
        dtype=torch_dtype(dtype),
    )
    if recompression_rank is not None:
        tt = tt.round(max_rank=recompression_rank)
    return _finish(tt, input_tensor, start, error_func)


def experiment_hmt_sketch(
    input_tensor,
    rank=None,
    drm_type=None,
    seed: Optional[int] = None,
    error_func: ErrorFunc = None,
    recompression_rank: Optional[int] = None,
    dtype=None,
    **kwargs,
) -> Dict[str, Any]:
    start = time.perf_counter()
    tt = hmt_sketch(input_tensor, rank=rank, drm_type=drm_type, seed=seed,
                    dtype=torch_dtype(dtype))
    if recompression_rank is not None:
        tt = tt.round(max_rank=recompression_rank)
    return _finish(tt, input_tensor, start, error_func)


def experiment_tt_svd(
    input_tensor, rank=None, error_func: ErrorFunc = None, **kwargs
) -> Dict[str, Any]:
    start = time.perf_counter()
    tt = tt_svd(input_tensor, rank=rank)
    return _finish(tt, input_tensor, start, error_func)


def experiment_tt_round(
    input_tensor: TensorTrain,
    rank=None,
    error_func: ErrorFunc = None,
    **kwargs,
) -> Dict[str, Any]:
    start = time.perf_counter()
    tt = input_tensor.round(max_rank=rank)
    return _finish(tt, input_tensor, start, error_func)


# ---------------------------------------------------------------------------
# Order-scaling tasks on the uniform engine
# ---------------------------------------------------------------------------

def _uniform_finish(out, stacked, start) -> Dict[str, Any]:
    _synchronize(out[0].device)
    time_taken = time.perf_counter() - start
    error = uni.uniform_rel_error(out, stacked)
    return {"error": float(error), "time_taken": time_taken}


def experiment_uniform_stream_sketch(
    stacked,
    left_rank=None,
    right_rank=None,
    recompression_rank=None,
    seed: int = 0,
    drm_stream: str = "torch",
    **kwargs,
) -> Dict[str, Any]:
    tt = uni.unstack_tt(*stacked)
    start = time.perf_counter()
    rec, _ = uni.uniform_stream_sketch(
        tt, left_rank, right_rank, seed=seed, drm_stream=drm_stream
    )
    out = uni.stack_tt(rec)
    if recompression_rank is not None:
        out = uni.uniform_round_fixed(*out, max_rank=recompression_rank)
    return _uniform_finish(out, stacked, start)


def experiment_uniform_orthogonal_sketch(
    stacked,
    left_rank=None,
    right_rank=None,
    recompression_rank=None,
    seed: int = 0,
    drm_stream: str = "torch",
    **kwargs,
) -> Dict[str, Any]:
    """OTTS on the uniform engine."""
    tt = uni.unstack_tt(*stacked)
    start = time.perf_counter()
    rec = uni.uniform_orthogonal_sketch(
        tt, left_rank, right_rank, seed=seed, drm_stream=drm_stream
    )
    out = uni.stack_tt(rec)
    if recompression_rank is not None:
        out = uni.uniform_round_fixed(*out, max_rank=recompression_rank)
    return _uniform_finish(out, stacked, start)


def experiment_uniform_tt_round(
    stacked,
    rank=None,
    seed: int = 0,
    **kwargs,
) -> Dict[str, Any]:
    """Deterministic TT-SVD-rounding baseline on the uniform engine (the
    'TT-SVD' rows of the order-scaling record)."""
    start = time.perf_counter()
    out = uni.uniform_round_fixed(*stacked, max_rank=rank)
    return _uniform_finish(out, stacked, start)


def experiment_uniform_hmt_sketch(
    stacked,
    rank=None,
    recompression_rank=None,
    seed: int = 0,
    drm_stream: str = "torch",
    **kwargs,
) -> Dict[str, Any]:
    tt = uni.unstack_tt(*stacked)
    start = time.perf_counter()
    rec = uni.uniform_hmt_sketch(tt, rank, seed=seed, drm_stream=drm_stream)
    out = uni.stack_tt(rec)
    if recompression_rank is not None:
        out = uni.uniform_round_fixed(*out, max_rank=recompression_rank)
    return _uniform_finish(out, stacked, start)
