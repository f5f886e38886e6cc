"""Experiment drivers — one per reference ``scripts/plot_*.py`` sweep.

Each driver runs a resumable parameter sweep into ``<out>/<name>.csv``
(interrupt and re-run: completed combinations are skipped).  ``quick=True``
shrinks every grid to a seconds-scale smoke configuration (used by tests
and for a fast end-to-end check on new hardware).

Counterpart of ``tt_sketch_tpu/experiments/drivers.py``: the same grids,
seeds, quick grids and CSV names.  Problems are built on the package
default device.

Run from the CLI:  ``python -m tt_sketch_torch.experiments hilbert --quick``.
"""
from __future__ import annotations

import itertools
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from tt_sketch_torch.drm import DenseGaussianDRM, TensorTrainDRM
from tt_sketch_torch.experiments import problems, tasks
from tt_sketch_torch.experiments.runner import Experiment

DRM_TYPES = [DenseGaussianDRM, TensorTrainDRM]


def _exp(out: str, name: str) -> Experiment:
    return Experiment(str(Path(out) / f"{name}.csv"))


def _seed_for(rank: int, run: int, extra: int = 0) -> int:
    return 100_003 * run + 1009 * rank + extra


def _sweep_all_methods(
    experiment: Experiment,
    tensor,
    ranks: Sequence[int],
    runs: Sequence[int],
    drm_types,
    oversample: int = 2,
    tt_svd_ranks: Optional[Sequence[int]] = None,
    progress: bool = True,
) -> None:
    """The OTTS/STTA/HMT/TT-SVD grid shared by hilbert/sqrt/tt_sum/cp
    drivers (plot_hilbert.py:36-87 et al.)."""
    grid = list(itertools.product(ranks, runs, drm_types))
    for rank, run, drm_type in _maybe_tqdm(grid, "OTTS", progress):
        experiment.run(
            tensor, "OTTS", tasks.experiment_orthogonal_sketch,
            left_rank=rank, right_rank=rank * oversample,
            left_drm_type=drm_type, right_drm_type=drm_type,
            run=run, seed=_seed_for(rank, run, 1),
        )
    for rank, run, drm_type in _maybe_tqdm(grid, "STTA", progress):
        experiment.run(
            tensor, "STTA", tasks.experiment_stream_sketch,
            left_rank=rank, right_rank=rank * oversample,
            left_drm_type=drm_type, right_drm_type=drm_type,
            run=run, seed=_seed_for(rank, run, 2),
        )
    for rank, run, drm_type in _maybe_tqdm(grid, "HMT", progress):
        experiment.run(
            tensor, "HMT", tasks.experiment_hmt_sketch,
            rank=rank, drm_type=drm_type,
            run=run, seed=_seed_for(rank, run, 3),
        )
    for rank in _maybe_tqdm(
        list(tt_svd_ranks if tt_svd_ranks is not None else ranks),
        "TT-SVD", progress,
    ):
        experiment.run(tensor, "TT-SVD", tasks.experiment_tt_svd, rank=rank)


def _maybe_tqdm(iterable, desc: str, progress: bool):
    if not progress:
        return iterable
    try:
        from tqdm import tqdm

        return tqdm(iterable, desc=desc)
    except ImportError:
        return iterable


def run_hilbert(out: str = "results", quick: bool = False, progress=True):
    """7-dim size-5 Hilbert tensor sweep (plot_hilbert.py:30-87)."""
    tensor = problems.hilbert_problem()
    ranks = [2, 5, 8] if quick else list(range(1, 16))
    runs = range(2) if quick else range(20)
    drms = [TensorTrainDRM] if quick else DRM_TYPES
    exp = _exp(out, "hilbert")
    _sweep_all_methods(exp, tensor, ranks, runs, drms, progress=progress)
    return exp


def run_sqrt(out: str = "results", quick: bool = False, progress=True):
    """sqrt-of-sum tensor sweep (plot_sqrt_tensor.py:24-80)."""
    tensor = problems.sqrt_problem()
    ranks = [2, 5, 8] if quick else list(range(1, 16))
    runs = range(2) if quick else range(20)
    drms = [TensorTrainDRM] if quick else DRM_TYPES
    exp = _exp(out, "sqrt")
    _sweep_all_methods(exp, tensor, ranks, runs, drms, progress=progress)
    return exp


def run_tt_sum(out: str = "results", quick: bool = False, progress=True):
    """Sum of 20 decaying rank-3 TTs (plot_tt_sum.py:18-34)."""
    tensor = problems.tt_sum_problem()
    ranks = [3, 10] if quick else list(range(1, 31))
    runs = range(2) if quick else range(30)
    exp = _exp(out, "tt_sum")
    _sweep_all_methods(
        exp, tensor, ranks, runs, [TensorTrainDRM], progress=progress
    )
    return exp


def run_tt_plus_sparse(out: str = "results", quick: bool = False, progress=True):
    """Rank-5 TT + decaying sparse outliers (plot_tt_plus_sparse.py:22-41)."""
    tensor = problems.tt_plus_sparse_problem()
    ranks = [5, 10] if quick else list(range(1, 31))
    runs = range(2) if quick else range(30)
    exp = _exp(out, "tt_plus_sparse")
    _sweep_all_methods(
        exp, tensor, ranks, runs, [TensorTrainDRM], progress=progress
    )
    return exp


def run_cp(out: str = "results", quick: bool = False, progress=True):
    """Rank-100 CP with decaying norms (plot_cp_tensor.py:23-37)."""
    tensor = problems.cp_problem()
    ranks = [5, 10] if quick else list(range(1, 31))
    runs = range(2) if quick else range(30)
    exp = _exp(out, "cp_tensor")
    _sweep_all_methods(
        exp, tensor, ranks, runs, [TensorTrainDRM], progress=progress
    )
    return exp


def run_dimension_scaling(
    out: str = "results", quick: bool = False, progress=True
):
    """Order scaling to d = 2^13 on the uniform scan engine
    (plot_dimension_scaling.py:20-25: dim 30, rank 30, round to 10)."""
    orders = [8, 16] if quick else [2 ** k for k in range(2, 14)]
    dim, rank = (6, 5) if quick else (30, 30)
    recomp = 3 if quick else 10
    runs = range(1) if quick else range(10)
    exp = _exp(out, "dimension_scaling")
    for order in _maybe_tqdm(orders, "order-scaling", progress):
        stacked = problems.exp_decay_uniform_problem(order, dim, rank)
        # Deterministic TT-SVD baseline at the round rank and two below
        # (reference plot_dimension_scaling.py:66-93), one run each.
        for tsvd_rank in (recomp, recomp - 1, recomp - 2):
            exp.run(
                stacked, "TT-SVD", tasks.experiment_uniform_tt_round,
                rank=tsvd_rank, order=order, dim=dim, run=0,
                seed=_seed_for(order, 0, 6),
            )
        # fewer repeats at the largest orders: a d=8192 run is minutes of
        # sequential per-mode sweeps even on-chip, and run variance there
        # is far below the plotted error spread
        order_runs = (
            range(3) if (not quick and order >= 4096)
            else range(6) if (not quick and order == 2048)
            else runs
        )
        for run in order_runs:
            # drm_stream="hash": the record's DRMs, the library's own
            # counter-based generator (engine/uniform.py), whose draws are
            # the JAX package's.
            exp.run(
                stacked, "STTA", tasks.experiment_uniform_stream_sketch,
                left_rank=rank, right_rank=2 * rank,
                recompression_rank=recomp, drm_stream="hash",
                order=order, dim=dim, run=run, seed=_seed_for(order, run, 4),
            )
            exp.run(
                stacked, "HMT", tasks.experiment_uniform_hmt_sketch,
                rank=rank, recompression_rank=recomp, drm_stream="hash",
                order=order, dim=dim, run=run, seed=_seed_for(order, run, 5),
            )
            exp.run(
                stacked, "OTTS", tasks.experiment_uniform_orthogonal_sketch,
                left_rank=min(rank, dim), right_rank=2 * rank,
                recompression_rank=recomp, drm_stream="hash",
                order=order, dim=dim, run=run, seed=_seed_for(order, run, 7),
            )
    return exp


def run_timings(out: str = "results", quick: bool = False, progress=True):
    """Wall-time benchmark on a rank-150 exp-decay TT of shape (100,)^5
    (plot_timings.py:28-58): STTA x2 / STTA +3 / HMT / OTTS x2 over sketch
    ranks 5..145.  Error via the exact TT identity (the (100,)^5 tensor
    cannot be densified)."""
    if quick:
        dim, tt_rank = 20, 12
        ranks = [5, 10]
        runs = range(2)
    else:
        dim, tt_rank = 100, 150
        ranks = list(range(5, 146, 10))
        runs = range(20)
    tensor = problems.exp_decay_tt_problem(
        n_dims=5, dim=dim, tt_rank=tt_rank, seed=179, min_svdval=-20.0
    )
    exp = _exp(out, "timings")
    err = _tt_fast_error_func()
    grid = list(itertools.product(ranks, runs))
    for rank, run in _maybe_tqdm(grid, "STTA-x2", progress):
        exp.run(
            tensor, "STTA-x2", tasks.experiment_stream_sketch,
            left_rank=rank, right_rank=2 * rank, error_func=err,
            run=run, seed=_seed_for(rank, run, 6),
        )
    for rank, run in _maybe_tqdm(grid, "STTA-plus3", progress):
        exp.run(
            tensor, "STTA-plus3", tasks.experiment_stream_sketch,
            left_rank=rank, right_rank=rank + 3, error_func=err,
            run=run, seed=_seed_for(rank, run, 7),
        )
    for rank, run in _maybe_tqdm(grid, "HMT", progress):
        exp.run(
            tensor, "HMT", tasks.experiment_hmt_sketch,
            rank=rank, run=run, error_func=err,
            seed=_seed_for(rank, run, 8),
        )
    for rank, run in _maybe_tqdm(grid, "OTTS-x2", progress):
        exp.run(
            tensor, "OTTS-x2", tasks.experiment_orthogonal_sketch,
            left_rank=rank, right_rank=2 * rank, error_func=err,
            run=run, seed=_seed_for(rank, run, 20),
        )
    # Fifth reference variant (plot_timings.py:28-36): OTTS with +3
    # right oversampling.
    for rank, run in _maybe_tqdm(grid, "OTTS-plus3", progress):
        exp.run(
            tensor, "OTTS-plus3", tasks.experiment_orthogonal_sketch,
            left_rank=rank, right_rank=rank + 3, error_func=err,
            run=run, seed=_seed_for(rank, run, 21),
        )
    return exp


def _tt_fast_error_func():
    """Relative error via the exact TT inner-product identity with the
    target's Gram norm cached across the sweep."""
    import numpy as _np

    cache = {}

    def fast_error_func(tt, tensor_):
        if "b2" not in cache:
            cache["b2"] = float(tensor_.norm()) ** 2
        a2 = float(tt.norm()) ** 2
        ab = float(tt.dot(tensor_))
        b2 = cache["b2"]
        return float(_np.sqrt(max(a2 + b2 - 2.0 * ab, 0.0)) / _np.sqrt(b2))

    return fast_error_func


def run_right_oversampling(
    out: str = "results", quick: bool = False, progress=True
):
    """STTA error vs right-oversampling at left rank 10
    (plot_right_oversampling.py:42-46)."""
    tensor = problems.tt_sum_problem()
    left_rank = 5 if quick else 10
    right_ranks = [7, 12] if quick else list(range(12, 51, 2))
    runs = range(2) if quick else range(100)
    exp = _exp(out, "right_oversampling")
    grid = list(itertools.product(right_ranks, runs))
    for right_rank, run in _maybe_tqdm(grid, "STTA", progress):
        exp.run(
            tensor, "STTA", tasks.experiment_stream_sketch,
            left_rank=left_rank, right_rank=right_rank,
            run=run, seed=_seed_for(right_rank, run, 9),
        )
    # OTTS rows + TT-SVD baselines, matching the reference sweep
    # (plot_right_oversampling.py:50-74: OTTS over the same grid, tt_svd
    # at the left rank and one below).  Run-major so a wall-clock-bounded
    # partial sweep covers the whole oversampling axis.
    grid_rm = [(rr, run) for run in runs for rr in right_ranks]
    for right_rank, run in _maybe_tqdm(grid_rm, "OTTS", progress):
        exp.run(
            tensor, "OTTS", tasks.experiment_orthogonal_sketch,
            left_rank=left_rank, right_rank=right_rank,
            run=run, seed=_seed_for(right_rank, run, 13),
        )
    exp.run(tensor, "TT-SVD", tasks.experiment_tt_svd, rank=left_rank)
    exp.run(tensor, "TT-SVD", tasks.experiment_tt_svd, rank=left_rank - 1)
    return exp


def run_recompression(out: str = "results", quick: bool = False, progress=True):
    """Sketch at rank r then round to fixed rank 10, vs TT-SVD
    (plot_recompression.py:42-79)."""
    tensor = problems.sqrt_problem()
    target = 3 if quick else 10
    ranks = [4, 8] if quick else list(range(10, 41, 2))
    runs = range(2) if quick else range(30)
    exp = _exp(out, "recompression")
    grid = list(itertools.product(ranks, runs))
    # Second STTA variant (reference plot_recompression.py:42-79 sweeps
    # both a +3 and an x2 right-oversampling STTA next to HMT).  Runs
    # first so a wall-clock-bounded resume fills the missing variant
    # before deepening the established ones.
    for rank, run in _maybe_tqdm(grid, "STTA-plus3-recomp", progress):
        exp.run(
            tensor, "STTA-plus3", tasks.experiment_stream_sketch,
            left_rank=rank, right_rank=rank + 3,
            recompression_rank=target,
            run=run, seed=_seed_for(rank, run, 22),
        )
    for rank, run in _maybe_tqdm(grid, "STTA-recomp", progress):
        exp.run(
            tensor, "STTA", tasks.experiment_stream_sketch,
            left_rank=rank, right_rank=2 * rank,
            recompression_rank=target,
            run=run, seed=_seed_for(rank, run, 10),
        )
    for rank, run in _maybe_tqdm(grid, "HMT-recomp", progress):
        exp.run(
            tensor, "HMT", tasks.experiment_hmt_sketch,
            rank=rank, recompression_rank=target,
            run=run, seed=_seed_for(rank, run, 11),
        )
    exp.run(tensor, "TT-SVD", tasks.experiment_tt_svd, rank=target)
    return exp


def run_dimension_scaling_gaussian(
    out: str = "results", quick: bool = False, progress=True
):
    """Order scaling vs the Gaussian DRM: exp-decay-spectrum TTs at mode
    size 5, orders 4-12, round rank 8 with x2 right oversampling
    (plot_dimension_scaling_gaussian.py:19-102)."""
    from tt_sketch_torch.utils import process_tt_rank

    n_dims_list = [4, 6] if quick else list(range(4, 13))
    runs = range(2) if quick else range(30)
    dim, tt_rank, round_rank = (4, 4, 3) if quick else (5, 10, 8)
    exp = _exp(out, "dimension_scaling_gaussian")
    for n_dims in _maybe_tqdm(n_dims_list, "order-scaling-gauss", progress):
        tensor = problems.exp_decay_tt_problem(
            n_dims, dim=dim, tt_rank=tt_rank, seed=179 + n_dims,
            min_svdval=-5.0,
        )
        rr = process_tt_rank(round_rank, tensor.shape, trim=True)
        exp.run(
            tensor, "TT-SVD", tasks.experiment_tt_round,
            rank=round_rank, n_dims=n_dims,
        )
        for run in runs:
            exp.run(
                tensor, "HMT", tasks.experiment_hmt_sketch,
                drm_type=DenseGaussianDRM, rank=round_rank,
                run=run, n_dims=n_dims, seed=_seed_for(n_dims, run, 13),
            )
            exp.run(
                tensor, "STTA", tasks.experiment_stream_sketch,
                left_drm_type=DenseGaussianDRM,
                right_drm_type=DenseGaussianDRM,
                left_rank=rr, right_rank=tuple(2 * r for r in rr),
                run=run, n_dims=n_dims, seed=_seed_for(n_dims, run, 14),
            )
    return exp


def run_timings_vs_error(
    out: str = "results", quick: bool = False, progress=True
):
    """Error-vs-time frontier on a sum of 10 rank-100 TTs of shape
    (1000,)^5: OTTS vs STTA vs HMT at ranks 5..24 with right oversampling
    of +1 (plot_timings_vs_error.py:29-101).

    Deviation from the reference script: it calls ``error(fast=False)``,
    which densifies the tensor — impossible at 10^15 entries (the script
    is exploratory in the reference).  Here the error is the exact TT
    inner-product identity with the tensor's Gram data computed once per
    sweep instead of once per run."""
    if quick:
        tensor = problems.timings_vs_error_problem(
            dim=12, tt_rank=6, num_tts=3
        )
        ranks = [3, 5]
        runs = range(2)
    else:
        tensor = problems.timings_vs_error_problem()
        ranks = list(range(5, 25))
        runs = range(10)
    exp = _exp(out, "timings_vs_error")
    fast_error_func = _tt_fast_error_func()
    # run-major, methods interleaved (reference plot_timings_vs_error.py:84
    # iterates product(runs, ranks, methods)): an interrupted sweep then
    # leaves every (method, rank) cell with the same number of runs, so the
    # resumable CSV is median-usable at any point.
    grid = list(itertools.product(runs, ranks))
    for run, rank in _maybe_tqdm(grid, "OTTS/STTA/HMT", progress):
        exp.run(
            tensor, "OTTS", tasks.experiment_orthogonal_sketch,
            left_rank=rank, right_rank=rank + 1,
            error_func=fast_error_func,
            run=run, seed=_seed_for(rank, run, 15),
        )
        exp.run(
            tensor, "STTA", tasks.experiment_stream_sketch,
            left_rank=rank, right_rank=rank + 1,
            error_func=fast_error_func,
            run=run, seed=_seed_for(rank, run, 16),
        )
        exp.run(
            tensor, "HMT", tasks.experiment_hmt_sketch,
            rank=rank, error_func=fast_error_func,
            run=run, seed=_seed_for(rank, run, 17),
        )
    return exp


def run_frostt(
    out: str = "results", quick: bool = False, progress=True,
    names: Optional[Sequence[str]] = None, cache_dir: str = "data",
    ranks: Optional[Sequence[int]] = None, n_runs: Optional[int] = None,
    dtype: Optional[str] = None,
):
    """Sketch-and-sample-error on the FROSTT real-world sparse tensors
    (reference scripts/frostt.py:100-118).  Tensors must be cached locally
    (see data/frostt.py); missing ones are skipped with a notice so the
    sweep is usable offline.  The ``*-synthetic`` registry names generate
    offline stand-ins at the real shapes/nnz.

    Expectation management: tensors whose nonzero pattern is fine-grained
    and unstructured (the synthetic stand-ins; real count data at these
    ranks behaves similarly) have sample errors near 1 at ranks ≪ mode
    sizes — the sweep's value is the at-scale machinery + timing record,
    not a compression story."""
    import torch

    from tt_sketch_torch.data.frostt import (
        FROSTT_TENSORS,
        load_frostt,
        sample_error,
    )
    from tt_sketch_torch.drm import SparseGaussianDRM

    if names is None:
        names = sorted(FROSTT_TENSORS)
    if ranks is None:
        ranks = [5] if quick else [5, 10, 20, 40]
    runs = range(n_runs) if n_runs else (range(1) if quick else range(5))
    # dtype="float32" routes the sketch through the hand-written kernels
    # (fused plans, hashed rows); None keeps the f64 accuracy default.
    # Recorded per row for provenance, as the JAX package writes it.
    tdtype = tasks.torch_dtype(dtype)
    compiled = tdtype is not None
    exp = _exp(out, "frostt")

    def sample_error_func(tt, tensor):
        return sample_error(tt, tensor, n_samples=10_000, seed=0)

    for name in names:
        try:
            # The f32 path sketches through the fused plans, built on the
            # host at load
            tensor = load_frostt(
                name, cache_dir=cache_dir, download=False,
                psi_plan=tdtype is not None,
                plan_kwargs=dict(threshold=16) if tdtype is not None else None,
            )
        except (FileNotFoundError, KeyError) as e:
            print(f"[frostt] skipping {name!r}: {e}")
            continue
        if tdtype is not None:
            # cast once per dataset; the indices stay int64 in the port
            tensor = tensor.astype(tdtype, index_dtype=torch.int32)
        grid = list(itertools.product(ranks, runs))
        for rank, run in _maybe_tqdm(grid, f"frostt-{name}", progress):
            # SparseGaussianDRM on both sides like the reference
            # (scripts/frostt.py:101-104)
            exp.run(
                tensor, "STTA", tasks.experiment_stream_sketch,
                left_rank=rank, right_rank=2 * rank,
                left_drm_type=SparseGaussianDRM,
                right_drm_type=SparseGaussianDRM,
                error_func=sample_error_func, dtype=tdtype,
                compile=compiled,
                dataset=name, run=run, seed=_seed_for(rank, run, 18),
            )
            exp.run(
                tensor, "HMT", tasks.experiment_hmt_sketch,
                rank=rank, drm_type=SparseGaussianDRM,
                error_func=sample_error_func, dtype=tdtype,
                dataset=name, run=run, seed=_seed_for(rank, run, 19),
            )
    return exp


def run_cookie(out: str = "results", quick: bool = False, progress=True):
    """TT-GMRES on the synthetic cookie problem: sketch vs pairwise
    rounding x max_rank sweep (do_cookie.py:22-58)."""
    from tt_sketch_torch.solvers.tt_gmres import tt_sum_gmres

    num_coeffs = 4 if quick else 20
    n = 20 if quick else 60
    A, b, precond = problems_cookie(num_coeffs=num_coeffs, n=n)
    # Reference grid (do_cookie.py:91-92): sketch rounding sweeps max_rank
    # 10..100 step 5, pairwise only 10..50 (its SVD cost blows up beyond).
    sketch_ranks = [8] if quick else list(range(10, 101, 5))
    pairwise_ranks = [8] if quick else list(range(10, 51, 5))
    maxiter = 8 if quick else 50
    runs = range(1) if quick else range(20)  # do_cookie.py:94: 20 runs
    final_round_ranks = (4, 8) if quick else tuple(range(10, 101, 5))
    exp = _exp(out, "cookie")

    def gmres_task(_input, rounding_method=None, max_rank=None, seed=0, **kw):
        import json
        import time

        from tt_sketch_torch.solvers.tt_gmres import round_tt_sum

        start = time.perf_counter()
        x, history = tt_sum_gmres(
            A, b, max_rank=max_rank, precond=precond, maxiter=maxiter,
            rounding_method=rounding_method, seed=seed, save_basis=True,
        )
        time_taken = time.perf_counter() - start
        row = {
            "error": float(history["residual_norm"][-1]),
            "time_taken": time_taken,
            "iterations": len(history["residual_norm"]),
            "final_rank": max(x.rank),
        }
        # Final-rounding rank sweep (reference do_cookie.py:66-85): round
        # the UN-rounded solution sum at each target rank with each final
        # method and record the true residual of the rounded solution.
        solution = history["solution_sum"]
        row["final_round_ranks"] = json.dumps(list(final_round_ranks))
        for fm in ("sketch", "pairwise"):
            errs, times = [], []
            for fr in final_round_ranks:
                t0 = time.perf_counter()
                xr = round_tt_sum(solution, fr, method=fm, seed=seed + fr)
                times.append(round(time.perf_counter() - t0, 4))
                errs.append(float(A(xr).error(b, relative=True)))
            row[f"final_true_error_{fm}"] = json.dumps(errs)
            row[f"final_round_time_{fm}"] = json.dumps(times)
        return row

    # Run-major like the reference (do_cookie.py:97-125): each completed
    # run covers the full (method, rank) grid, so a partial sweep is usable.
    grid = [
        (rounding, max_rank, run)
        for run in runs
        for rounding, ranks in (
            ("sketch", sketch_ranks), ("pairwise", pairwise_ranks),
        )
        for max_rank in ranks
    ]
    for rounding, max_rank, run in _maybe_tqdm(grid, "cookie-GMRES", progress):
        exp.run(
            None, f"GMRES-{rounding}", gmres_task,
            rounding_method=rounding, max_rank=max_rank, run=run,
            seed=_seed_for(max_rank, run, 12),
        )
    return exp


def problems_cookie(num_coeffs: int, n: int, device=None):
    from tt_sketch_torch.solvers.parametric import (
        prepare_synthetic_cookie_problem,
    )

    return prepare_synthetic_cookie_problem(num_coeffs=num_coeffs, n=n,
                                            device=device)


DRIVERS: Dict[str, object] = {
    "hilbert": run_hilbert,
    "sqrt": run_sqrt,
    "tt_sum": run_tt_sum,
    "tt_plus_sparse": run_tt_plus_sparse,
    "cp": run_cp,
    "dimension_scaling": run_dimension_scaling,
    "dimension_scaling_gaussian": run_dimension_scaling_gaussian,
    "timings": run_timings,
    "timings_vs_error": run_timings_vs_error,
    "frostt": run_frostt,
    "right_oversampling": run_right_oversampling,
    "recompression": run_recompression,
    "cookie": run_cookie,
}


def available_experiments() -> List[str]:
    return sorted(DRIVERS)
