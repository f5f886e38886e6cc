"""tt_sketch_torch — the PyTorch/CUDA port of ``tt_sketch_tpu``.

Tensor-train sketching of dense, TT, CP, Tucker, sparse COO tensors and
lazy sums of them with TT-DRMs, dense Gaussian, lazy-Gaussian and
sparse-sign DRMs: the streaming sketch (STTA) with the recovery of its TT
cores, its blocked form and rank growth, and the sequential sweeps
``hmt_sketch`` and ``orthogonal_sketch`` (OTTS).  The dense slab stream's
one-pass projection runs a hand-written Hopper kernel
(``csrc/dual_project.cu``); the sparse sketches run the row generators
(``csrc/lazy_gaussian.cu``, ``csrc/sparse_sign.cu``), the Ψ/Ω kernels over
hashed or given rows, among them the aligned-window kernel of giant modes
(``csrc/sparse_psi.cu``), and the sparse chain step of the sequential
sweeps and of a TT-DRM (``csrc/chain_step.cu``).  TT rounding, TT-SVD and
sketched TT-GMRES (``solvers/``) are ``einsum``s, QRs and SVDs, and so is
the engine of uniform TTs that runs the order-scaling experiment
(``engine/uniform.py``).  ``StreamingSketchSession`` streams pieces with
atomic checkpoints (``serialization``: the JAX package's ``.npz`` layout);
``profiling`` has a trace context, stage timers and memory statistics;
``dist`` shards the sketches over ``torch.distributed``; ``experiments``
runs the resumable sweeps and their CLI (``python -m
tt_sketch_torch.experiments``), and ``data.frostt`` loads, parses and
synthesizes the FROSTT tensors.
Public names mirror ``tt_sketch_tpu``::

    from tt_sketch_torch import stream_sketch, TensorTrain, DenseTensor

Entry points run on ``"cuda"`` unless given ``device=`` or after
``tt_sketch_torch.config.set_default_device("cpu")``.
"""
from tt_sketch_torch.utils import (  # noqa: F401
    dematricize,
    hilbert_tensor,
    matricize,
    power_decay_tensor,
    process_tt_rank,
    sqrt_tensor,
    trim_ranks,
)

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy imports keep `import tt_sketch_torch` light.
    from importlib import import_module

    _API = {
        "Tensor": "tt_sketch_torch.formats.base",
        "DenseTensor": "tt_sketch_torch.formats.dense",
        "TensorTrain": "tt_sketch_torch.formats.tensor_train",
        "SparseTensor": "tt_sketch_torch.formats.sparse",
        "TensorSum": "tt_sketch_torch.formats.tensor_sum",
        "CPTensor": "tt_sketch_torch.formats.cp",
        "TuckerTensor": "tt_sketch_torch.formats.tucker",
        "stream_sketch": "tt_sketch_torch.engine.sketch",
        "hmt_sketch": "tt_sketch_torch.engine.sketch",
        "orthogonal_sketch": "tt_sketch_torch.engine.sketch",
        "blocked_stream_sketch": "tt_sketch_torch.engine.sketch",
        "get_drm_capabilities": "tt_sketch_torch.engine.sketch",
        "assemble_sketched_tt": "tt_sketch_torch.engine.sketch",
        "SketchedTensorTrain": "tt_sketch_torch.engine.sketch",
        "SketchContainer": "tt_sketch_torch.engine.sketch_container",
        "general_sketch": "tt_sketch_torch.engine.dispatch",
        "SketchMethod": "tt_sketch_torch.engine.dispatch",
        "TensorTrainDRM": "tt_sketch_torch.drm",
        "SparseGaussianDRM": "tt_sketch_torch.drm",
        "SparseSignDRM": "tt_sketch_torch.drm",
        "DenseGaussianDRM": "tt_sketch_torch.drm",
        "ALL_DRM": "tt_sketch_torch.drm",
        "build_psi_plan": "tt_sketch_torch.kernels.sparse_plan",
        "load_frostt": "tt_sketch_torch.data.frostt",
        "Experiment": "tt_sketch_torch.experiments.runner",
        "sample_error": "tt_sketch_torch.data.frostt",
        "dense_stream_sketch_bisect": "tt_sketch_torch.kernels.dense_engine",
        "slab_stream_sketch": "tt_sketch_torch.kernels.dense_engine",
        "tt_svd": "tt_sketch_torch.solvers.tt_svd",
        "MPO": "tt_sketch_torch.solvers.tt_gmres",
        "TTLinearMap": "tt_sketch_torch.solvers.tt_gmres",
        "TTLinearMapSum": "tt_sketch_torch.solvers.tt_gmres",
        "TTPrecond": "tt_sketch_torch.solvers.tt_gmres",
        "round_tt_sum": "tt_sketch_torch.solvers.tt_gmres",
        "tt_sum_gmres": "tt_sketch_torch.solvers.tt_gmres",
        "StreamingSketchSession": "tt_sketch_torch.streaming",
        "save_sketch": "tt_sketch_torch.serialization",
        "load_sketch": "tt_sketch_torch.serialization",
        "save_tt": "tt_sketch_torch.serialization",
        "load_tt": "tt_sketch_torch.serialization",
        "uniform_stream_sketch": "tt_sketch_torch.engine.uniform",
        "uniform_hmt_sketch": "tt_sketch_torch.engine.uniform",
        "StageTimer": "tt_sketch_torch.profiling",
    }
    if name in _API:
        return getattr(import_module(_API[name]), name)
    raise AttributeError(f"module 'tt_sketch_torch' has no attribute '{name}'")
