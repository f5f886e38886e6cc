"""tt_sketch_torch — the PyTorch/CUDA port of ``tt_sketch_tpu``.

Streaming tensor-train sketching (STTA) of dense and TT tensors with
TT-DRMs and of sparse COO tensors with lazy-Gaussian and sparse-sign DRMs,
and recovery of the TT cores.  The dense slab stream's one-pass projection
runs a hand-written Hopper kernel (``csrc/dual_project.cu``); the sparse
sketch runs the row generators (``csrc/lazy_gaussian.cu``,
``csrc/sparse_sign.cu``) and the fused Ψ/Ω kernels, among them the
aligned-window kernel of giant modes (``csrc/sparse_psi.cu``).
Public names mirror ``tt_sketch_tpu``::

    from tt_sketch_torch import stream_sketch, TensorTrain, DenseTensor

Entry points run on ``"cuda"`` unless given ``device=`` or after
``tt_sketch_torch.config.set_default_device("cpu")``.
"""
from tt_sketch_torch.utils import (  # noqa: F401
    dematricize,
    matricize,
    process_tt_rank,
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
        "stream_sketch": "tt_sketch_torch.engine.sketch",
        "assemble_sketched_tt": "tt_sketch_torch.engine.sketch",
        "SketchedTensorTrain": "tt_sketch_torch.engine.sketch",
        "SketchContainer": "tt_sketch_torch.engine.sketch_container",
        "general_sketch": "tt_sketch_torch.engine.dispatch",
        "SketchMethod": "tt_sketch_torch.engine.dispatch",
        "TensorTrainDRM": "tt_sketch_torch.drm",
        "SparseGaussianDRM": "tt_sketch_torch.drm",
        "SparseSignDRM": "tt_sketch_torch.drm",
        "build_psi_plan": "tt_sketch_torch.kernels.sparse_plan",
        "load_frostt": "tt_sketch_torch.data.frostt",
        "sample_error": "tt_sketch_torch.data.frostt",
        "dense_stream_sketch_bisect": "tt_sketch_torch.kernels.dense_engine",
        "slab_stream_sketch": "tt_sketch_torch.kernels.dense_engine",
    }
    if name in _API:
        return getattr(import_module(_API[name]), name)
    raise AttributeError(f"module 'tt_sketch_torch' has no attribute '{name}'")
