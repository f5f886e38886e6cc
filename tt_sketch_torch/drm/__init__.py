from tt_sketch_torch.drm.base import (  # noqa: F401
    DRM,
    CanIncreaseRank,
    CanSlice,
    CansketchCP,
    CansketchDense,
    CansketchSparse,
    CansketchTT,
    CansketchTucker,
    LazyModeList,
    handle_transpose,
)
from tt_sketch_torch.drm.dense_gaussian_drm import DenseGaussianDRM  # noqa: F401
from tt_sketch_torch.drm.sparse_gaussian_drm import SparseGaussianDRM  # noqa: F401
from tt_sketch_torch.drm.sparse_sign_drm import SparseSignDRM  # noqa: F401
from tt_sketch_torch.drm.tensor_train_drm import TensorTrainDRM  # noqa: F401

ALL_DRM = (DenseGaussianDRM, SparseGaussianDRM, TensorTrainDRM, SparseSignDRM)
