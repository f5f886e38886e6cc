from tt_sketch_torch.drm.base import (  # noqa: F401
    DRM,
    CanIncreaseRank,
    CanSlice,
    CansketchCP,
    CansketchDense,
    CansketchSparse,
    CansketchTT,
    CansketchTucker,
    handle_transpose,
)
from tt_sketch_torch.drm.tensor_train_drm import TensorTrainDRM  # noqa: F401
