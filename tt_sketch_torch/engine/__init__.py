from tt_sketch_torch.engine.dispatch import SketchMethod, general_sketch  # noqa: F401
from tt_sketch_torch.engine.sketch import (  # noqa: F401
    SketchedTensorTrain,
    assemble_sketched_tt,
    blocked_stream_sketch,
    get_drm_capabilities,
    hmt_sketch,
    orthogonal_sketch,
    stream_sketch,
)
from tt_sketch_torch.engine.sketch_container import SketchContainer  # noqa: F401
