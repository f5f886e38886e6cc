from tt_sketch_torch.engine.dispatch import SketchMethod, general_sketch  # noqa: F401
from tt_sketch_torch.engine.sketch import (  # noqa: F401
    SketchedTensorTrain,
    assemble_sketched_tt,
    stream_sketch,
)
from tt_sketch_torch.engine.sketch_container import SketchContainer  # noqa: F401
