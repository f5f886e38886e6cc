"""Sharded sketches over ``torch.distributed`` (one process per device) and
the multi-process entry points: the counterpart of ``tt_sketch_tpu/dist``."""
from tt_sketch_torch.dist.multihost import (  # noqa: F401
    global_mesh,
    initialize_multihost,
    make_global,
)
from tt_sketch_torch.dist.sharded import (  # noqa: F401
    make_sharded_sparse_sketcher,
    sharded_dense_stream_sketch,
    sharded_sparse_stream_sketch,
    sharded_tt_sum_stream_sketch,
)
