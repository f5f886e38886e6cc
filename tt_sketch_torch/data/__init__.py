"""Data loaders of the port (FROSTT sparse tensors)."""
from tt_sketch_torch.data.frostt import (
    FROSTT_TENSORS,
    load_frostt,
    parse_tns,
    sample_error,
)

__all__ = ["FROSTT_TENSORS", "load_frostt", "parse_tns", "sample_error"]
