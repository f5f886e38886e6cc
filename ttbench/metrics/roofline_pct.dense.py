"""The request's least time by the roofline over the device time of its
kernels, copies and memsets (profiler), in percent (``roofline.py``)."""
from ttbench.metrics.roofline import share


def read(run):
    return share(run)
