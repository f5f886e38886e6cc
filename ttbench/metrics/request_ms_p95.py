"""95th percentile of the host-clock time of every request of the window:
from the request's call to its TT cores complete on the cards, on which the
host waits (what a caller waits)."""
import numpy as np


def read(run):
    ms = [r["ms"] for r in run.records]
    return float(np.percentile(ms, 95)) if ms else None
