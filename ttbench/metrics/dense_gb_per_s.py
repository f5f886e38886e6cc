"""float32 bytes of every slab of every stream completed in the window,
over the window's seconds (host clock; the window closes with its last
request)."""
from ttbench.work.counts import F32, prod


def read(run):
    done = sum(not r["failed"] for r in run.records)
    return F32 * prod(run.cell.config["shape"]) * done / run.window_s / 1e9
