"""Nonzeros of every sketch completed in the window (each sketches all of
the tensor's nonzeros once), over the window's seconds (host clock)."""


def read(run):
    done = sum(not r["failed"] for r in run.records)
    return int(run.cell.config["nnz"]) * done / run.window_s
