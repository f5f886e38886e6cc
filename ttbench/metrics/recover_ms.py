"""Host-clock time of the recovery, in the window of a traced run, which
waits for the cards at the end of each request's sketch: from there to the
TT cores complete, summed over the window's requests and divided by their
number."""


def read(run):
    ms = [r["recover_ms"] for r in run.records if r["recover_ms"] is not None]
    return sum(ms) / len(ms) if ms else None
