"""Host time in the sketch call (from its call to its return, no
synchronisation), summed over the window's requests and divided by their
number."""


def read(run):
    times = [r["enqueue_s"] for r in run.records if r["enqueue_s"] is not None]
    return 1e3 * sum(times) / len(times) if times else None
