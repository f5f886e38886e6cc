"""Device operations (kernels, copies, memsets) a request, counted in the
profiler's trace of the traced requests, whatever their names."""


def read(run):
    t = run.trace
    return t.device_events / t.n_requests if t and t.n_requests else None
