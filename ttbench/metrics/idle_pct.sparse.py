"""Share of the traced window in which no kernel, copy or memset runs on
the device (the window less the union of their intervals), in percent."""


def read(run):
    t = run.trace
    return 100.0 * t.idle_s / t.window_s if t and t.window_s > 0 else None
