"""Host seconds from the start of the process to the first timed request:
imports, the card's context, the kernels loaded (built on a checkout's
first run), the inputs made or read, the warm-up requests."""


def read(run):
    return run.setup_s
