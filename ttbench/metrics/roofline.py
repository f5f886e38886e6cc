"""Shared arithmetic of the roofline shares: a request's least time on
the card (the larger of its bytes over 3.35 TB/s and its flops over 495
TFLOP/s, the H100 SXM's HBM bandwidth and TF32 tensor-core peak, NVIDIA's
data sheet) times the traced requests, over the device's busy time in the
trace (union of kernels, copies and memsets), in percent."""
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 495e12


def least_s(work):
    return max(work["bytes"] / PEAK_BYTES_PER_S, work["flops"] / PEAK_FLOPS)


def share(run):
    t = run.trace
    if not t or t.busy_s <= 0:
        return None
    return 100.0 * least_s(run.work) * t.n_requests / t.busy_s
