"""The dense slab stream: ``slab_stream_sketch`` over the configuration's
slabs (bisect engine, ``projector="auto"``, the pivot of the slab's 2-D
view), then ``SketchedTensorTrain.to_tt()``.

A request's TT-DRM cores are drawn by the benchmark on the device from the
request's seed (``reference.dense_stream.drm_cores``) and handed to the
program's ``TensorTrainDRM``, so the request times the stream and the
recovery, not the host's draw of the cores.
"""
from __future__ import annotations

import time

from ttbench.reference import dense_stream
from ttbench.work import counts


def request(inputs, config, traffic, seed, clock):
    from tt_sketch_torch.drm import TensorTrainDRM
    from tt_sketch_torch.engine.sketch import SketchedTensorTrain
    from tt_sketch_torch.kernels.dense_engine import slab_stream_sketch

    shape = tuple(int(n) for n in config["shape"])
    pool = inputs["raw"]["pool"]
    lr, rr = int(traffic["left_rank"]), int(traffic["right_rank"])
    lc, rc = dense_stream.drm_cores(shape, lr, rr, seed, pool[0].device)
    ld = TensorTrainDRM(lr, shape, transpose=False, cores=lc)
    rd = TensorTrainDRM(rr, shape, transpose=True, cores=rc)
    t0 = time.perf_counter()
    container = slab_stream_sketch(
        lambda i: pool[i % len(pool)], int(config["n_slabs"]), shape,
        ld.cores, rd.cores, engine="bisect", projector="auto",
        pivot=int(config["pivot"]))
    enqueue_s = time.perf_counter() - t0
    mid = clock.stage()
    tt = SketchedTensorTrain(container, ld, rd).to_tt()
    return {"sketch": (container.Psi_cores, container.Omega_mats),
            "tt": tt.cores, "enqueue_s": enqueue_s, "mid": mid}


def reference(inputs, config, traffic, seed, precision):
    shape = tuple(int(n) for n in config["shape"])
    pool = inputs["raw"]["pool"]
    s0 = shape[0] // int(config["n_slabs"])
    lc, rc = dense_stream.drm_cores(shape, int(traffic["left_rank"]),
                                    int(traffic["right_rank"]), seed,
                                    pool[0].device)
    psis, omegas = dense_stream.sketch(
        lambda i: pool[i % len(pool)].reshape((s0,) + shape[1:]),
        int(config["n_slabs"]), shape, lc, rc, precision)
    return {"sketch": (psis, omegas),
            "tt": dense_stream.recover(psis, omegas, precision)}


def work(config, traffic):
    return counts.dense_stream(config["shape"], int(traffic["left_rank"]),
                               int(traffic["right_rank"]))
