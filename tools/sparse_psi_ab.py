"""Time variants of a kernel library of ``tt_sketch_torch/csrc`` against
each other on one card, in turns, at the calls the sparse main paths make.

Put each variant's full source under ``build/exp/<tag>.cu`` (``build/`` is
git-ignored), then run from the repo root on a machine with a card::

    python3 tools/sparse_psi_ab.py [seq] [LIBRARY[:KERNEL,...]]
    python3 tools/sparse_psi_ab.py given|oneside|others [VARIANT.cu ...]

``given``, ``oneside`` and ``others`` take the variants named (default:
every ``build/exp/*.cu``), so that variants can also be timed in
processes of their own, in turns: with several builds of
``sparse_psi.cu`` loaded in one process, a window call has ended in an
illegal instruction on an NVIDIA H100 80GB HBM3, which one build a
process never did (PERF.md §7).  ``LIBRARY`` is ``sparse_psi`` (the default; its
six kernels),
``chain_step`` (``chain_step_t``), ``segment_psi`` (``psi_segment``) or
``sparse_sign`` (``sparse_sign_rows``); ``:KERNEL,...`` times only the
kernels named.  Each variant is built with
the package's nvcc flags.  For ``sparse_psi`` the uber and lbnl STTA paths
of ``chip_smoke.py`` (and with ``seq`` uber's OTTS and HMT) are run once
through the package's own kernels to record their calls; for
``chain_step`` the sequential paths that launch the chain step (uber HMT
Gaussian and TT-DRM, OTTS, lbnl HMT); for ``segment_psi`` every uber path
(STTA with a Gaussian and a sign pair, HMT Gaussian, OTTS, HMT TT-DRM) and
the timed cases of ``chip_smoke.SEGMENT_SHAPES`` (uber's segment shapes
with their indices in runs and at random, mode 1 at ranks 20/40 among
them), one call each (a source without the C queries
``tt_segment_psi_fits`` and ``tt_segment_psi_plan`` needs stubs of them);
for
``sparse_sign`` the uber STTA path with a sign pair and the cases of
``chip_smoke.sign_row_cases`` (odd shapes, the rank buckets' edges, ranks
above 4096), one call each.  ``given`` times the given-rows kernels of
``sparse_psi`` (``psi_chunk_slabs`` and ``psi_chunk_slabs_genright``) at
the calls of the five sequential paths that launch them: uber HMT with a
Gaussian DRM, OTTS and HMT with the default TT-DRM, lbnl HMT, and the
FROSTT driver's nips HMT at rank 20 (``chip_smoke.frostt_hmt_calls``);
per recorded call it adds the kernel's device time from the profiler
(``chip_smoke.device_ms``) and the call's bound.  ``oneside`` does the
same for the one-sided calls of ``psi_fused_slabs`` and
``psi_window_direct`` (a side missing, the other hashed): uber STTA and
lbnl STTA with a Gaussian and with a sign pair, lbnl HMT, and the FROSTT
driver's nips STTA and HMT at rank 20.  ``others`` times, without the
profiler, the calls of the same library that the one-sided instances do
not serve: the two-sided calls of ``psi_fused_slabs`` (uber as a sum of
four planned shards) and of ``psi_window_direct`` (lbnl with the giant
mode rolled inside, as ``chip_smoke.phase_window_kernel``), and
``psi_omega_merged_slabs`` and ``omega_fused`` at the uber and lbnl STTA
paths and uber's rank growth.
Then every variant in turn, the list forward and back, checks every
recorded call of each kernel against its plain version and times each
recorded call (alone, ten back to back, and the host's time to enqueue
it) and all of them (``chip_smoke.time_ms``).  A variant whose
tag starts with ``x_`` is a diagnostic that computes something else (a
phase switched off): it is timed and not checked.  The last lines give,
per kernel and path, each variant's ms for one sketch's launches in both
turns, and before them the same per recorded call.
"""
import ctypes
import glob
import subprocess
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from tt_sketch_torch import SparseGaussianDRM, SparseSignDRM  # noqa: E402
from tt_sketch_torch.kernels import chain_step as CS  # noqa: E402
from tt_sketch_torch.kernels import cuda_build  # noqa: E402
from tt_sketch_torch.kernels import segment_psi as SG  # noqa: E402
from tt_sketch_torch.kernels import sparse_psi as SP  # noqa: E402
from tt_sketch_torch.kernels import sparse_sign as SS  # noqa: E402

#: per library: its wrapper module and the kernels it launches
LIBRARIES = {
    "sparse_psi": (SP, ("psi_omega_merged_slabs", "omega_fused",
                        "psi_fused_slabs", "psi_window_direct",
                        "psi_chunk_slabs", "psi_chunk_slabs_genright")),
    "chain_step": (CS, ("chain_step_t",)),
    "segment_psi": (SG, ("psi_segment",)),
    "sparse_sign": (SS, ("sparse_sign_rows",)),
}
SEQ_LABELS = ("uber otts gauss", "uber hmt gauss", "uber hmt tt")
GIVEN_KERNELS = ("psi_chunk_slabs", "psi_chunk_slabs_genright")


def build(variants):
    nvcc = cuda_build._nvcc()
    procs = [(v, subprocess.Popen(
        [nvcc, *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o",
         v[:-3] + ".so", v], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for v in variants]
    for v, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{v} did not build:\n{out}")
        regs = [line.strip() for line in out.splitlines()
                if "Used" in line or "spill stores" in line
                or "Function properties" in line]
        print(f"# build {v}", *regs, sep="\n#   ")


def main():
    if not torch.cuda.is_available():
        sys.exit("sparse_psi_ab: no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = sys.argv[1:]
    if args and args[0] in ("given", "oneside", "others"):
        {"given": given, "oneside": oneside, "others": others}[args[0]](
            args[1:] or sorted(glob.glob("build/exp/*.cu")))
        return
    seq = "seq" in args
    spec = next((a for a in args if a != "seq"), "sparse_psi")
    lib, _, only = spec.partition(":")
    module, names = LIBRARIES[lib]
    if only:
        names = tuple(n for n in only.split(",") if n in names)
    variants = sorted(glob.glob("build/exp/*.cu"))
    build(variants)
    print(f"# card: {c.phase_build()}")
    stta = lib == "sparse_psi"
    segment = lib == "segment_psi"
    u = c.load_sparse("uber-synthetic")
    paths = {}
    if lib == "sparse_sign":
        paths["uber sign"] = c.phase_sparse_main("uber sign", u,
                                                 SparseSignDRM, groups=1)
        del u
        for label, args in c.sign_row_cases():
            paths[label] = {"calls": {"sparse_sign_rows": [args]}}
        _run(variants, module, names, paths)
        return
    if stta or segment:
        for label, drm in (("uber gauss", SparseGaussianDRM),
                           ("uber sign", SparseSignDRM)):
            paths[label] = c.phase_sparse_main(label, u, drm, groups=1)
    if seq or not stta:
        for label in SEQ_LABELS[:2] if stta else SEQ_LABELS:
            paths[label] = c.phase_seq_main(label, u, timed=False)
    del u
    if segment:
        for label, case, timed in c.SEGMENT_SHAPES:
            if timed:
                paths[label] = {"calls": {"psi_segment": [
                    c.segment_case(*case)]}}
        _run(variants, module, names, paths)
        return
    lb = c.load_sparse("lbnl-synthetic")
    if stta:
        for label, drm in (("lbnl gauss", SparseGaussianDRM),
                           ("lbnl sign", SparseSignDRM)):
            paths[label] = c.phase_sparse_main(label, lb, drm, groups=1)
    else:
        paths["lbnl hmt gauss"] = c.phase_seq_main("lbnl hmt gauss", lb,
                                                   timed=False)
    del lb
    _run(variants, module, names, paths)


def given(variants):
    """The given-rows kernels at the calls of the paths that launch them."""
    build(variants)
    print(f"# card: {c.phase_build()}")
    ops = {"gauss": c.sass_ops_per_sample(), "sign_draw": c.sass_sign_ops()}
    paths = {}
    u = c.load_sparse("uber-synthetic")
    for label in SEQ_LABELS[1::-1] + SEQ_LABELS[2:]:
        paths[label] = c.phase_seq_main(label, u, timed=False)
    del u
    lb = c.load_sparse("lbnl-synthetic")
    paths["lbnl hmt gauss"] = c.phase_seq_main("lbnl hmt gauss", lb,
                                               timed=False)
    del lb
    paths["frostt nips hmt 20"] = c.frostt_hmt_calls("nips-synthetic", 20)
    for label, m in paths.items():
        for name in GIVEN_KERNELS:
            for i, a in enumerate(m["calls"].get(name, [])):
                ts, g, tg, ns, nbytes = c.given_schedule(name, a)
                print(f"# schedule {name} {label} {i}: TS {ts}, G {g}, TG "
                      f"{tg}, ring {ns}, {nbytes} bytes a block")
    _run(variants, SP, GIVEN_KERNELS, paths, ops)


ONESIDE_KERNELS = ("psi_fused_slabs", "psi_window_direct")


def _sides(name, args):
    """(left flats, right flats) of a call of a hashed Ψ kernel."""
    return args[2:4] if name == "psi_fused_slabs" else args[4:6]


def _keep(paths, names, one_sided):
    """Each path's calls of ``names``, only the one-sided ones (a side
    missing) or only the others; paths left with no call are dropped."""
    out = {}
    for label, m in paths.items():
        calls = {}
        for name in names:
            kept = [a for a in m["calls"].get(name, [])
                    if name not in ONESIDE_KERNELS
                    or (None in _sides(name, a)) == one_sided]
            if kept:
                calls[name] = kept
        if calls:
            out[label] = {"calls": calls}
    return out


def frostt_stta_calls(name, rank):
    """The kernel calls of one STTA sketch (``rank``/2``rank``) of the
    FROSTT stand-in ``name`` as ``run_frostt`` makes it (plans at threshold
    16, float32, ``SparseGaussianDRM`` pairs): ``{"calls": ...}``."""
    from tt_sketch_torch import SparseGaussianDRM, stream_sketch
    from tt_sketch_torch.data.frostt import load_frostt

    tensor = load_frostt(name, download=False, psi_plan=True,
                         plan_kwargs=dict(threshold=16), device="cuda")
    tensor = tensor.astype(torch.float32, index_dtype=torch.int32)
    calls = {}
    with c.recording(calls):
        stream_sketch(tensor, rank, 2 * rank, seed=0,
                      left_drm_type=SparseGaussianDRM,
                      right_drm_type=SparseGaussianDRM, dtype=torch.float32)
    torch.cuda.synchronize()
    return {"calls": calls}


def oneside(variants):
    """The one-sided calls of rows 6 and 9 (``psi_fused_slabs``,
    ``psi_window_direct``) at the paths that make them, with each call's
    device time and bound."""
    build(variants)
    print(f"# card: {c.phase_build()}")
    ops = {"gauss": c.sass_ops_per_sample(), "sign_draw": c.sass_sign_ops()}
    paths = {}
    u = c.load_sparse("uber-synthetic")
    for label, drm in (("uber gauss", SparseGaussianDRM),
                       ("uber sign", SparseSignDRM)):
        paths[label] = c.phase_sparse_main(label, u, drm, groups=1)
    del u
    lb = c.load_sparse("lbnl-synthetic")
    for label, drm in (("lbnl gauss", SparseGaussianDRM),
                       ("lbnl sign", SparseSignDRM)):
        paths[label] = c.phase_sparse_main(label, lb, drm, groups=1)
    paths["lbnl hmt gauss"] = c.phase_seq_main("lbnl hmt gauss", lb,
                                               timed=False)
    del lb
    paths["frostt nips stta 20"] = frostt_stta_calls("nips-synthetic", 20)
    paths["frostt nips hmt 20"] = c.frostt_hmt_calls("nips-synthetic", 20)
    paths = _keep(paths, ONESIDE_KERNELS, True)
    for label, m in paths.items():
        for name, calls in m["calls"].items():
            for i, a in enumerate(calls):
                left, right = _sides(name, a)
                bucket, threads, blocks, per = c.oneside_schedule(name, a)
                print(f"# call {name} {label} {i}: "
                      f"{'left' if right is None else 'right'} side only, "
                      f"{_shape(a)}; this tree's instance: bucket {bucket}, "
                      f"{blocks} blocks of {threads} threads"
                      + (f", {per} windows a block" if per else ""))
    _run(variants, SP, ONESIDE_KERNELS, paths, ops)


def others(variants):
    """The calls of ``sparse_psi.cu`` that the one-sided instances do not
    serve: rows 6 and 9 two-sided, rows 7 and 8."""
    from tt_sketch_torch import stream_sketch
    from tt_sketch_torch.formats import SparseTensor

    build(variants)
    print(f"# card: {c.phase_build()}")
    names = ("psi_fused_slabs", "psi_window_direct",
             "psi_omega_merged_slabs", "omega_fused")
    paths = {}
    u = c.load_sparse("uber-synthetic")
    for label, drm in (("uber gauss", SparseGaussianDRM),
                       ("uber sign", SparseSignDRM)):
        paths[label] = c.phase_sparse_main(label, u, drm, groups=1)
    shards, _ = c.split_uber(u)
    for label, drm in (("uber sum gauss", SparseGaussianDRM),
                       ("uber sum sign", SparseSignDRM)):
        calls = {}
        with c.recording(calls):
            stream_sketch(shards, 10, 20, seed=0, left_drm_type=drm,
                          right_drm_type=drm, dtype=torch.float32)
        paths[label] = {"calls": calls}
    del shards
    small = stream_sketch(u, 10, 20, seed=0, left_drm_type=SparseGaussianDRM,
                          right_drm_type=SparseGaussianDRM,
                          dtype=torch.float32)
    calls = {}
    with c.recording(calls):
        small.increase_rank(u, 15, 30)
    paths["uber grow gauss"] = {"calls": calls}
    del u, small
    lb = c.load_sparse("lbnl-synthetic")
    for label, drm in (("lbnl gauss", SparseGaussianDRM),
                       ("lbnl sign", SparseSignDRM)):
        paths[label] = c.phase_sparse_main(label, lb, drm, groups=1)
    del lb
    shape, idx, ent = c.load_lbnl_host()
    order = (3, 4, 0, 1, 2)
    shape = tuple(shape[m] for m in order)
    idx = np.ascontiguousarray(idx[list(order)])
    t = SparseTensor(shape, idx, ent, device="cuda").with_psi_plan(
        indices=idx, entries=ent)
    for label, lt in (("lbnl rolled gauss", SparseGaussianDRM),
                      ("lbnl rolled sign x gauss", SparseSignDRM)):
        calls = {}
        with c.recording(calls):
            stream_sketch(t, 10, 20, seed=3, left_drm_type=lt,
                          right_drm_type=SparseGaussianDRM,
                          dtype=torch.float32)
        paths[label] = {"calls": calls}
    del t
    _run(variants, SP, names, _keep(paths, names, False))


def _use(module, v):
    """Load variant ``v``'s library in place of the package's."""
    cuda_build.load_library = lambda name, v=v: ctypes.CDLL(v[:-3] + ".so")
    module._library.cache_clear()
    SG._blocks.cache_clear()


def _run(variants, module, names, paths, ops=None):
    """Every variant in turn, the list forward and back: check and time
    each kernel of ``names`` at every call recorded in ``paths``; then,
    with ``ops``, print each call's bound and take every variant's device
    time per call under the profiler in a second pass (forward and back),
    after the other tables are printed."""
    fns = c._kernel_fns()
    res, per_call = {}, {}
    for v in variants + variants[::-1]:
        _use(module, v)
        for name in names:
            kern, plain = fns[name]
            for label, m in paths.items():
                calls = m["calls"].get(name, [])
                if not calls:
                    continue
                if not v.split("/")[-1].startswith("x_"):
                    for i, a in enumerate(calls):
                        c._check(name, f"{v} {label} call {i}", a,
                                 phase="ab")
                ms = c.time_ms(lambda: [kern(*a) for a in calls])
                res.setdefault((name, label), {}).setdefault(v, []).append(ms)
                for i, a in enumerate(calls):
                    # alone (the card waits for the host between calls, as
                    # in a sketch), ten back to back (the kernels' time) and
                    # the host's time to enqueue one call
                    one = c.time_ms(lambda: kern(*a))
                    b2b = c.time_ms(lambda: [kern(*a) for _ in range(10)]) / 10
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(20):
                        kern(*a)
                    host = (time.perf_counter() - t0) / 20 * 1e3
                    torch.cuda.synchronize()
                    for how, ms in (("alone", one), ("b2b", b2b),
                                    ("host", host)):
                        per_call.setdefault((name, label, i, _shape(a), how),
                                            {}).setdefault(v, []).append(ms)
    print("# A/B per recorded call (ms, two turns):")
    _table(per_call)
    print("# A/B (ms per sketch's launches, two turns):")
    _table(res)
    if ops is None:
        return
    print("# bounds per recorded call (ms):")
    for name in names:
        for label, m in paths.items():
            for i, a in enumerate(m["calls"].get(name, [])):
                b, by = c.sparse_bound(name, a, ops)
                print(f"# {name} {label} {i} {_shape(a)}  bound {b:.4f} "
                      f"by {by}")
    device = {}
    for v in variants + variants[::-1]:
        _use(module, v)
        for name in names:
            kern = fns[name][0]
            for label, m in paths.items():
                for i, a in enumerate(m["calls"].get(name, [])):
                    device.setdefault((name, label, i, _shape(a), "device"),
                                      {}).setdefault(v, []).append(
                        c.device_ms(lambda: kern(*a)))
    print("# A/B device ms per recorded call (profiler, two turns):")
    _table(device)


def _shape(args):
    """A short description of a call's operand shapes."""
    return " ".join("x".join(map(str, a.shape)) for a in args
                    if isinstance(a, torch.Tensor))


def _table(res):
    for key, d in res.items():
        print("# " + " ".join(f"{k}" for k in key) + "  " + "  ".join(
            f"{v.split('/')[-1][:-3]}: " + "/".join(f"{x:.3f}" for x in xs)
            for v, xs in d.items()))


if __name__ == "__main__":
    main()
