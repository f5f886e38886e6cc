"""Time variants of ``tt_sketch_torch/csrc/sparse_psi.cu`` against each
other on one card, in turns, at the calls the sparse main paths make.

Put each variant's full source under ``build/exp/<tag>.cu`` (``build/`` is
git-ignored), then run from the repo root on a machine with a card::

    python3 tools/sparse_psi_ab.py [seq]

Each variant is built with the package's nvcc flags; the uber and lbnl
STTA paths of ``chip_smoke.py`` (and with ``seq`` uber's OTTS and HMT) are
run once through the package's own kernels to record their calls; then
every variant in turn, the list forward and back, checks the first
recorded call of each kernel against its plain version and times all of
them (``chip_smoke.time_ms``).  A variant whose tag starts with ``x_`` is
a diagnostic that computes something else (a phase switched off): it is
timed and not checked.  The last lines give, per kernel and path, each
variant's ms for one sketch's launches in both turns.
"""
import ctypes
import glob
import subprocess
import sys

sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from tt_sketch_torch import SparseGaussianDRM, SparseSignDRM  # noqa: E402
from tt_sketch_torch.kernels import cuda_build  # noqa: E402
from tt_sketch_torch.kernels import sparse_psi as SP  # noqa: E402

NAMES = ("psi_omega_merged_slabs", "omega_fused", "psi_fused_slabs",
         "psi_window_direct", "psi_chunk_slabs", "psi_chunk_slabs_genright")


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
                if "Used" in line or "spill stores" in line]
        print(f"# build {v}", *regs, sep="\n#   ")


def main():
    if not torch.cuda.is_available():
        sys.exit("sparse_psi_ab: no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    variants = sorted(glob.glob("build/exp/*.cu"))
    build(variants)
    print(f"# card: {c.phase_build()}")
    u = c.load_sparse("uber-synthetic")
    paths = {
        "uber gauss": c.phase_sparse_main("uber gauss", u, SparseGaussianDRM,
                                          groups=1),
        "uber sign": c.phase_sparse_main("uber sign", u, SparseSignDRM,
                                         groups=1)}
    if "seq" in sys.argv[1:]:
        for label in ("uber otts gauss", "uber hmt gauss"):
            paths[label] = c.phase_seq_main(label, u, groups=1)
    del u
    lb = c.load_sparse("lbnl-synthetic")
    for label, drm in (("lbnl gauss", SparseGaussianDRM),
                       ("lbnl sign", SparseSignDRM)):
        paths[label] = c.phase_sparse_main(label, lb, drm, groups=1)
    del lb
    fns = c._kernel_fns()
    res = {}
    for v in variants + variants[::-1]:
        cuda_build.load_library = lambda name, v=v: ctypes.CDLL(v[:-3] + ".so")
        SP._library.cache_clear()
        for name in NAMES:
            kern, plain = fns[name]
            for label, m in paths.items():
                calls = m["calls"].get(name, [])
                if not calls:
                    continue
                if not v.split("/")[-1].startswith("x_"):
                    c._check(name, f"{v} {label}", calls[0], phase="ab")
                ms = c.time_ms(lambda: [kern(*a) for a in calls])
                res.setdefault((name, label), {}).setdefault(v, []).append(ms)
    print("# A/B (ms per sketch's launches, two turns):")
    for (name, label), d in res.items():
        print(f"# {name:26s} {label:16s} " + "  ".join(
            f"{v.split('/')[-1][:-3]}: " + "/".join(f"{x:.3f}" for x in xs)
            for v, xs in d.items()))


if __name__ == "__main__":
    main()
