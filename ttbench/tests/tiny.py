"""Tiny versions of the benchmark's cells, for the CPU tests: the real
entries of BENCHMARK.json with their configurations and traffic cut to
shapes a test run holds (the program runs its plain versions there)."""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ttbench import harness

ROOT = harness.HERE.parent
SHAPE = (11, 9, 30, 25)  # threshold 12 plans modes 2 and 3, as uber's
NNZ = 3000

TRAFFIC = {
    "dense-1e10.stream": {"left_rank": 3, "right_rank": 4},
    "frostt-uber.stta": {"left_rank": 3, "right_rank": 5},
    "frostt-uber.stta-sign": {"left_rank": 3, "right_rank": 5},
    "frostt-uber.hmt": {"rank": 3},
}
CELLS = tuple(TRAFFIC)


def manifest() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


def write_coo(folder: Path, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, n, NNZ) for n in SHAPE]).astype(np.int64)
    np.savez(folder / "tiny.npz", indices=idx,
             entries=rng.standard_normal(NNZ), shape=np.asarray(SHAPE))


def cell(name: str) -> harness.Cell:
    """The cell ``name`` at a tiny size; its COO file is ``tiny.npz`` in
    the folder handed to ``harness.run`` as ``repo``."""
    m = manifest()
    entry = {w["name"]: w for w in m["workloads"]}[name]
    config = harness.load_json(harness.HERE / "configs" /
                               f"{entry['config']}.json")
    if config["kind"] == "dense_tt_pool":
        config.update(shape=[8, 6, 5, 7], n_slabs=2, pivot=1, pool_slabs=2,
                      data_rank=2)
    else:
        config.update(file="tiny.npz", shape=list(SHAPE), nnz=NNZ,
                      plan={"threshold": 12})
    traffic = harness.load_json(harness.HERE / "traffic" / f"{name}.json")
    traffic.update(TRAFFIC[name], trace_requests=2)
    return harness.Cell(m, name, config=config, traffic=traffic)
