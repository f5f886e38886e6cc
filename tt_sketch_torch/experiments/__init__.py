"""Experiment harness: resumable sweeps over the sketching algorithms
(counterpart of ``tt_sketch_tpu/experiments``).

- ``runner.Experiment`` — CSV-resumable parameter-sweep runner (the
  standard library's ``csv``; it resumes the JAX package's CSVs)
- ``tasks`` — per-algorithm timed experiment functions
- ``problems`` — synthetic benchmark tensors (one per driver)
- ``drivers`` — full sweep configurations; ``python -m
  tt_sketch_torch.experiments <name>`` runs them from the command line
"""
from tt_sketch_torch.experiments.runner import Experiment, timed
from tt_sketch_torch.experiments import problems, tasks
from tt_sketch_torch.experiments.drivers import (
    DRIVERS,
    available_experiments,
)

__all__ = [
    "Experiment",
    "timed",
    "problems",
    "tasks",
    "DRIVERS",
    "available_experiments",
]
