"""The inputs of a configuration, made or read by the benchmark from the
seed: ``inputs/<kind>.py`` for the configuration's ``kind``, whose
``make(config, seed, devices, root)`` returns a dict with

- ``raw``: what the benchmark made or read, which the references read;
- ``program``: what the program made from it (a tensor with its plans),
  freed before the check.

``devices`` are the cell's cards (``chips`` of its entry); ``root`` is the
checkout, which relative files of a configuration lie under.
"""
from __future__ import annotations

import importlib
from pathlib import Path


def make(config: dict, seed: int, devices, root: Path) -> dict:
    kind = importlib.import_module(f"ttbench.inputs.{config['kind']}")
    return kind.make(config, seed, devices, root)
