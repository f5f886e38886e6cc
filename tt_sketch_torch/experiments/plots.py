"""Plot rendering for experiment CSVs (counterpart of
``tt_sketch_tpu/experiments/plots.py``; host only: pandas and matplotlib are
imported where they are used, and nothing on the card's path imports this
module).

One generic renderer covers the paper's figure families:

- error-vs-rank quantile bands per method (hilbert/sqrt/tt_sum/cp/…)
- error- and time-vs-order for the dimension-scaling sweep
- error-vs-right-rank for the oversampling sweep
- time-vs-error Pareto for the cookie GMRES sweep

CLI: ``python -m tt_sketch_torch.experiments plot <name> [--out results]`` —
renders ``<out>/<name>.csv`` to ``<out>/<name>.png``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def _quantile_band(ax, sub, x_col: str, label: str):
    grouped = sub.groupby(x_col)["error"]
    x = np.array(sorted(grouped.groups))
    med = grouped.median().loc[x]
    lo = grouped.quantile(0.2).loc[x]
    hi = grouped.quantile(0.8).loc[x]
    (line,) = ax.plot(x, med, marker="o", ms=3, label=label)
    ax.fill_between(x, lo, hi, alpha=0.2, color=line.get_color())


def plot_error_vs(csv_path: Path, x_col: str, x_label: str,
                  out_path: Optional[Path] = None, logx: bool = False):
    import matplotlib
    import pandas as pd

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    df = pd.read_csv(csv_path)
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, sub in df.groupby("name"):
        # HMT / TT-SVD sweeps record their rank in 'rank', two-sided ones
        # in x_col (usually 'left_rank'); pick whichever this method filled
        col = x_col
        if col not in sub or sub[col].isna().all():
            col = "rank"
        if col not in sub:
            continue
        sub = sub.dropna(subset=[col])
        if sub.empty:
            continue
        _quantile_band(ax, sub, col, str(name))
    ax.set_yscale("log")
    if logx:
        ax.set_xscale("log")
    ax.set_xlabel(x_label)
    ax.set_ylabel("relative error")
    ax.legend(fontsize=8)
    ax.set_title(csv_path.stem)
    fig.tight_layout()
    out_path = out_path or csv_path.with_suffix(".png")
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_pareto(csv_path: Path, out_path: Optional[Path] = None):
    """time-vs-error scatter (cookie GMRES / timings style)."""
    import matplotlib
    import pandas as pd

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    df = pd.read_csv(csv_path)
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, sub in df.groupby("name"):
        ax.scatter(sub["time_taken"], sub["error"], s=14, label=str(name))
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("wall time [s]")
    ax.set_ylabel("residual / relative error")
    ax.legend(fontsize=8)
    ax.set_title(csv_path.stem)
    fig.tight_layout()
    out_path = out_path or csv_path.with_suffix(".png")
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


#: experiment name -> (x column, x label, log-x)
_PLOT_CONFIG = {
    "hilbert": ("left_rank", "TT rank", False),
    "sqrt": ("left_rank", "TT rank", False),
    "tt_sum": ("left_rank", "TT rank", False),
    "tt_plus_sparse": ("left_rank", "TT rank", False),
    "cp_tensor": ("left_rank", "TT rank", False),
    "cp": ("left_rank", "TT rank", False),
    "dimension_scaling": ("order", "tensor order d", True),
    "dimension_scaling_gaussian": ("n_dims", "tensor order d", True),
    "right_oversampling": ("right_rank", "right sketch rank", False),
    "recompression": ("left_rank", "sketch rank", False),
    "timings": (None, None, False),      # pareto
    "timings_vs_error": (None, None, False),  # pareto
    "cookie": (None, None, False),       # pareto
    "frostt": ("left_rank", "TT rank", False),
}


def render(name: str, out: str = "results") -> Path:
    """Render ``<out>/<name>.csv`` to a figure; returns the png path."""
    csv_map = {"cp": "cp_tensor"}  # driver name -> csv stem
    stem = csv_map.get(name, name)
    csv_path = Path(out) / f"{stem}.csv"
    if not csv_path.exists():
        raise FileNotFoundError(
            f"{csv_path} not found — run `python -m tt_sketch_torch.experiments "
            f"{name}` first"
        )
    cfg = _PLOT_CONFIG.get(stem) or _PLOT_CONFIG.get(name)
    if cfg is None or cfg[0] is None:
        return plot_pareto(csv_path)
    x_col, x_label, logx = cfg
    return plot_error_vs(csv_path, x_col, x_label, logx=logx)
