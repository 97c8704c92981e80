"""Offline epoch-trajectory analysis of validation stats files (port of
neurosync_trainer_lite_tpu/utils/epoch_stats.py).

The training loop writes one ``comparison_stats_epoch_N.txt`` per epoch
(utils/stats.py). These helpers parse a directory of them and plot how
overall and per-dimension metrics evolve across epochs (reference:
dataset/validation_plots/py_mapmakers/plot_overall_stats.py:5-57 and
plot_dimension_stats.py:5-76), on one shared parser.

The parser needs only numpy. matplotlib is imported inside the plot
functions, never with the module; a plot is a request of its caller, not a
side product of the loop, so without matplotlib the plot functions raise
ImportError (utils/plots.py, the loop's plots, skips them instead).
"""

from __future__ import annotations

import os
import re

import numpy as np

OVERALL_METRICS = {
    "MAE": "Mean Absolute Error (MAE)",
    "MAPE": "Mean Absolute Percentage Error (MAPE)",
    "MSE": "Mean Squared Error (MSE)",
    "RMSE": "Root Mean Squared Error (RMSE)",
    "r": "Correlation Coefficient (r)",
}
DIMENSION_METRICS = ("MAE", "MAPE", "MSE", "RMSE", "Correlation Coefficient")

_EPOCH_FILE = re.compile(r"comparison_stats_epoch_(\d+)\.txt$")


def find_stats_files(stats_dir: str) -> list[tuple[int, str]]:
    """[(epoch, path)] sorted by epoch."""
    out = []
    for name in os.listdir(stats_dir):
        m = _EPOCH_FILE.search(name)
        if m:
            out.append((int(m.group(1)), os.path.join(stats_dir, name)))
    return sorted(out)


def parse_stats_file(path: str) -> tuple[dict, dict]:
    """One stats txt → (overall: {name: value}, per_dim: {dim: {metric: value}}).

    Parses the exact format written by utils/stats.py:save_comparison_stats
    (mirroring the reference's validation.py:99-137 layout): an overall block
    of ``Name: value`` lines, then per-dimension blocks of an unindented
    ``Dim:`` header followed by indented ``  Metric: value`` lines.
    """
    overall: dict = {}
    per_dim: dict = {}
    current_dim = None
    in_dims = False
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines:
        if not line.strip():
            continue
        if line.startswith("Per-Dimension"):
            in_dims = True
            continue
        if line.startswith("Overall"):
            continue
        if not in_dims:
            name, _, value = line.rpartition(": ")
            if name:
                overall[name] = float(value)
        elif line.startswith("  "):
            name, _, value = line.strip().rpartition(": ")
            if name and current_dim is not None:
                per_dim[current_dim][name] = float(value)
        else:
            current_dim = line.rstrip(":")
            per_dim[current_dim] = {}
    return overall, per_dim


def load_stats_history(stats_dir: str):
    """Directory → (epochs [N], overall {name: [N]}, per_dim {dim: {metric: [N]}}).

    Every series is NaN-padded to exactly N entries so values stay aligned
    with `epochs` — a metric or dimension absent from some file (e.g. an
    older-format epoch) plots as a gap instead of left-shifting the series
    onto the wrong epochs."""
    files = find_stats_files(stats_dir)
    epochs = [e for e, _ in files]
    overall_hist: dict = {}
    dim_hist: dict = {}
    for i, (_, path) in enumerate(files):
        overall, per_dim = parse_stats_file(path)
        for name, value in overall.items():
            overall_hist.setdefault(name, [np.nan] * i).append(value)
        for dim, stats in per_dim.items():
            d = dim_hist.setdefault(dim, {})
            for name, value in stats.items():
                d.setdefault(name, [np.nan] * i).append(value)
        for series in [overall_hist,
                       *(d for d in dim_hist.values())]:
            for vals in series.values():
                if len(vals) < i + 1:
                    vals.append(np.nan)
    return epochs, overall_hist, dim_hist


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plotting epoch stats needs matplotlib, which is not installed; "
            "load_stats_history reads the stats without it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_overall_stats(stats_dir: str, output_path: str | None = None) -> str:
    """Overall metric trajectories across epochs → one PNG

    (reference: plot_overall_stats.py:30-57, one line per metric)."""
    plt = _pyplot()

    epochs, overall_hist, _ = load_stats_history(stats_dir)
    if not epochs:
        raise FileNotFoundError(f"no comparison_stats_epoch_*.txt in {stats_dir}")
    output_path = output_path or os.path.join(stats_dir, "overall_stats.png")

    fig, axes = plt.subplots(len(OVERALL_METRICS), 1,
                             figsize=(10, 3 * len(OVERALL_METRICS)), sharex=True)
    for ax, (short, full) in zip(np.atleast_1d(axes), OVERALL_METRICS.items()):
        values = overall_hist.get(full)
        if values:  # NaN-aligned to epochs; NaNs render as gaps
            ax.plot(epochs, values, marker="o", markersize=3)
        ax.set_ylabel(short)
        ax.grid(True, alpha=0.3)
    np.atleast_1d(axes)[-1].set_xlabel("epoch")
    fig.suptitle("Validation stats across epochs")
    fig.tight_layout()
    fig.savefig(output_path, dpi=100)
    plt.close(fig)
    return output_path


def plot_dimension_stats(stats_dir: str, metric: str = "MAE",
                         dimensions: list[str] | None = None,
                         output_path: str | None = None) -> str:
    """Per-dimension trajectories of one metric across epochs → one PNG

    (reference: plot_dimension_stats.py:33-76, one line per blendshape dim)."""
    if metric not in DIMENSION_METRICS:
        raise ValueError(f"metric must be one of {DIMENSION_METRICS}")
    plt = _pyplot()

    epochs, _, dim_hist = load_stats_history(stats_dir)
    if not epochs:
        raise FileNotFoundError(f"no comparison_stats_epoch_*.txt in {stats_dir}")
    output_path = output_path or os.path.join(
        stats_dir, f"dimension_{metric.replace(' ', '_')}.png")

    fig, ax = plt.subplots(figsize=(12, 7))
    for dim, stats in dim_hist.items():
        if dimensions is not None and dim not in dimensions:
            continue
        values = stats.get(metric)
        if values:  # NaN-aligned to epochs; NaNs render as gaps
            ax.plot(epochs, values, label=dim, linewidth=0.8)
    ax.set_xlabel("epoch")
    ax.set_ylabel(metric)
    ax.set_title(f"Per-dimension {metric} across epochs")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=5, ncol=3, loc="upper right")
    fig.tight_layout()
    fig.savefig(output_path, dpi=100)
    plt.close(fig)
    return output_path
