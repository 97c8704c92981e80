"""Validation comparison statistics (port of
neurosync_trainer_lite_tpu/utils/stats.py, without pandas).

Matches the reference's per-epoch stats file (reference:
utils/validation.py:45-137): overall and per-dimension MAE/MAPE/MSE/RMSE and
correlation between a generated LiveLink CSV and the ground-truth CSV, lengths
aligned to the shorter sequence, with the same guarded MAPE (only divide where
|truth| > 1e-6) and guarded correlation (std > 1e-6).
"""

from __future__ import annotations

import numpy as np

from neurosync_trainer_lite_tpu_torch.utils.csv_io import (
    DIMENSION_LABELS,
    read_columns,
)


def compute_comparison_stats(generated: np.ndarray, ground_truth: np.ndarray):
    """Returns (overall: dict, per_dimension: dict of dicts)."""
    min_length = min(generated.shape[0], ground_truth.shape[0])
    generated = generated[:min_length]
    ground_truth = ground_truth[:min_length]

    diff = ground_truth - generated
    abs_diff = np.abs(diff)
    percentage_diff = np.divide(
        abs_diff, np.abs(ground_truth),
        out=np.zeros_like(abs_diff),
        where=np.abs(ground_truth) > 1e-6,
    ) * 100
    percentage_diff = np.nan_to_num(percentage_diff, nan=0.0,
                                    posinf=0.0, neginf=0.0)

    def corr(a, b):
        if np.nanstd(a) > 1e-6 and np.nanstd(b) > 1e-6:
            return np.corrcoef(a, b)[0, 1]
        return float("nan")

    overall = {
        "Mean Absolute Error (MAE)": np.nanmean(abs_diff),
        "Mean Absolute Percentage Error (MAPE)": np.nanmean(percentage_diff),
        "Mean Squared Error (MSE)": np.nanmean(diff ** 2),
        "Root Mean Squared Error (RMSE)": np.sqrt(np.nanmean(diff ** 2)),
        "Correlation Coefficient (r)": corr(generated.flatten(),
                                            ground_truth.flatten()),
    }
    per_dimension = {}
    for i, label in enumerate(DIMENSION_LABELS[: generated.shape[1]]):
        per_dimension[label] = {
            "MAE": np.nanmean(abs_diff[:, i]),
            "MAPE": np.nanmean(percentage_diff[:, i]),
            "MSE": np.nanmean(diff[:, i] ** 2),
            "RMSE": np.sqrt(np.nanmean(diff[:, i] ** 2)),
            "Correlation Coefficient": corr(generated[:, i],
                                            ground_truth[:, i]),
        }
    return overall, per_dimension


def save_comparison_stats(generated_data_path: str, ground_truth_path: str,
                          output_stats_path: str) -> None:
    """CSV paths → stats txt (reference: validation.py:45-137 format). Both
    files are read from column 2 for the 61 blendshapes: a capture CSV may
    carry the 7 emotion columns after them."""
    n = len(DIMENSION_LABELS)
    generated = read_columns(generated_data_path, 2, 2 + n)
    ground_truth = read_columns(ground_truth_path, 2, 2 + n)
    overall, per_dimension = compute_comparison_stats(generated, ground_truth)

    with open(output_stats_path, "w") as f:
        f.write("Overall Comparison Statistics:\n")
        for name, value in overall.items():
            f.write(f"{name}: {value:.4f}\n")
        f.write("\nPer-Dimension Statistics:\n")
        for label, stats in per_dimension.items():
            f.write(f"{label}:\n")
            for name, value in stats.items():
                f.write(f"  {name}: {value:.4f}\n")
    print(f"Comparison statistics saved to {output_stats_path}")
