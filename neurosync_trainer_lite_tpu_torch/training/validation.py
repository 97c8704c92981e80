"""Per-epoch validation inference and its artifacts (port of
neurosync_trainer_lite_tpu/training/validation.py; reference:
utils/validation.py:14-42).

After each epoch: chunked inference on the fixed held-out wav on the
model's device, the generated LiveLink CSV, the JawOpen comparison plot
(skipped without matplotlib) and the overall + per-dimension stats file.
"""

from __future__ import annotations

import os

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.data.processing import (
    extract_audio_features,
)
from neurosync_trainer_lite_tpu_torch.inference.chunked import (
    process_audio_features,
)
from neurosync_trainer_lite_tpu_torch.utils.csv_io import (
    plot_comparison,
    save_generated_data_as_csv,
)
from neurosync_trainer_lite_tpu_torch.utils.device import module_device
from neurosync_trainer_lite_tpu_torch.utils.stats import save_comparison_stats


def generate_and_save_facial_data(epoch: int, audio_path: str, model,
                                  ground_truth_path: str, cfg: Config,
                                  base_dir: str | None = None) -> str:
    """Returns the generated CSV path. The model decodes without dropout
    (no generator), whatever its train/eval mode."""
    audio_features, _ = extract_audio_features(audio_path, sr=cfg.sr,
                                               device=module_device(model))
    generated = process_audio_features(audio_features, model, cfg)

    base_dir = base_dir or cfg.plots_dir
    stats_dir = os.path.join(base_dir, "stats")
    os.makedirs(stats_dir, exist_ok=True)

    output_csv_path = os.path.join(
        base_dir, f"generated_facial_data_epoch_{epoch + 1}.csv")
    save_generated_data_as_csv(generated, output_csv_path)
    plot_comparison(ground_truth_path, output_csv_path, os.path.join(
        base_dir, f"comparison_plot_epoch_{epoch + 1}.jpg"))
    save_comparison_stats(output_csv_path, ground_truth_path, os.path.join(
        stats_dir, f"comparison_stats_epoch_{epoch + 1}.txt"))
    return output_csv_path
