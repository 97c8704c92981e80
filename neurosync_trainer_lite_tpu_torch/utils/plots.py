"""Per-epoch loss and gradient-norm plots (port of
neurosync_trainer_lite_tpu/utils/plots.py; reference:
utils/training_utils.py:309-332, 370-383).

matplotlib is imported at the first plot, never with the module. Where it
is not installed (a CUDA host may lack it), every plot is skipped with
one warning for the process; the CSVs and stats files the loop writes beside
the plots do not need it.
"""

from __future__ import annotations

import os

_warned_no_matplotlib = False


def pyplot():
    """matplotlib.pyplot on the Agg backend, or None without matplotlib."""
    global _warned_no_matplotlib
    try:
        import matplotlib
    except ImportError:
        if not _warned_no_matplotlib:
            _warned_no_matplotlib = True
            print("WARNING: matplotlib is not installed — skipping the loss, "
                  "gradient-norm and comparison plots (CSVs and stats files "
                  "are still written)")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_loss_plot(epoch, train_steps, train_losses, val_steps, val_losses,
                   save_dir="dataset/validation_plots/loss"):
    plt = pyplot()
    if plt is None:
        return
    os.makedirs(save_dir, exist_ok=True)
    plt.figure(figsize=(10, 6))
    plt.plot(train_steps, train_losses, label="Training Loss",
             marker="o", markersize=3)
    plt.plot(val_steps, val_losses, label="Validation Loss",
             marker="x", markersize=8, linestyle="--")
    plt.xlabel("Training Step")
    plt.ylabel("Loss")
    plt.title(f"Loss Values (Epoch {epoch + 1})")
    plt.legend()
    plt.grid(True)
    plot_path = os.path.join(save_dir, f"loss_epoch_{epoch + 1}.png")
    plt.savefig(plot_path)
    plt.close()
    print(f"Loss plot saved to {plot_path}")


def save_gradient_norm_plot(epoch, gradient_norms,
                            save_dir="dataset/validation_plots/gradient_norms"):
    plt = pyplot()
    if plt is None:
        return
    os.makedirs(save_dir, exist_ok=True)
    plt.figure(figsize=(10, 6))
    plt.plot(gradient_norms, label="Gradient Norm")
    plt.xlabel("Batch Index")
    plt.ylabel("Gradient Norm")
    plt.title(f"Gradient Norm Fluctuations (Epoch {epoch + 1})")
    plt.legend()
    plt.grid(True)
    plot_path = os.path.join(save_dir, f"gradient_norms_epoch_{epoch + 1}.png")
    plt.savefig(plot_path)
    plt.close()
    print(f"Gradient norm plot saved to {plot_path}")
