"""Training dashboards (rebuild of reference train_model.py:102-152), a
copy of leafgrasp_tpu/training/plots.py. matplotlib is imported inside
the function that draws, so importing this module needs none.

2x2 matplotlib figure: loss curves, class-wise accuracy, precision/
recall, F1 -- written as ``training_metrics.png``.
"""

from __future__ import annotations

import os
from typing import Dict, List

__all__ = ["plot_metrics"]


def plot_metrics(history: Dict[str, list], save_dir: str,
                 filename: str = "training_metrics.png") -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    train_losses = history["train_loss"]
    val_losses = history["val_loss"]
    metrics: List[Dict] = history["metrics"]
    epochs = range(len(metrics))

    fig, ((ax1, ax2), (ax3, ax4)) = plt.subplots(2, 2, figsize=(15, 10))

    ax1.plot(train_losses, label="Training Loss")
    ax1.plot(val_losses, label="Validation Loss")
    ax1.set_title("Loss Curves")
    ax1.set_xlabel("Epoch")
    ax1.set_ylabel("Loss")
    ax1.legend()
    ax1.grid(True)

    ax2.plot(epochs, [m["positive_accuracy"] for m in metrics],
             label="Positive")
    ax2.plot(epochs, [m["negative_accuracy"] for m in metrics],
             label="Negative")
    ax2.set_title("Class-wise Accuracy")
    ax2.set_xlabel("Epoch")
    ax2.set_ylabel("Accuracy (%)")
    ax2.legend()
    ax2.grid(True)

    ax3.plot(epochs, [m["precision"] for m in metrics], label="Precision")
    ax3.plot(epochs, [m["recall"] for m in metrics], label="Recall")
    ax3.set_title("Precision-Recall Curves")
    ax3.set_xlabel("Epoch")
    ax3.set_ylabel("Percentage")
    ax3.legend()
    ax3.grid(True)

    ax4.plot(epochs, [m["f1_score"] for m in metrics], label="F1 Score")
    ax4.set_title("F1 Score")
    ax4.set_xlabel("Epoch")
    ax4.set_ylabel("Score")
    ax4.legend()
    ax4.grid(True)

    os.makedirs(save_dir, exist_ok=True)
    plt.tight_layout()
    path = os.path.join(save_dir, filename)
    plt.savefig(path)
    plt.close(fig)
    return path
