"""Training history (a copy of ``vit_ssl_tpu/utils/history.py``): metric
series per epoch, and one PNG per metric group in the run directory.

matplotlib is imported inside :meth:`TrainingHistory.vizualize`; on a host
without it the plot raises ``ImportError`` and the trainer logs that it
skipped it. The plots are host-side files, never device work.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Optional


class TrainingHistory:
    def __init__(self, save_path: Optional[str] = None):
        self.history: Dict[str, list] = defaultdict(list)
        self.save_path = save_path

    def update(self, train_metrics: Dict[str, float], val_metrics: Dict[str, float]):
        for name, value in (train_metrics or {}).items():
            self.history[f"train_{name}"].append(float(value))
        for name, value in (val_metrics or {}).items():
            self.history[f"val_{name}"].append(float(value))

    def metric_groups(self) -> Dict[str, Dict[str, list]]:
        groups: Dict[str, Dict[str, list]] = defaultdict(dict)
        for key, series in self.history.items():
            prefix, _, metric = key.partition("_")
            groups[metric][prefix] = series
        return groups

    def vizualize(self, num_epochs: Optional[int] = None):
        """One PNG per metric (train and val curves overlaid)."""
        if not self.save_path or not self.history:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(self.save_path, exist_ok=True)
        for metric, series_by_split in self.metric_groups().items():
            fig, ax = plt.subplots(figsize=(8, 5))
            for split, series in sorted(series_by_split.items()):
                ax.plot(range(1, len(series) + 1), series, label=split)
            ax.set_xlabel("epoch")
            ax.set_ylabel(metric)
            ax.set_title(metric)
            ax.legend()
            fig.tight_layout()
            fig.savefig(os.path.join(self.save_path, f"{metric}.png"), dpi=110)
            plt.close(fig)

    # alias with the conventional spelling; the JAX package's name is kept
    visualize = vizualize
