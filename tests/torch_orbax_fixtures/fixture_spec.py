"""What the orbax fixtures beside this file are, with no JAX: their widths
and config overrides, the loaders their runs took, the port's config for
resuming each, and ``leaf_digests``, the form of ``digests.json``.

``make_fixtures.py`` (which drives the JAX package), the tests and
``chip_smoke.py`` (which runs where JAX is not installed) all import this
module; it imports numpy and the standard library only.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
HEAD_HIDDEN = 32
B = 4
IMG = 16
LOCAL_IMG = 8
TINY = [f"data.img_size={IMG}", "model.embed_dim=32", "model.num_heads=2",
        "model.num_blocks=2", "model.mlp_dim=64", "model.dropout=0.0",
        "model.compute_dtype=float32", f"training.batch_size={B}",
        "training.num_epochs=2", "training.warmup_epochs=1",
        "training.warmup_final_learning_rate=1e-2", "training.plain_logging=true",
        "eval.interval=0", "data.device_augment=false"]
# one head of 32 features: the card's attention kernels take head dims 32, 64
# and 128, and chip_smoke.py trains a step from the DINO fixture there
DINO = TINY + [f"data.local_img_size={LOCAL_IMG}", "model.patch_size=8",
               "model.output_dim=64", "model.num_heads=1"]
SUPERVISED = TINY + ["model.patch_size=8", "model.num_classes=3"]
SIMMIM = TINY + ["model.patch_size=4"]
# the port's configs for resuming each fixture: (config name, overrides,
# loader kind); the finetune's pretrained weights are the DINO fixture's
FINETUNE = SUPERVISED + ["training.extended_transfer=true", "training.freeze_backbone=true",
                         "+freeze_backbone_epochs=2",
                         f"training.pretrained_path={HERE / 'dino_step1'}"]
SCAN_SGD = SUPERVISED + ["model.scan_layers=true", "training.optimizer.name=SGD",
                         "+training.optimizer.params.momentum=0.9"]
RESUMES = {
    "dino_step0": ("dino", DINO, "dino"),
    "dino_step1": ("dino", DINO, "dino"),
    "finetune_frozen": ("finetune", FINETUNE, "labeled"),
    "finetune_unfrozen": ("finetune", FINETUNE, "labeled"),
    "simmim": ("simmim", SIMMIM, "images"),
    "supervised_scan_sgd_preempt": ("supervised", SCAN_SGD, "labeled"),
}


def leaf_digests(tree, prefix=""):
    """{dotted path: {"dtype", "shape", "sha256"}} of a restored tree's array
    leaves (None, empty containers and Python numbers are recorded too)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaf_digests(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(leaf_digests(v, f"{prefix}{i}."))
    elif tree is None or isinstance(tree, (int, float)):
        out[prefix[:-1]] = {"value": tree}
    else:
        a = np.asarray(tree)
        out[prefix[:-1]] = {"dtype": str(a.dtype), "shape": list(a.shape),
                            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


class Batches:
    """``n`` batches drawn with numpy from (seed, epoch): ``kind`` "dino"
    (2 globals of :data:`IMG` px, 4 locals of :data:`LOCAL_IMG` px),
    "labeled" or "images"."""

    def __init__(self, kind, n, seed, weights):
        self.kind, self.n, self.seed, self.weights, self.epoch = kind, n, seed, weights, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        for i in range(self.n):
            weight = np.asarray(self.weights[i], np.float32)
            if self.kind == "dino":
                views = ([rng.random((B, IMG, IMG, 3), np.float32) for _ in range(2)]
                         + [rng.random((B, LOCAL_IMG, LOCAL_IMG, 3), np.float32)
                            for _ in range(4)])
                yield {"views": views, "weight": weight}
            elif self.kind == "labeled":
                yield {"image": rng.random((B, IMG, IMG, 3), np.float32),
                       "label": rng.integers(0, 3, B).astype(np.int32), "weight": weight}
            else:
                yield {"image": rng.random((B, IMG, IMG, 3), np.float32), "weight": weight}


def loaders(kind):
    """(train, val): 2 train batches (the second with a pad row), 1 val."""
    return (Batches(kind, 2, 7, [[1, 1, 1, 1], [1, 1, 1, 0]]),
            Batches(kind, 1, 8, [[1, 1, 1, 0]]))

