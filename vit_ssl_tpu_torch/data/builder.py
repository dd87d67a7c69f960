"""Dataloader construction (after ``vit_ssl_tpu/data/builder.py``).

:func:`prepare_dataloaders` builds DINO's dataset with
``data.device_augment=true`` (the host decodes and resizes; the views are
made on the card) and hands it to :func:`make_loaders`, the seeded
train/val split by ``data.val_split`` and the two loaders. Train and val
share one dataset object; only the train loader shuffles. Several
processes (``torch.distributed`` initialised) each load their interleaved
slice of every global batch.

Refused by name, each with its ``ROADMAP.md`` queue-A item: the other
training modes and the evaluators' labeled datasets, and DINO with
``data.device_augment=false`` (host multi-crop).
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

from .datasets import Dataset, STL10UnsupervisedDataset, Subset
from .loader import DataLoader

logger = logging.getLogger(__name__)


def _process_shard() -> Optional[Tuple[int, int]]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return None


def dino_dataset(config) -> Dataset:
    """DINO's dataset as ``data.*`` describes it (device augmentation)."""
    data = config.get("data", {})
    if not bool(data.get("device_augment", False)):
        raise NotImplementedError(
            "DINO with data.device_augment=false (host multi-crop through "
            "cv2 transforms, STL10DINODataset) is not ported yet; see "
            "ROADMAP.md queue A item 11. Set data.device_augment=true")
    dataset_name = str(data.get("dataset_name", "")).lower()
    if dataset_name != "stl10":
        raise ValueError(f"Unknown DINO dataset: {dataset_name}")
    from .transforms import Compose, Resize

    img = int(config["data"]["img_size"])
    dataset = STL10UnsupervisedDataset(
        data.get("data_dir"), transform=Compose([Resize([img, img])]),
        cache=bool(data.get("cache_decoded", False)),
        native_decode=bool(data.get("native_decode", False)))
    dataset.num_global_views = int(config.training.num_global_views)
    return dataset


def make_loaders(config, train_full: Dataset,
                 val_full: Optional[Dataset] = None
                 ) -> Tuple[DataLoader, Optional[DataLoader]]:
    """The seeded train/val split of ``train_full`` (``val_full``: the same
    indices over another dataset; default ``train_full``) and the train
    (shuffled) and val loaders; no val loader when ``data.val_split`` is
    outside (0, 1)."""
    val_full = train_full if val_full is None else val_full
    total = len(train_full)
    val_split = float(config.data.val_split)
    if val_split <= 0 or val_split >= 1:
        train_size, val_size = total, 0
    else:
        val_size = int(total * val_split)
        train_size = total - val_size

    seed = int(config.training.random_seed) if "training" in config else 0
    if val_size > 0:
        perm = np.random.default_rng(seed).permutation(total)
        train_dataset = Subset(train_full, perm[:train_size])
        val_dataset = Subset(val_full, perm[train_size:])
    else:
        train_dataset, val_dataset = train_full, None

    batch_size = config.get("training", {}).get(
        "batch_size", config.get("eval", {}).get("batch_size"))
    num_workers = int(config.data.num_workers)
    process_shard = _process_shard()
    if process_shard is not None:
        logger.info(
            "Data sharding: process %d/%d loads %d of every %d-sample "
            "global batch", process_shard[0], process_shard[1],
            int(batch_size) // process_shard[1], batch_size)

    def loader(dataset, shuffle):
        return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, seed=seed, prefetch_factor=2,
                          process_shard=process_shard)

    return (loader(train_dataset, True),
            None if val_dataset is None else loader(val_dataset, False))


def prepare_dataloaders(config, mode) -> Tuple[DataLoader, Optional[DataLoader]]:
    """The train and val loaders of a training mode (the JAX function's
    dino branch)."""
    if isinstance(mode, (list, tuple)) or "eval" in str(mode).lower():
        raise NotImplementedError(
            f"the evaluators' datasets (mode {mode!r}) are not ported yet; see "
            "ROADMAP.md queue A item 7")
    mode = str(mode).lower()
    if mode in ("supervised", "finetune"):
        raise NotImplementedError(
            f"the {mode} datasets are not ported yet; see ROADMAP.md queue A "
            "item 4")
    if mode == "simmim":
        raise NotImplementedError(
            "mode 'simmim' is not ported yet; see ROADMAP.md queue A item 6")
    if mode != "dino":
        raise ValueError(f"Unknown mode for dataset creation: {mode}")
    logger.info("Preparing dataloaders for mode: '%s'", mode)
    return make_loaders(config, dino_dataset(config))
