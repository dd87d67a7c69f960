"""Dataloader construction (after ``vit_ssl_tpu/data/builder.py``).

:func:`prepare_dataloaders` builds the datasets of a training mode and
hands them to :func:`make_loaders`, the seeded train/val split by
``data.val_split`` and the two loaders; only the train loader shuffles.
Several processes (``torch.distributed`` initialised) each load their
interleaved slice of every global batch, by their rank and the size of the
mesh's ``data`` axis (the seq ranks of one data index load the same rows,
as JAX shards the batch over ``data`` only).

- supervised and finetune (:func:`labeled_datasets`): a train and a val
  dataset over the same files (``data.dataset_name``: ``cifar10``,
  ``stl10``, ``imagefolder``/``imagenet``). With ``data.device_augment``
  both only decode and resize (the train augmentation runs on the card in
  the step, and validation scales the uint8 images there); without it
  they run the config's ``transforms.train`` and ``transforms.val`` on the
  host. :func:`check_label_range` refuses a dataset with more classes
  than the model's head.
- DINO (:func:`dino_dataset`): with ``data.device_augment=true`` the host
  decodes and resizes (the views are made on the card); without it the
  host multi-crop ``STL10DINODataset`` makes them through the config's
  ``transforms.globals`` and ``transforms.locals``
  (``training.num_all_views`` views, ``training.num_global_views`` of them
  global). Train and val share one dataset object.
- SimMIM (:func:`simmim_dataset`): the unlabeled images of
  ``data.data_dir``, decoded and resized with ``data.device_augment``
  (the train augmentation runs on the card), else through the config's
  ``transforms.train`` on the host; train and val share one dataset
  object, as in the JAX package.
- the evaluators (:func:`eval_datasets`, modes ``eval_knn``,
  ``eval_linear``, ``eval_umap``; a list of modes loads by its first
  entry): the labeled datasets of ``eval.*``, each key falling back to
  ``data.*`` only when ``eval`` lacks it, through
  :func:`eval_pipeline` (``Resize`` to ``data.img_size``, then
  ``ToTensor``; never the device augmentation).
- ``eval_dino``: the host multi-crop of :func:`dino_dataset` over
  ``eval.dataset_name`` and ``eval.data_dir`` (each ``data.*``'s when
  ``eval`` lacks it) and the config's ``transforms``, as the JAX
  ``_get_dataset`` builds it when handed them.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

from ..config import is_list
from .datasets import (CIFAR10Dataset, Dataset, ImageFolderDataset, STL10Dataset,
                       STL10DINODataset, STL10UnsupervisedDataset, Subset)
from .loader import DataLoader

logger = logging.getLogger(__name__)


def _process_shard(config) -> Optional[Tuple[int, int]]:
    """(data rank, data size) of this process in ``config``'s mesh over the
    started processes, or None: one process, a data axis of 1, or a
    suspended context (a rank that evaluates alone). The seq ranks of one
    data index load the same rows."""
    from ..parallel.context import is_suspended
    from ..parallel.mesh import DATA_AXIS, axis_sizes, coordinates, world

    rank, size = world()
    if size <= 1 or is_suspended():
        return None
    sizes = axis_sizes(config, size)
    if sizes[DATA_AXIS] <= 1:
        return None
    return coordinates(sizes, rank)[DATA_AXIS], sizes[DATA_AXIS]


def dino_dataset(config, section: str = "data") -> Dataset:
    """DINO's dataset: ``data.*`` (``section="eval"``: ``eval.dataset_name``
    and ``eval.data_dir``, each ``data.*``'s when ``eval`` lacks it, always
    the host multi-crop, as ``eval_dino`` loads)."""
    data = config.get("data", {})
    keys = config.get(section, {})
    dataset_name = str(keys.get("dataset_name", data.get("dataset_name", ""))).lower()
    data_dir = keys.get("data_dir", data.get("data_dir"))
    if dataset_name != "stl10":
        raise ValueError(f"Unknown DINO dataset: {dataset_name}")
    training = config.training
    if section == "data" and bool(data.get("device_augment", False)):
        dataset = STL10UnsupervisedDataset(
            data_dir, transform=_decode_and_resize(config),
            cache=bool(data.get("cache_decoded", False)),
            native_decode=bool(data.get("native_decode", False)))
        dataset.num_global_views = int(training.num_global_views)
        return dataset
    from .transforms import get_transforms

    return STL10DINODataset(data_dir, transforms=get_transforms(config),
                            num_all_views=int(training.num_all_views),
                            num_global_views=int(training.num_global_views))


def simmim_dataset(config) -> Dataset:
    """SimMIM's dataset as ``data.*`` describes it (JAX ``_get_dataset``'s
    ``simmim`` branch)."""
    data = config.get("data", {})
    dataset_name = str(data.get("dataset_name", "")).lower()
    if dataset_name != "stl10":
        raise ValueError(f"Unknown unsupervised dataset: {dataset_name}")
    if bool(data.get("device_augment", False)):
        transform = _decode_and_resize(config)
    else:
        from .transforms import get_transforms

        transform = get_transforms(config)["train"]
    return STL10UnsupervisedDataset(
        data.get("data_dir"), transform=transform,
        cache=bool(data.get("cache_decoded", False)),
        native_decode=bool(data.get("native_decode", False)))


def _decode_and_resize(config):
    """The host pipeline under device augmentation: decode and resize to
    ``data.img_size``."""
    from .transforms import Compose, Resize

    img = int(config["data"]["img_size"])
    return Compose([Resize([img, img])])


def labeled_datasets(config) -> Tuple[Dataset, Dataset]:
    """The supervised/finetune train and val datasets ``data.*`` describes
    (the JAX ``_get_dataset``'s labeled branch)."""
    data = config.get("data", {})
    if bool(data.get("device_augment", False)):
        train_t = val_t = _decode_and_resize(config)
    else:
        from .transforms import get_transforms

        pipelines = get_transforms(config)
        train_t, val_t = pipelines["train"], pipelines["val"]
    return _labeled(str(data.get("dataset_name", "")).lower(), data.get("data_dir"),
                    data.get("data_csv"), train_t, val_t,
                    bool(data.get("cache_decoded", False)))


def eval_pipeline(img_size: int):
    """The evaluators' host pipeline: ``Resize([img, img])`` then
    ``ToTensor`` (float32 HWC in [0, 1])."""
    from .transforms import Compose, Resize, ToTensor

    return Compose([Resize([img_size, img_size]), ToTensor()])


def eval_datasets(config) -> Tuple[Dataset, Dataset]:
    """The evaluators' train and val datasets: ``eval.dataset_name``,
    ``eval.data_dir`` and ``eval.data_csv``, each ``data.*``'s when
    ``eval`` has no such key (a key present but empty stays empty), both
    through :func:`eval_pipeline`."""
    data, section = config.get("data", {}), config.get("eval", {})
    pipeline = eval_pipeline(int(config["data"]["img_size"]))
    return _labeled(
        str(section.get("dataset_name", data.get("dataset_name", ""))).lower(),
        section.get("data_dir", data.get("data_dir")),
        section.get("data_csv", data.get("data_csv")), pipeline, pipeline,
        bool(data.get("cache_decoded", False)))


def _labeled(dataset_name, data_dir, data_csv, train_t, val_t, cache):
    if dataset_name == "cifar10":
        return (CIFAR10Dataset(data_csv, data_dir, train_t, cache),
                CIFAR10Dataset(data_csv, data_dir, val_t, cache))
    if dataset_name == "stl10":
        return (STL10Dataset(data_csv, data_dir, train_t, cache),
                STL10Dataset(data_csv, data_dir, val_t, cache))
    if dataset_name in ("imagefolder", "imagenet"):
        return ImageFolderDataset(data_dir, train_t), ImageFolderDataset(data_dir, val_t)
    raise ValueError(f"Unknown supervised/labeled dataset: {dataset_name}")


def check_label_range(config, dataset) -> None:
    """Refuse a labeled dataset with more classes than ``model.num_classes``
    (labels past the head would make the loss meaningless); warn when it
    has fewer."""
    classes = getattr(dataset, "classes", None)
    num_classes = config.get("model", {}).get("num_classes", None)
    if classes is None or num_classes is None:
        return
    n_data, n_model = len(classes), int(num_classes)
    if n_data > n_model:
        from ..config import ConfigValidationError

        raise ConfigValidationError(
            f"Dataset at '{config.get('data', {}).get('data_dir')}' has "
            f"{n_data} classes {sorted(map(str, classes))[:8]} but "
            f"model.num_classes={n_model}; labels >= {n_model} have no logit. "
            f"Set model.num_classes={n_data} or point data.data_csv at a "
            f"{n_model}-class index.")
    if n_data < n_model:
        logger.warning("Dataset has %d classes but model.num_classes=%d: the "
                       "extra head outputs never receive positive labels.",
                       n_data, n_model)


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
    process_shard = _process_shard(config)
    if process_shard is not None:
        logger.info(
            "Data sharding: data rank %d/%d loads %d of every %d-sample "
            "global batch", process_shard[0], process_shard[1],
            int(batch_size) // process_shard[1], batch_size)

    def loader(dataset, shuffle):
        return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, seed=seed, prefetch_factor=2,
                          process_shard=process_shard)

    return (loader(train_dataset, True),
            None if val_dataset is None else loader(val_dataset, False))


EVAL_DATA_MODES = ("eval_knn", "eval_linear", "eval_umap")


def prepare_dataloaders(config, mode) -> Tuple[DataLoader, Optional[DataLoader]]:
    """The train and val loaders of a training mode or of the evaluators'
    modes (a list loads by its first entry), as the JAX function builds
    them."""
    if is_list(mode):
        logger.info("Multiple evaluation modes detected: %s", mode)
        mode = mode[0]
    mode = str(mode).lower()
    if mode in EVAL_DATA_MODES:
        logger.info("Preparing dataloaders for mode: '%s' (eval.data_dir -> %s)", mode,
                    config.get("eval", {}).get("data_dir",
                                               config.get("data", {}).get("data_dir")))
        return make_loaders(config, *eval_datasets(config))
    if mode == "eval_dino":
        logger.info("Preparing dataloaders for mode: '%s' (eval.data_dir -> %s)", mode,
                    config.get("eval", {}).get("data_dir",
                                               config.get("data", {}).get("data_dir")))
        return make_loaders(config, dino_dataset(config, "eval"))
    if mode in ("supervised", "finetune"):
        logger.info("Preparing dataloaders for mode: '%s'", mode)
        train_full, val_full = labeled_datasets(config)
        check_label_range(config, train_full)
        return make_loaders(config, train_full, val_full)
    if mode not in ("simmim", "dino"):
        raise ValueError(f"Unknown mode for dataset creation: {mode}")
    logger.info("Preparing dataloaders for mode: '%s'", mode)
    return make_loaders(config, (simmim_dataset if mode == "simmim"
                                 else dino_dataset)(config))
