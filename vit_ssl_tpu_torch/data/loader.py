"""Host-side data loader (a copy of ``vit_ssl_tpu/data/loader.py``): threaded
decode workers and a batch prefetch queue.

Worker threads decode and transform samples (zlib and numpy's larger
operations release the GIL), or a dataset's ``native_batch`` decodes a
whole batch in one call (``data.native_decode``); whole batches are
stacked into numpy arrays, and a bounded prefetch queue keeps
``prefetch_factor`` batches ready ahead of the training step.

Static shapes: the final short batch is padded up to ``batch_size`` with
copies of its first sample, and a per-sample ``weight`` vector (1 real, 0
pad) rides along, so loss and metrics stay exact under padding.

The index order of an epoch is ``default_rng((seed, epoch))``'s
permutation, and each sample's generator is ``default_rng((seed, epoch,
index))``: augmentation streams do not depend on worker scheduling.

Several processes: with ``process_shard=(rank, world_size)`` every process
derives the same global index order but loads only its interleaved slice
of each global batch, a local batch of ``batch_size / world_size``.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .datasets import Dataset


def _collate(
    samples: List[Any], pad_to: int, n_real: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Stack samples; pad with copies of sample 0 at weight 0. ``n_real``
    overrides the real-sample count (0 for an all-pad step on a process
    whose slice of a short final global batch is empty)."""
    if n_real is None:
        n_real = len(samples)
    weight = np.zeros((pad_to,), dtype=np.float32)
    weight[:n_real] = 1.0
    while len(samples) < pad_to:
        samples.append(samples[0])

    def stack(arrs):
        out = np.stack(arrs)
        # uint8 stays uint8: device-side pipelines convert on chip, cutting
        # host->HBM traffic 4x
        return out if out.dtype == np.uint8 else out.astype(np.float32)

    first = samples[0]
    if isinstance(first, tuple) and len(first) == 2:  # (image, label)
        images = stack([s[0] for s in samples])
        labels = np.asarray([s[1] for s in samples], dtype=np.int32)
        return {"image": images, "label": labels, "weight": weight}
    if isinstance(first, list):  # multi-crop views
        num_views = len(first)
        views = [stack([s[v] for s in samples]) for v in range(num_views)]
        return {"views": views, "weight": weight}
    images = stack(samples)
    return {"image": images, "weight": weight}


class DataLoader:
    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 0,
        seed: int = 0,
        drop_last: bool = False,
        prefetch_factor: int = 2,
        process_shard: Optional[Tuple[int, int]] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, int(num_workers))
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch_factor = max(1, prefetch_factor)
        self.epoch = 0
        if process_shard is not None:
            index, count = int(process_shard[0]), int(process_shard[1])
            if count < 1 or not (0 <= index < count):
                raise ValueError(f"Invalid process_shard {process_shard}")
            if batch_size % count != 0:
                raise ValueError(
                    f"training.batch_size ({batch_size}) must divide evenly "
                    f"across {count} processes"
                )
            process_shard = (index, count)
        self.process_shard = process_shard

    @property
    def local_batch_size(self) -> int:
        if self.process_shard is None:
            return self.batch_size
        return self.batch_size // self.process_shard[1]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            return rng.permutation(n)
        return np.arange(n)

    def _fetch(self, index: int) -> Any:
        rng = np.random.default_rng((self.seed, self.epoch, int(index)))
        try:
            return self.dataset.__getitem__(int(index), rng)
        except TypeError:
            return self.dataset[int(index)]

    def _fetch_batch(self, idxs) -> List[Any]:
        """Whole-batch fetch: one decode call when the dataset offers it
        (``native_batch``, ``data.native_decode``), else per sample."""
        native = getattr(self.dataset, "native_batch", None)
        if native is not None:
            samples = native(idxs)
            if samples is not None:
                return samples
        return [self._fetch(i) for i in idxs]

    def _batches(self) -> List[np.ndarray]:
        order = self._index_order()
        if self.drop_last:
            order = order[: (len(order) // self.batch_size) * self.batch_size]
        global_batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.process_shard is None:
            return [(idxs, len(idxs)) for idxs in global_batches]
        # interleaved slice: a short final global batch spreads its real
        # samples across processes, so the per-process pad weights still
        # sum to the global real-sample count. A process whose slice is
        # empty still steps (all-pad batch, weight 0) so the collective
        # step count matches across hosts.
        index, count = self.process_shard
        sliced = []
        for idxs in global_batches:
            sl = idxs[index::count]
            sliced.append((sl, len(sl)) if len(sl) else (idxs[:1], 0))
        return sliced

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batches()
        if self.num_workers == 0:
            for idxs, n_real in batches:
                yield _collate(
                    self._fetch_batch(idxs), self.local_batch_size, n_real
                )
            return

        out_q: "queue.Queue[Any]" = queue.Queue(maxsize=self.prefetch_factor)
        stop = threading.Event()

        def produce():
            try:
                native = getattr(self.dataset, "native_batch", None)
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for idxs, n_real in batches:
                        if stop.is_set():
                            return
                        samples = None
                        if native is not None:
                            samples = native(idxs)
                        if samples is None:
                            samples = list(pool.map(self._fetch, idxs))
                        out_q.put(
                            _collate(samples, self.local_batch_size, n_real)
                        )
                out_q.put(None)
            except BaseException as e:  # surface worker errors in the consumer
                out_q.put(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit promptly
            while not out_q.empty():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
