"""HistopathDataModule: splits and bucketed batch loading (counterpart of
the JAX package's ``data/datamodule.py``).

A batch is a group of graphs of one bucket shape stacked on a leading axis,
so every batch of a bucket has the same shape. ``BucketedLoader`` builds the
batches on a background thread, ``prefetch`` ahead of the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..ops.graph import PaddedGraph, batch_graphs
from ..utils.exceptions import DataError
from ..utils.logging import get_logger

logger = get_logger("data")


class BucketedLoader:
    """Groups dataset items by ``(num_nodes, max_neighbors, feature_dim)``
    and yields stacked batches.

    An incomplete trailing group is filled up by repeating its last graph
    with ``node_mask`` zeroed (the batch shape stays; a filler graph adds
    nothing to masked losses), or dropped with ``drop_last``. With
    ``shuffle``, the order of epoch ``e`` of this loader (counted from 0 at
    its construction) is a permutation drawn from ``seed + e``.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _iter_batches(self) -> Iterator[PaddedGraph]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        groups: Dict[tuple, List[PaddedGraph]] = {}
        for idx in order:
            g = self.dataset[int(idx)]
            key = (g.num_nodes, g.max_neighbors, g.feature_dim)
            groups.setdefault(key, []).append(g)
            if len(groups[key]) == self.batch_size:
                yield batch_graphs(groups.pop(key))
        for group in groups.values():
            if self.drop_last:
                continue
            while len(group) < self.batch_size:
                group.append(group[-1].replace(node_mask=torch.zeros_like(group[-1].node_mask)))
            yield batch_graphs(group)

    def __iter__(self) -> Iterator[PaddedGraph]:
        if self.prefetch <= 0:
            yield from self._iter_batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []
        stop = threading.Event()

        def producer():
            try:
                for batch in self._iter_batches():
                    q.put(batch)
                    if stop.is_set():
                        break
            except BaseException as exc:  # noqa: BLE001 - raised in the consumer
                error.append(exc)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        finished = False
        try:
            while (item := q.get()) is not sentinel:
                yield item
            finished = True
        finally:
            if not finished:
                # the consumer stopped early (next() on a fresh iterator, a
                # preempted epoch): the producer ends after its current batch
                stop.set()
                while q.get() is not sentinel:
                    pass
            t.join()
        if error:
            raise error[0]


def _process_shards() -> tuple:
    """(world size, rank) of an initialized ``torch.distributed`` group, else (1, 0)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size(), torch.distributed.get_rank()
    return 1, 0


class HistopathDataModule:
    """Split management and loader construction over any indexable dataset.

    Training batches are sharded over processes: shard ``shard_index`` of
    ``num_shards`` takes every ``num_shards``-th training item (the same
    split everywhere); validation and test stay whole. The defaults follow
    ``torch.distributed`` when a process group is initialized.
    """

    def __init__(self, dataset, batch_size: int = 4, train_split: float = 0.7,
                 val_split: float = 0.15, test_split: float = 0.15,
                 shuffle_train: bool = True, seed: int = 42, drop_last: bool = False,
                 prefetch: int = 2, num_shards: Optional[int] = None,
                 shard_index: Optional[int] = None):
        total = train_split + val_split + test_split
        if abs(total - 1.0) > 1e-6:
            raise DataError("splits must sum to 1.0", {"sum": total})
        self.dataset = dataset
        self.batch_size = batch_size
        self.splits = (train_split, val_split, test_split)
        self.shuffle_train = shuffle_train
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        world, rank = _process_shards()
        num_shards = world if num_shards is None else num_shards
        shard_index = rank if shard_index is None else shard_index
        if not 0 <= shard_index < num_shards:
            raise DataError("shard_index out of range",
                            {"shard_index": shard_index, "num_shards": num_shards})
        self.num_shards = int(num_shards)
        self.shard_index = int(shard_index)
        self._indices: Optional[Dict[str, np.ndarray]] = None

    def setup(self) -> None:
        """A random split drawn from ``seed``."""
        n = len(self.dataset)
        order = np.arange(n)
        np.random.RandomState(self.seed).shuffle(order)
        n_train = int(round(self.splits[0] * n))
        n_val = int(round(self.splits[1] * n))
        self._indices = {"train": order[:n_train], "val": order[n_train:n_train + n_val],
                         "test": order[n_train + n_val:]}
        logger.info("split %d items -> train=%d val=%d test=%d", n, n_train, n_val,
                    n - n_train - n_val)

    def _subset(self, split: str) -> "_Subset":
        if self._indices is None:
            self.setup()
        idx = self._indices[split]
        if self.num_shards > 1 and split == "train":
            idx = idx[self.shard_index::self.num_shards]
        return _Subset(self.dataset, idx)

    def train_dataloader(self) -> BucketedLoader:
        return BucketedLoader(self._subset("train"), self.batch_size,
                              shuffle=self.shuffle_train, seed=self.seed,
                              drop_last=self.drop_last, prefetch=self.prefetch)

    def val_dataloader(self) -> BucketedLoader:
        return BucketedLoader(self._subset("val"), self.batch_size, prefetch=self.prefetch)

    def test_dataloader(self) -> BucketedLoader:
        return BucketedLoader(self._subset("test"), self.batch_size, prefetch=self.prefetch)

    def get_dataset_info(self) -> Dict:
        if self._indices is None:
            self.setup()
        return {"total": len(self.dataset), "train": len(self._indices["train"]),
                "val": len(self._indices["val"]), "test": len(self._indices["test"]),
                "batch_size": self.batch_size}


class _Subset:
    def __init__(self, dataset, indices: np.ndarray):
        self.dataset = dataset
        self.indices = indices

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[int(self.indices[i])]
