"""Batch iteration: shuffling, collate chain, prefetch, config factory.

Counterpart of ``grl_tpu/data/dataloader.py`` (:29-183), numpy only:

* shuffling is an explicit numpy permutation per epoch, seeded by
  ``seed + epoch``, so both packages visit batches in the same order;
* the collate chain runs processors then stacks numpy arrays;
* with ``num_hosts > 1`` each process reads only its shard of each
  global batch, ``chunk[host_id::num_hosts]``, and a batch size that does
  not divide raises (``dataloader.py:38-83``); the config factory reads
  ``host_id``/``num_hosts`` from the config, which
  :func:`grl_torch.parallel.distributed.initialize_distributed` writes. A
  procedure under a mesh reads the whole batch on every rank and keeps its
  rows itself, so it sets them to the whole batch;
* a background thread prefetches the next batch while the device computes.

:class:`BaseDataLoader` resolves datasets and collate processors by name
from the YAML config.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from grl_torch.config import ConfigDict
from grl_torch.data import collate as collate_module
from grl_torch.data import datasets as datasets_module
from grl_torch.data.collate import stack_batch
from grl_torch.utils.logging import get_logger


class DataLoader:
    def __init__(
        self,
        dataset: Any,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        collate_chain: Optional[Sequence[Callable]] = None,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 2,
    ):
        if num_hosts > 1 and batch_size % num_hosts != 0:
            raise ValueError("batch_size must divide evenly across hosts")
        self.dataset = dataset
        self.global_batch_size = batch_size
        self.batch_size = batch_size // num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_chain = list(collate_chain or [])
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        b = self.global_batch_size
        return n // b if self.drop_last else (n + b - 1) // b

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return order

    def _make_batch(self, indices: Sequence[int]) -> Dict[str, Any]:
        items = [self.dataset[int(i)] for i in indices]
        for collate in self.collate_chain:
            items = collate(items)
        return stack_batch(items)

    def _batch_indices(self) -> Iterator[np.ndarray]:
        order = self._epoch_order()
        b = self.global_batch_size
        for start in range(0, len(order), b):
            chunk = order[start:start + b]
            if len(chunk) < b and self.drop_last:
                break
            # This host's shard of the global batch.
            yield chunk[self.host_id::self.num_hosts]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        self.epoch += 1
        if self.prefetch <= 0:
            for idx in self._batch_indices():
                yield self._make_batch(idx)
            return
        yield from prefetch_iter(
            (self._make_batch(idx) for idx in self._batch_indices()), self.prefetch
        )


def prefetch_iter(iterable, depth: int = 2):
    """Background-thread prefetch of any iterator: the producer (collate,
    I/O) runs ``depth`` items ahead of the consumer. Worker exceptions
    re-raise in the consumer.

    Abandonment-safe: if the consumer drops the generator before it is
    exhausted, ``GeneratorExit`` sets ``stop`` and the producer, which only
    waits on ``q.put`` with a timeout, sees it and exits, so no thread or
    buffered batch leaks."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    stop = threading.Event()
    error_holder: List[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as err:  # surfaced to the consumer below
            error_holder.append(err)
        finally:
            _put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error_holder:
                    raise error_holder[0]
                return
            yield item
    finally:
        stop.set()


class BaseDataLoader:
    """Config-driven loader factory (reference: base_dataloader.py:16-112)."""

    def __init__(self, config: ConfigDict):
        self.config = ConfigDict(config)
        self.logger = get_logger(self.__class__.__name__)

    def _load_dataset(self, dataset_type: str, args: Any, **kwargs: Any):
        cls = getattr(datasets_module, dataset_type)
        return cls._from_config(ConfigDict(args), **kwargs)

    def _load_collate_processors(self, collate_config: Any) -> List[Callable]:
        chain: List[Callable] = []
        for name, args in dict(collate_config or {}).items():
            cls = getattr(collate_module, name, None)
            if cls is None:
                raise KeyError(
                    f"Collate processor {name!r} is not in grl_torch.data.collate, "
                    "which has BucketPadding, SparseBucketPadding and NumpyPadding."
                )
            chain.append(cls._from_config(args))
        return chain

    def _get_dataloader(self, dataset: Any, data_config: Any, **kwargs: Any) -> DataLoader:
        data_config = ConfigDict(data_config)
        chain = self._load_collate_processors(data_config.get("data_collate", {}))
        return DataLoader(
            dataset,
            batch_size=int(data_config.get("batch_size", 1) or 1),
            shuffle=bool(data_config.get("shuffle", False)),
            drop_last=bool(data_config.get("drop_last", False)),
            collate_chain=chain,
            seed=int(self.config.get("seed", 0)),
            host_id=int(self.config.get("host_id", 0)),
            num_hosts=int(self.config.get("num_hosts", 1)),
            prefetch=int(data_config.get("prefetch", 2)),
            **kwargs,
        )
