"""Pipeline registry, base dataset/store classes, a host-side numpy
DataLoader, and the minibatch iterator.

Port of the JAX package's `pipeline/__init__.py`. Batches stay numpy on
the host (the trainer moves them to its device), and shuffling uses
`random.Random(seed + epoch)`, so a loader gives the same order as the
JAX package's for the same seed.
"""

import random
import sys
from abc import abstractmethod
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

# Pipeline registry, keyed by lowercased class name.
_DATAPIPELINE: Dict[str, Any] = {}


def register_datapipeline(name):
    """Decorator to register a pipeline class under `name` (or its own
    class name)."""

    def register_class(cls, name):
        _DATAPIPELINE[name] = cls
        setattr(sys.modules[__name__], name, cls)
        return cls

    if isinstance(name, str):
        name = name.lower()
        return lambda c: register_class(c, name)

    cls = name
    register_class(cls, cls.__name__.lower())
    return cls


class DataLoader:
    """Minimal host-side batch loader over a list-like dataset: collated
    batches, deterministic shuffling with a seed bumped per epoch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        collate_fn: Optional[Callable] = None,
        drop_last: bool = False,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            rng = random.Random(self.seed + self._epoch)
            rng.shuffle(indices)
            self._epoch += 1
        for start in range(0, len(indices), self.batch_size):
            chunk = indices[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            yield self.collate_fn([self.dataset[i] for i in chunk])


def default_collate(items: List[Any]):
    """Stack a list of dicts / dataclasses / arrays into a batch."""
    if isinstance(items[0], dict):
        return {k: default_collate([it[k] for it in items]) for k in items[0]}
    if hasattr(items[0], "__dataclass_fields__"):
        cls = type(items[0])
        fields = items[0].__dataclass_fields__.keys()
        return cls(**{f: default_collate([getattr(it, f) for it in items]) for f in fields})
    first = items[0]
    if isinstance(first, (np.ndarray, int, float, np.integer, np.floating)):
        return np.stack([np.asarray(x) for x in items])
    return items  # lists of strings / metadata pass through


class BasePipeline:
    """Dataset of prompts / samples."""

    def __init__(self, path: str = "dataset"):
        self.path = path

    @abstractmethod
    def __getitem__(self, index: int):
        pass

    @abstractmethod
    def __len__(self) -> int:
        pass

    @abstractmethod
    def create_loader(self, batch_size: int, shuffle: bool, **kwargs) -> DataLoader:
        pass


class BaseRolloutStore:
    """Rollout storage."""

    def __init__(self, capacity=-1):
        self.history: Iterable[Any] = None
        self.capacity = capacity

    @abstractmethod
    def push(self, exps: Iterable[Any]):
        """Push experiences to the store."""

    def __getitem__(self, index: int):
        return self.history[index]

    def __len__(self) -> int:
        return len(self.history)

    @abstractmethod
    def create_loader(self, batch_size: int, shuffle: bool, **kwargs) -> DataLoader:
        pass


def slice_tree(batch, start: int, stop: int):
    """Slice every array leaf of a batch (dict / dataclass / array / list)
    along the leading axis."""

    def _slice(x):
        if isinstance(x, (np.ndarray, torch.Tensor, list, tuple)):
            return x[start:stop]
        return x

    if isinstance(batch, dict):
        return {k: slice_tree(v, start, stop) if isinstance(v, dict) else _slice(v) for k, v in batch.items()}
    if hasattr(batch, "__dataclass_fields__"):
        cls = type(batch)
        return cls(**{
            f: slice_tree(getattr(batch, f), start, stop) if isinstance(getattr(batch, f), dict)
            else _slice(getattr(batch, f))
            for f in batch.__dataclass_fields__
        })
    return _slice(batch)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif hasattr(tree, "__dataclass_fields__") and not hasattr(tree, "shape"):
        for f in tree.__dataclass_fields__:
            yield from _leaves(getattr(tree, f))
    elif tree is not None:
        yield tree


def tree_batch_size(batch) -> int:
    """Leading size of the first sized leaf (0 when there is none)."""
    for leaf in _leaves(batch):
        if hasattr(leaf, "shape") and len(leaf.shape) > 0:
            return leaf.shape[0]
        if isinstance(leaf, (list, tuple)):
            return len(leaf)
    return 0


class MiniBatchIterator:
    """Split each dataloader batch into `num_mb` microbatches of `mb_size`,
    preserving the batch's container type."""

    def __init__(self, data_loader, mb_size: int, num_mb: int):
        self.data_loader = data_loader
        self.mb_size = mb_size
        self.num_mb = num_mb

    def __iter__(self):
        for batch in self.data_loader:
            total = tree_batch_size(batch)
            minibatches = []
            for mbi in range(self.num_mb):
                start, stop = mbi * self.mb_size, (mbi + 1) * self.mb_size
                if start >= total:
                    logger.warning(
                        "WARNING: MiniBatchIterator generated empty batch, increase dataset size "
                        "or decrease batch size"
                    )
                    break
                mb = slice_tree(batch, start, stop)
                actual = tree_batch_size(mb)
                if actual < self.mb_size:
                    logger.warning(f"WARNING: Minibatch size {actual} is less than configured {self.mb_size}")
                minibatches.append(mb)
            if minibatches:
                yield minibatches
