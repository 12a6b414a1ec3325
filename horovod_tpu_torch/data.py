"""Sharded input pipeline: port of ``horovod_tpu/data.py``.

``shard_indices`` is the reference's ``DistributedSampler`` contract (every
rank the same count, wrapped; reshuffled per epoch from ``seed + epoch``).
The JAX package's loader assembles the rank-major global batch for all of a
host's chips; here each process is one rank, as in Horovod, and
:class:`ShardedLoader` yields **its own rows**: rank r's batch s is rows
``[r·b, (r+1)·b)`` of the JAX loader's batch s.  Batches are gathered on a
background thread (``prefetch``) and copied to the card from pinned memory
without blocking.  ``synthetic_mnist`` and ``synthetic_imagenet`` are the
JAX package's numpy generators, bit for bit.  The producer thread checks
the ``data.producer`` fault site once a batch (key: the batch index), as
the reference's does, so an injected fault surfaces in the consumer.
"""

from __future__ import annotations

import collections
import math
import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from horovod_tpu_torch import basics, faults
from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.utils.tree import leaves, tree_map


def shard_indices(
    n: int,
    rank: int,
    size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = False,
) -> np.ndarray:
    """Index shard for one rank: every rank gets the same count (padding by
    wrap-around, like the reference's sampler), reshuffled per epoch via
    ``seed + epoch``."""
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(n)
    else:
        order = np.arange(n)
    if drop_last:
        per = n // size
        order = order[:per * size]
    else:
        per = math.ceil(n / size)
        total = per * size
        if total > n:
            # A dataset smaller than the world wraps as often as needed.
            order = np.tile(order, math.ceil(total / n))[:total]
    return order[rank * per:(rank + 1) * per]


def to_device(x: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``: from pinned memory and
    without blocking on the card, as ``DataLoader(pin_memory=True)`` feeds
    the reference's examples."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class ShardedLoader:
    """Epoch iterator over this process's shard of ``data``.

    ``data`` is a tree (tuple, list or dict) of equal-length arrays.  Each
    batch is the same tree of tensors of ``batch_per_rank`` rows on
    ``device`` (the card unless the caller names the CPU; numpy arrays
    when ``device_put=False``), ready for
    :func:`..optim.distributed_optimizer.make_train_step`."""

    def __init__(
        self,
        data: Any,
        batch_per_rank: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        device_put: bool = True,
        prefetch: int = 2,
        device: str | torch.device | None = None,
    ):
        """``prefetch``: batches assembled (and copied to the card) ahead on
        a background thread; 0 runs without the thread."""
        data = tree_map(np.asarray, data)
        lengths = sorted({len(leaf) for leaf in leaves(data)})
        if not lengths:
            raise ValueError("ShardedLoader: empty data tree")
        if len(lengths) > 1:
            raise ValueError(f"ShardedLoader: all data leaves must share "
                             f"length; got {lengths}")
        self._n = lengths[0]
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        self.data = data
        self.batch_per_rank = batch_per_rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.device_put = device_put
        self.device = resolve_device(device) if device_put else None
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """The reference's ``train_sampler.set_epoch(epoch)``."""
        self.epoch = epoch

    def __len__(self) -> int:
        size = basics.size()
        per_rank = (self._n // size if self.drop_last
                    else math.ceil(self._n / size))
        return per_rank // self.batch_per_rank

    def _batches(self) -> Iterator[Any]:
        b = self.batch_per_rank
        shard = shard_indices(self._n, basics.rank(), basics.size(),
                              shuffle=self.shuffle, seed=self.seed,
                              epoch=self.epoch, drop_last=self.drop_last)
        for s in range(len(self)):
            idx = shard[s * b:(s + 1) * b]
            if self.device is None:
                yield tree_map(lambda leaf: leaf[idx], self.data)
            else:
                yield tree_map(lambda leaf: to_device(leaf[idx], self.device),
                               self.data)

    def __iter__(self) -> Iterator[Any]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        # A bounded queue fed by a producer thread; an abandoned iterator
        # (break mid-epoch) stops the producer through the flag checked
        # around every put.
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        end = object()

        def put_or_abandon(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for i, batch in enumerate(self._batches()):
                    faults.check("data.producer", key=i)
                    if not put_or_abandon(batch):
                        return
                put_or_abandon(end)
            except BaseException as exc:  # surfaces in the consumer
                put_or_abandon(exc)

        t = threading.Thread(target=producer, name="horovod_tpu_torch-prefetch",
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def synthetic_mnist(n: int = 4096, seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
    """MNIST-shaped synthetic data ([N, 28, 28, 1] f32 in [0, 1], labels
    0-9) with a label-dependent bright pixel, so losses fall."""
    rng = np.random.default_rng(seed)
    images = rng.random((n, 28, 28, 1), dtype=np.float32)
    labels = rng.integers(0, 10, size=(n,), dtype=np.int64)
    for d in range(10):
        mask = labels == d
        images[mask, 2 + 2 * (d % 5), 4 + 3 * (d // 5), 0] = 2.0
    return images, labels


def synthetic_imagenet(n: int = 256, image_size: int = 224,
                       num_classes: int = 1000, seed: int = 0
                       ) -> tuple[np.ndarray, np.ndarray]:
    """ImageNet-shaped random images (NHWC f32, standard normal) and labels,
    as the reference's ``pytorch_synthetic_benchmark.py`` draws them."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (n, image_size, image_size, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=(n,), dtype=np.int64)
    return images, labels


def prefetch_to_device(iterator: Iterator[Any], size: int = 2,
                       device: str | torch.device | None = None
                       ) -> Iterator[Any]:
    """Keep ``size`` batches' host-to-card copies in flight ahead of the
    consumer, for iterators of host batches (trees of numpy arrays or CPU
    tensors).  Yields every item once, in order."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    dev = resolve_device(device)

    def put(leaf):
        return to_device(leaf.numpy() if isinstance(leaf, torch.Tensor)
                         else np.asarray(leaf), dev)

    def gen():
        buf: collections.deque = collections.deque()
        for item in iterator:
            buf.append(tree_map(put, item))
            if len(buf) > size:
                yield buf.popleft()
        while buf:
            yield buf.popleft()

    return gen()
