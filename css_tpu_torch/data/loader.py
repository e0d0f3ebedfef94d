"""Host-side batch loader: sharded shuffling sampler + threaded prefetch,
counterpart of ``css_tpu/data/loader.py``.

* A per-epoch seeded permutation, ``default_rng(seed * 1000003 + epoch)``,
  sharded across processes; shards are padded to equal length (train:
  wrap-around oversampling, as ``DistributedSampler`` does; eval: masked
  pad entries), so every process sees the same number of batches.
* ``drop_last`` batching for train, a padded and masked final batch for eval.
* A thread pool decodes records into numpy canvases ahead of the consumer;
  batch assembly runs on a separate pool, so assembly tasks can never starve
  waiting on decode workers of their own pool.
* ``InfiniteLoader`` cycles epochs with re-shuffling.

Batches are numpy: image [B, H, W, 3] uint8, label [B, H, W] int32,
valid_hw [B, 2] int32, valid [B] bool; the driver moves them to the device.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator, List, Optional

import numpy as np

from css_tpu_torch.utils.profiling import span

__all__ = ["BatchLoader", "InfiniteLoader"]


def _epoch_permutation(n: int, seed: int, epoch: int, shuffle: bool) -> np.ndarray:
    if not shuffle:
        return np.arange(n)
    return np.random.default_rng(seed * 1000003 + epoch).permutation(n)


class BatchLoader:
    """Iterates dict batches; ``valid`` is False only on eval padding.
    ``close()`` stops its worker threads."""

    def __init__(self, spec, sample_ids: List[str], batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True, num_shards: int = 1,
                 shard_index: int = 0, num_workers: int = 8, prefetch: int = 2):
        self.spec = spec
        self.ids = list(sample_ids)
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0
        # decode and batch assembly use disjoint pools: _make_batch blocks on
        # decode results, so one shared pool deadlocks once every worker is
        # an assembly task waiting for a decode slot
        self._decode_pool = cf.ThreadPoolExecutor(max_workers=num_workers)
        self._batch_pool = cf.ThreadPoolExecutor(max_workers=prefetch + 1)
        self.prefetch = prefetch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def close(self) -> None:
        self._batch_pool.shutdown(wait=True, cancel_futures=True)
        self._decode_pool.shutdown(wait=True, cancel_futures=True)

    def _shard_ids(self) -> List[Optional[str]]:
        """This shard's sample ids, padded so that every shard has the same
        length: train wraps the permutation, eval pads with ``None`` entries
        that become masked (valid=False) rows."""
        n = len(self.ids)
        order = _epoch_permutation(n, self.seed, self.epoch, self.shuffle)
        if self.num_shards > 1:
            per = -(-n // self.num_shards)
            pad = per * self.num_shards - n
            if pad:
                if self.shuffle:
                    order = np.concatenate([order, order[:pad]])
                else:
                    order = np.concatenate([order, np.full(pad, -1)])
            order = order[self.shard_index::self.num_shards]
        return [self.ids[i] if i >= 0 else None for i in order]

    def __len__(self) -> int:
        n = len(self._shard_ids())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, ids: List[Optional[str]]) -> dict:
        b = self.batch_size
        ch, cw = self.spec.canvas_hw
        image = np.zeros((b, ch, cw, 3), np.uint8)
        label = np.full((b, ch, cw), 255, np.int32)
        valid_hw = np.ones((b, 2), np.int32)
        valid = np.zeros((b,), bool)

        def _decode_row(args):
            i, sid = args
            valid_hw[i] = self.spec.load_into(sid, image[i], label[i])
            valid[i] = True

        # decode straight into the batch rows: no per-sample canvas copy
        list(self._decode_pool.map(_decode_row,
                                   [(i, s) for i, s in enumerate(ids) if s is not None]))
        return dict(image=image, label=label, valid_hw=valid_hw, valid=valid)

    def __iter__(self) -> Iterator[dict]:
        ids = self._shard_ids()
        batches = []
        for i in range(0, len(ids), self.batch_size):
            chunk = ids[i:i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                break
            batches.append(chunk)

        # keep `prefetch` + 1 batch futures in flight
        futures: List[cf.Future] = []
        submit_iter = iter(batches)

        def _submit_next():
            chunk = next(submit_iter, None)
            if chunk is not None:
                futures.append(self._batch_pool.submit(self._make_batch, chunk))

        for _ in range(self.prefetch + 1):
            _submit_next()
        for idx in range(len(batches)):
            with span("css.loader", device=False):     # the consumer waits for the pool
                batch = futures[idx].result()
            _submit_next()
            yield batch


class InfiniteLoader:
    """Endless batches, re-shuffling at each epoch boundary."""

    def __init__(self, loader: BatchLoader, start_epoch: int = 0):
        self.loader = loader
        self.epoch = start_epoch
        self._it: Optional[Iterator] = None

    def __next__(self) -> dict:
        while True:
            fresh = self._it is None
            if fresh:
                self.loader.set_epoch(self.epoch)
                self._it = iter(self.loader)
            try:
                return next(self._it)
            except StopIteration:
                self.epoch += 1
                self._it = None
                if fresh:
                    # a fresh iterator yielded nothing: the split shards to
                    # fewer ids than one batch (drop_last)
                    raise RuntimeError(
                        "InfiniteLoader: the wrapped loader yielded no batches (split "
                        "smaller than one batch with drop_last?). Lower the batch size "
                        "or enlarge the split.")
