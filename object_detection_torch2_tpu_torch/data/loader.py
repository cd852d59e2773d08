"""Input pipeline: batching with a background prefetch thread, one process
(counterpart of object_detection_torch2_tpu/data/loader.py:26-247).

A background thread stages the next host batch while the current one runs,
so host work and device compute overlap. Batches are host numpy arrays,
static-shaped (fixed batch size, fixed max-G) except a ragged final batch
when `drop_last=False`, as the JAX loader yields them with `mesh=None`.

Two sources:
- RecordDataset (packed, memmap) — the fast path;
- any indexable dataset yielding (image, gt) — with `collate` padding, and
  `num_workers` spawned decode workers (data/ingest.py).

`device_cache=True` (a RecordDataset and drop_last only, as in the JAX
package) uploads the dataset to `device` once (data/device_cache.py) and
yields device tensors gathered there from the same shuffled, per-batch
sorted indices: the same batches as streaming, bit for bit.

Not ported yet (ROADMAP Queue 1 G2, scale-out): a data-parallel `mesh` and
multi-process loading; `mesh` raises NotImplementedError.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from object_detection_torch2_tpu_torch.data.voc import collate


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        max_gt: int = 64,
        mesh=None,
        prefetch: int = 2,
        drop_last: bool = True,
        num_workers: int = 0,
        stack_steps: int = 1,
        device_cache: bool = False,
        device=None,
    ):
        """device: where `device_cache` keeps the dataset (None: the CUDA
        card, raising without one; "cpu" for the CPU); unused without it."""
        if mesh is not None:
            raise NotImplementedError("DataLoader(mesh=...): data-parallel loading is not ported yet "
                                      "(ROADMAP Queue 1 G2)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.max_gt = max_gt
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0
        self._is_records = hasattr(dataset, "batch")
        # decode workers for the raw (non-records) path — the reference's
        # num_workers concurrency (src/train.py:23); the records path is
        # memmap-read-bound and needs none. The pool spawns lazily on first
        # iteration and persists across epochs; at most one worker per batch.
        self.num_workers = 0 if self._is_records else max(0, int(num_workers))
        self._pool = None
        # stack_steps=K groups K consecutive batches into (K, B, ...) stacks
        # (one dispatch per K steps); the final group of an epoch may be shorter
        self.stack_steps = max(1, int(stack_steps))
        self._cache = None
        if device_cache:
            if not self._is_records:
                raise ValueError("device_cache requires a packed RecordDataset (data/records.py)")
            if not drop_last:
                raise ValueError("device_cache requires drop_last=True (static batch shapes)")
            from object_detection_torch2_tpu_torch.data.device_cache import DeviceCache

            self._cache = DeviceCache(dataset, device)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        """Per-batch index arrays, in the JAX loader's order: the seed + epoch
        shuffle, then consecutive slices."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        stop = n - n % self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            yield order[start : start + self.batch_size]

    def _ensure_pool(self):
        if self._pool is None and self.num_workers > 0:
            from object_detection_torch2_tpu_torch.data.ingest import IngestPool

            self._pool = IngestPool(
                self.dataset, min(self.num_workers, max(1, len(self))), max_gt=self.max_gt
            )
        return self._pool

    def _host_batches(self):
        if not self._is_records and self._ensure_pool() is not None:
            yield from self._pool.batches(self._index_batches())
            return
        for idx in self._index_batches():
            if self._is_records:
                images, gts = self.dataset.batch(np.sort(idx))
                images, gts = np.ascontiguousarray(images), np.ascontiguousarray(gts)
            else:
                images, gts = collate([self.dataset[int(i)] for i in idx], max_gt=self.max_gt)
            yield images, gts

    def close(self):
        """Shut down the worker pool (idempotent; also runs at GC)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __del__(self):  # best-effort; close() is the explicit surface
        try:
            self.close()
        except Exception:
            pass

    def _stacked_host_batches(self):
        """Group `stack_steps` host batches into (K, B, ...) stacks."""
        group: list = []
        for batch in self._host_batches():
            group.append(batch)
            if len(group) == self.stack_steps:
                yield tuple(np.stack(parts) for parts in zip(*group))
                group = []
        if group:  # epoch tail: a shorter stack
            yield tuple(np.stack(parts) for parts in zip(*group))

    def _cached_device_batches(self):
        """device_cache: gathers on the device of the index sequence the
        streaming path reads, each batch's indices sorted as the records read
        sorts them — (K, B) stacks when stack_steps > 1 (the epoch's tail a
        shorter stack), (B,) otherwise."""
        group: list = []
        for idx in self._index_batches():
            idx = np.sort(idx)
            if self.stack_steps == 1:
                yield self._cache.gather(idx)
                continue
            group.append(idx)
            if len(group) == self.stack_steps:
                yield self._cache.gather(np.stack(group))
                group = []
        if group:
            yield self._cache.gather(np.stack(group))

    def __iter__(self):
        """Yield (images, gts): host arrays, or device tensors with the
        device cache — (K, B, ...) stacks when `stack_steps` K > 1; a
        background thread keeps `prefetch` batches staged ahead, and a
        failure in it is re-raised here."""
        self.epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        failure: list[BaseException] = []
        if self._cache is not None:
            source = self._cached_device_batches
        else:
            source = self._stacked_host_batches if self.stack_steps > 1 else self._host_batches

        def producer():
            try:
                for batch in source():
                    q.put(batch)
            except BaseException as e:  # re-raised in the consumer — a decode
                failure.append(e)       # error must not silently end the epoch
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if failure:
                    raise failure[0]
                break
            yield item
