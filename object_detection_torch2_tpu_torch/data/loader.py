"""Input pipeline: batching with a background prefetch thread
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

Several processes (the JAX loader's rules, its lines 85-123): every process
computes the same global index order (the shared seed) and reads only its
contiguous slice of each global batch, rows [rank * pp, (rank + 1) * pp)
with pp = batch_size // world (`parallel.mesh.local_rows`). With a `mesh`
(training) `drop_last` is required, so that every slice has pp rows. With
`mesh=None` in a process of an initialized multi-process group (serving:
`--distributed` / `--num_devices` in the serving CLIs) the final batch may be
short: only the final slices may be short or empty, and a process whose
slice is empty still yields it, with the trailing shapes, since every
process joins every collective. `batch_size` is the global batch; it must
divide over the processes.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch.distributed as dist

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
        """device: where `device_cache` keeps the dataset (None: the mesh's
        device, else the CUDA card, raising without one; "cpu" for the CPU);
        unused without it. mesh: a parallel.mesh.Mesh (data-parallel
        training; see the module docstring)."""
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
        self.mesh = mesh
        # the processes that share each global batch, and this one's place
        if mesh is not None:
            self._num_procs, self._proc = mesh.world, mesh.rank
        elif dist.is_initialized():
            self._num_procs, self._proc = dist.get_world_size(), dist.get_rank()
        else:
            self._num_procs, self._proc = 1, 0
        if self._num_procs > 1:
            if mesh is not None and not drop_last:
                raise ValueError("multi-process DataLoader with a mesh requires drop_last=True (a ragged "
                                 "final batch cannot be split into equal-shaped per-process slices)")
            if batch_size % self._num_procs:
                raise ValueError(f"batch_size {batch_size} must divide over {self._num_procs} processes")
        self._cache = None
        if device_cache:
            if not self._is_records:
                raise ValueError("device_cache requires a packed RecordDataset (data/records.py)")
            if not drop_last:
                raise ValueError("device_cache requires drop_last=True (static batch shapes)")
            from object_detection_torch2_tpu_torch.data.device_cache import DeviceCache

            self._cache = DeviceCache(dataset, device, mesh=mesh)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        """Per-batch index arrays, in the JAX loader's order: the seed + epoch
        shuffle, then consecutive slices (this process's slice of each with
        several processes)."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        stop = n - n % self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            idx = order[start : start + self.batch_size]
            if self._num_procs > 1:
                per_proc = self.batch_size // self._num_procs
                idx = idx[self._proc * per_proc : (self._proc + 1) * per_proc]
            yield idx

    def _ensure_pool(self):
        if self._pool is None and self.num_workers > 0:
            from object_detection_torch2_tpu_torch.data.ingest import IngestPool

            self._pool = IngestPool(
                self.dataset, min(self.num_workers, max(1, len(self))), max_gt=self.max_gt
            )
        return self._pool

    def _empty_batch(self):
        """A (0, ...) batch with the trailing shapes: what a process whose
        final slice is empty yields."""
        if self._is_records:
            images, gts = self.dataset.batch(np.zeros(0, np.int64))
            return np.ascontiguousarray(images), np.ascontiguousarray(gts)
        images, gts = collate([self.dataset[0]], max_gt=self.max_gt)
        return images[:0], gts[:0]

    def _host_batches(self):
        if not self._is_records and self._ensure_pool() is not None:
            idxs = list(self._index_batches())
            empty_tail = sum(1 for i in idxs if len(i) == 0)  # only the final slice can be empty
            yield from self._pool.batches(iter(i for i in idxs if len(i)))
            for _ in range(empty_tail):
                yield self._empty_batch()
            return
        for idx in self._index_batches():
            if len(idx) == 0:
                yield self._empty_batch()
                continue
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
