"""Multiprocess host ingestion: decode workers for the raw-VOC path
(copy of object_detection_torch2_tpu/data/ingest.py:39-94).

The reference's only concurrency is its torch DataLoader worker pool
(num_workers=8 — reference: src/train.py:23,59,65). The packed records path
needs none, but the raw-VOC path (records-less evaluation, `pack_voc`
itself) does a PIL decode + XML parse + resize per sample, which is
CPU-bound and single-threaded without this module.

Workers are SPAWNED, not forked: a forked child would inherit the parent's
threads (the loader's prefetch thread, a CUDA context), which are not
fork-safe. The dataset object is pickled once per worker at pool start
(initializer), not per task.

Task submission is SEMAPHORE-GATED: multiprocessing.Pool.imap drains its input
iterator eagerly, so a whole epoch would be decoded into the unbounded result
cache if the consumer is slower than the workers; the gate caps in-flight
tasks at ~2 per worker.

Spawn contract: a script that reaches pool creation from module top level
must guard its entry point with `if __name__ == "__main__":` — spawn
re-imports __main__ in each worker.
"""

from __future__ import annotations

import multiprocessing as mp
import threading

_DS = None
_MAX_GT = None


def _init_worker(dataset, max_gt):
    global _DS, _MAX_GT
    _DS = dataset
    _MAX_GT = max_gt


def _load_collated(idx):
    from object_detection_torch2_tpu_torch.data.voc import collate

    return collate([_DS[int(i)] for i in idx], max_gt=_MAX_GT)


def _load_sample(i):
    return _DS[int(i)]


class IngestPool:
    """Spawned decode-worker pool over an indexable (image, gt) dataset."""

    def __init__(self, dataset, num_workers: int, max_gt: int = 64):
        self.num_workers = max(1, int(num_workers))
        ctx = mp.get_context("spawn")
        self._pool = ctx.Pool(self.num_workers, initializer=_init_worker,
                              initargs=(dataset, max_gt))

    def _gated(self, fn, items, chunksize: int, inflight: int):
        sem = threading.Semaphore(inflight)

        def feed():
            for item in items:
                sem.acquire()
                yield item

        for res in self._pool.imap(fn, feed(), chunksize=chunksize):
            sem.release()
            yield res

    def batches(self, index_lists):
        """Ordered stream of collated (images, gts) batches, one per index list."""
        yield from self._gated(_load_collated, index_lists, chunksize=1,
                               inflight=2 * self.num_workers)

    def samples(self, indices, chunksize: int = 16):
        """Ordered stream of raw (image, gt) samples (pack_voc's unit)."""
        yield from self._gated(_load_sample, indices, chunksize=chunksize,
                               inflight=4 * self.num_workers * chunksize)

    def close(self):
        self._pool.terminate()
        self._pool.join()
