"""Device-to-host result pipelining for serving and evaluation loops
(counterpart of object_detection_torch2_tpu/utils/hostsync.py:21-44).

A loop that copies each batch's results to the host right after it
dispatches the batch waits for the whole batch on the card, and the card
then idles while the host consumes the results. `FetchPipeline` defers the
wait: `push` starts each CUDA tensor's copy into a pinned host buffer
(`non_blocking=True`) and records a CUDA event behind it; the item comes
back `depth` pushes later, once its event has been synchronized, so the card
computes the later batches while the host consumes this one.

The pipeline owns `depth + 1` sets of pinned buffers and reuses them in
turn: a buffer is refilled only after the item that held it came back, whose
copy had finished. An item that `push` or `flush` returns stays valid until
the next `push`; copy what must outlive it. CPU tensors and other leaves
pass through as they are.
"""

from __future__ import annotations

from collections import deque

import torch


def _leaves(tree, out: list):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


class FetchPipeline:
    """Deferred host fetches: push (nested tuples, lists and dicts of) results,
    receive each back `depth` pushes later, then `flush()` the tail. depth=0
    returns each item from its own push, after its copy."""

    def __init__(self, depth: int = 2):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        self.depth = depth
        self._q: deque = deque()
        self._buffers: list[list] = [[] for _ in range(depth + 1)]
        self._slot = 0

    def _buffer(self, slot: list, i: int, t: torch.Tensor) -> torch.Tensor:
        if i < len(slot) and slot[i].shape == t.shape and slot[i].dtype == t.dtype:
            return slot[i]
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if i < len(slot):
            slot[i] = buf
        else:
            slot.append(buf)
        return buf

    def push(self, item):
        """Enqueue `item`, starting the copy of its CUDA tensors; returns the
        item pushed `depth` pushes ago (on the host), else None."""
        slot = self._buffers[self._slot]
        self._slot = (self._slot + 1) % len(self._buffers)
        host, event, n_cuda = [], None, 0
        for leaf in _leaves(item, []):
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
                buf = self._buffer(slot, n_cuda, leaf)
                buf.copy_(leaf, non_blocking=True)
                host.append(buf)
                n_cuda += 1
                if event is None:
                    event = torch.cuda.Event()
                    with torch.cuda.device(leaf.device):
                        event_stream = torch.cuda.current_stream()
            else:
                host.append(leaf)
        if event is not None:
            event.record(event_stream)
        self._q.append((_rebuild(item, iter(host)), event))
        if len(self._q) > self.depth:
            return self._pop()
        return None

    def _pop(self):
        item, event = self._q.popleft()
        if event is not None:
            event.synchronize()
        return item

    def flush(self):
        """Yield the items still queued, in order."""
        while self._q:
            yield self._pop()
