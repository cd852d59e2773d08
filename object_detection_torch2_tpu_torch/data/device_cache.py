"""Device-resident dataset cache: the whole packed dataset on the card
(counterpart of object_detection_torch2_tpu/data/device_cache.py:64-108, one
device).

The streaming DataLoader sends every batch's uint8 pixels to the device
every epoch (at batch 32 and imsize 300, 8.6 MB a step). VOC07+12 at
imsize 300 is ~4.5 GB of uint8, which the H100's 80 GB hold beside the model,
so the cache pays that copy once:

- `DeviceCache` uploads the packed record arrays (images uint8, GT float32)
  into buffers allocated on the device once, in 128 MB chunks staged through
  one pinned host buffer (peak host pinning: one chunk);
- `gather(idx)` then takes a batch's rows ON the device with `index_select`
  from host-computed shuffle indices: a step's host-to-device payload drops
  from megabytes of pixels to the indices' bytes.

Batch composition is the streaming path's, bit for bit: the DataLoader
computes the same `np.random.default_rng(seed + epoch)` permutation either
way and sorts each batch's indices as the records read does. One process
only, as the JAX package's: a mesh of one rank is accepted, and several
processes raise with the JAX package's message.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from object_detection_torch2_tpu_torch import resolve_device

# the one-time upload goes in chunks of this many bytes, staged through one
# pinned host buffer
UPLOAD_CHUNK_BYTES = 128 * 2**20


def _upload(arr: np.ndarray, device: torch.device, log=None) -> torch.Tensor:
    """Chunked host -> device copy of `arr` into a buffer allocated once."""
    buf = torch.empty(arr.shape, dtype=torch.from_numpy(np.empty(0, arr.dtype)).dtype, device=device)
    rows = max(1, UPLOAD_CHUNK_BYTES // max(1, arr[:1].nbytes))
    staging = None
    if device.type == "cuda":
        staging = torch.empty((min(rows, len(arr)), *arr.shape[1:]), dtype=buf.dtype, pin_memory=True)
    for start in range(0, arr.shape[0], rows):
        chunk = torch.from_numpy(np.array(arr[start:start + rows]))  # a writable copy of the memmap rows
        if staging is None:
            buf[start:start + len(chunk)].copy_(chunk)
        else:
            stage = staging[:len(chunk)]
            stage.copy_(chunk)
            buf[start:start + len(chunk)].copy_(stage, non_blocking=True)
            # the staging buffer is refilled next: wait for this copy to land
            torch.cuda.current_stream(device).synchronize()
        if log:
            log(start + len(chunk), arr.shape[0])
    return buf


class DeviceCache:
    """A RecordDataset's images and GT resident on one device.

    gather(idx) returns device batches shaped like the streaming loader's:
    (B, ...) for 1-D idx, (K, B, ...) stacks for 2-D idx (the
    `Trainer.train_steps` layout). device=None means the mesh's device
    under a mesh, else the CUDA card, and raises without one; pass "cpu"
    for the CPU."""

    def __init__(self, dataset, device=None, verbose: bool = True, mesh=None):
        world = mesh.world if mesh is not None else (dist.get_world_size() if dist.is_initialized() else 1)
        if world > 1:
            raise ValueError("DeviceCache is single-process; multi-host uses the streaming loader")
        self.device = resolve_device(mesh.device if device is None and mesh is not None else device)
        images, gts = np.asarray(dataset.images), np.asarray(dataset.gts)

        def log(done, n):
            if verbose and (done == n or done % (50 * 1024) < 1024):
                print(f"device cache: {done}/{n} rows resident", flush=True)

        if verbose:
            print(f"device cache: uploading {len(dataset)} samples "
                  f"({(images.nbytes + gts.nbytes) / 1e6:.0f} MB) to {self.device}", flush=True)
        self.images = _upload(images, self.device, log)
        self.gts = _upload(gts, self.device)

    def nbytes(self) -> int:
        return self.images.nbytes + self.gts.nbytes

    def gather(self, idx: np.ndarray):
        """(B,) or (K, B) int indices -> (images, gts) on the device."""
        idx = np.asarray(idx, np.int64)
        flat = torch.from_numpy(idx.reshape(-1))
        if self.device.type == "cuda":
            flat = flat.pin_memory().to(self.device, non_blocking=True)
        images = self.images.index_select(0, flat)
        gts = self.gts.index_select(0, flat)
        return images.reshape(*idx.shape, *self.images.shape[1:]), gts.reshape(*idx.shape, *self.gts.shape[1:])
