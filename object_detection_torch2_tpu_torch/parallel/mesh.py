"""Data-parallel mesh on torch.distributed
(counterpart of object_detection_torch2_tpu/parallel/mesh.py:1-130).

The JAX package builds one 1-D `Mesh(('data',))` over every process's
devices: batches are sharded over it, the state is replicated, and XLA
inserts the collectives. The port takes PyTorch's idiom instead: one process
drives one device, and a `Mesh` is the small record of what a process needs
to take part — the process group of its device collectives (NCCL for CUDA
tensors, gloo for CPU tensors), a gloo group for the collectives on host
arrays (NCCL takes CUDA tensors only), its rank, the world size and its
device. Every function of the port that takes `mesh=` in the JAX package
takes one of these.

What the mesh computes is the JAX package's:
- each rank holds the contiguous rows [rank * n, (rank + 1) * n) of every
  global batch (`local_rows`);
- BatchNorm's batch statistics are those of the global batch: each rank's
  per-image moments gathered exactly in global image order (`gather_rows`,
  models/bn.py), with a backward that all-reduces too;
- the gradient and the loss are the global batch's: one all-reduce of the
  flattened trainable gradients, then the mean (`all_reduce_mean_`);
- the state is replicated without a broadcast: ranks build the same seeded
  model, and `replicate` checks that once with a fingerprint all-gather.

Ways in:
- `init_distributed()` (the CLIs' `--distributed`): torchrun's environment
  (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), the counterpart of
  the JAX package's auto-detection. Without it it raises: it never makes a
  world of one quietly;
- `launch(fn, nprocs, ...)` (the CLIs' `--num_devices N`): N local processes
  started with the spawn method, which meet through a FileStore in a
  temporary directory; rank r drives `cuda:r`, or the CPU over gloo. A rank
  that fails ends the others, and `launch` raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from object_detection_torch2_tpu_torch import resolve_device

ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# a collective that waits longer than this raises instead of hanging
COLLECTIVE_TIMEOUT = timedelta(minutes=10)


@dataclass(frozen=True)
class Mesh:
    """One process's place in a 1-D data-parallel mesh.

    group: the process group of collectives on `device`'s tensors;
    host_group: a gloo group for collectives on host arrays (the same as
    `group` when that is gloo). Both None only for a mesh that never runs a
    collective (e.g. to ask a DataLoader for a rank's slices)."""

    rank: int
    world: int
    device: torch.device
    group: object = None
    host_group: object = None

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)

    def __deepcopy__(self, memo):  # process groups are not copied: a copy joins the same mesh
        return self


def default_backend(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _check_backend(backend: str, device: torch.device):
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend takes CUDA tensors only; device {device} needs gloo")


def make_mesh(device, group=None) -> Mesh:
    """The Mesh of this process in `group` (default: the initialized default
    process group) on `device`. Collective: every rank of the group calls
    it, since it creates the host-side gloo group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (init_distributed or launch)")
    device = torch.device(device)
    group = group or dist.group.WORLD
    _check_backend(dist.get_backend(group), device)
    if dist.get_backend(group) == "gloo":
        host_group = group
    else:
        host_group = dist.new_group(ranks=dist.get_process_group_ranks(group), backend="gloo",
                                    timeout=COLLECTIVE_TIMEOUT)
    return Mesh(rank=dist.get_rank(group), world=dist.get_world_size(group), device=device, group=group,
                host_group=host_group)


def _rank_device(device, local_rank: int) -> torch.device:
    """`device` for a rank: None or a bare "cuda" -> cuda:<local_rank>; an
    explicit index or the CPU as given. A CUDA device without a card, or an
    index the host does not have, raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank device {dev}: this host has {torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(dev)
    return dev


def init_distributed(backend: str | None = None, device=None) -> Mesh:
    """Join the process group that torchrun's environment describes and
    return this process's Mesh (the `--distributed` flag).

    device: None -> cuda:<LOCAL_RANK> (raising without a card); "cpu" for a
    CPU cluster. backend: default NCCL on CUDA and gloo on the CPU; gloo on
    CUDA tensors is allowed (several ranks on one card, where NCCL refuses a
    duplicate GPU). NCCL for a CPU device raises."""
    missing = [v for v in ENV_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs the environment torchrun sets ({', '.join(ENV_VARS)}); "
                           f"{', '.join(missing)} unset")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    dev = _rank_device(device, int(os.environ["LOCAL_RANK"]))
    backend = backend or default_backend(dev)
    _check_backend(backend, dev)
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), timeout=COLLECTIVE_TIMEOUT)
    return make_mesh(dev)


def init_process(rank: int, world: int, store_path, backend: str | None = None, device=None) -> Mesh:
    """Join a process group of `world` ranks that meet through a FileStore
    at `store_path` (one host), as rank `rank`; -> its Mesh."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    dev = _rank_device(device, rank)
    backend = backend or default_backend(dev)
    _check_backend(backend, dev)
    store = dist.FileStore(str(store_path), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)
    return make_mesh(dev)


def shutdown():
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _spawned(rank: int, fn, world: int, workdir: str, backend, devices, threads: int, args):
    """Body of a process started by `launch`: join the group, run
    fn(mesh, *args), write its result for the launcher."""
    if torch.device(devices[rank]).type == "cpu":
        torch.set_num_threads(threads)
    # every rank of a launch runs on this host: gloo talks over the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    mesh = init_process(rank, world, Path(workdir) / "store", backend, devices[rank])
    try:
        result = fn(mesh, *args)
        dist.barrier(group=mesh.host_group)
    finally:
        shutdown()
    torch.save(result, Path(workdir) / f"result{rank}.pt")


def launch(fn, nprocs: int, args=(), device_type: str = "cuda", backend: str | None = None,
           timeout: float | None = None, devices=None) -> list:
    """Run fn(mesh, *args) in `nprocs` new processes (the spawn start method:
    a fork after CUDA is initialized breaks), rank r on cuda:r or on the CPU
    (`device_type`), or on `devices[r]` when a list is given (several ranks
    on one card need gloo: NCCL refuses a duplicate GPU), and return each
    rank's result in rank order (picklable values; tensors come back on the
    CPU).

    `fn` must be importable by name (a module-level function). The ranks meet
    through a FileStore in a temporary directory, removed at the end. On the
    CPU each rank takes an equal share of this process's intra-op threads.
    A rank that raises or dies ends the others and makes `launch` raise;
    `timeout` seconds without every rank done ends them all and raises
    TimeoutError."""
    import torch.multiprocessing as mp

    if devices is None:
        if device_type == "cuda" and nprocs > torch.cuda.device_count():
            raise ValueError(f"{nprocs} ranks need {nprocs} CUDA devices; this host has "
                             f"{torch.cuda.device_count()}")
        devices = [f"cuda:{r}" if device_type == "cuda" else "cpu" for r in range(nprocs)]
    if len(devices) != nprocs:
        raise ValueError(f"{nprocs} ranks, {len(devices)} devices")
    devices = [str(d) for d in devices]
    workdir = tempfile.mkdtemp(prefix="odt_mesh_")
    threads = max(1, torch.get_num_threads() // nprocs)
    try:
        ctx = mp.start_processes(_spawned, args=(fn, nprocs, workdir, backend, devices, threads, tuple(args)),
                                 nprocs=nprocs, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=0.5):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"launch: {nprocs} ranks not done after {timeout} s")
        return [torch.load(Path(workdir) / f"result{r}.pt", map_location="cpu", weights_only=False)
                for r in range(nprocs)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def local_rows(rows, mesh: Mesh | None):
    """This rank's contiguous rows [rank * n, (rank + 1) * n) of a global
    batch of world * n rows; no mesh: all rows."""
    if mesh is None:
        return rows
    n = len(rows) // mesh.world
    return rows[mesh.rank * n:(mesh.rank + 1) * n]


def all_reduce_mean_(tensors, mesh: Mesh) -> None:
    """Replace each tensor (on the mesh's device) by its mean over the
    ranks, in place: one flattened buffer and one all-reduce for each dtype
    (one for a float32 train step's gradients and loss)."""
    tensors = list(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world)
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))


def all_gather_rows(array: np.ndarray, mesh: Mesh) -> list[np.ndarray]:
    """Every rank's `array` (rows may differ in number, trailing shapes and
    dtype may not), in rank order, over the host group: the row counts
    all-gathered, each array padded to the largest, all-gathered, trimmed."""
    array = np.ascontiguousarray(array)
    size = torch.tensor([array.shape[0]], dtype=torch.int64)
    sizes = [torch.zeros_like(size) for _ in range(mesh.world)]
    dist.all_gather(sizes, size, group=mesh.host_group)
    sizes = [int(s) for s in sizes]
    padded = np.zeros((max(max(sizes), 1), *array.shape[1:]), array.dtype)
    padded[:len(array)] = array
    mine = torch.from_numpy(padded)
    everyone = [torch.empty_like(mine) for _ in range(mesh.world)]
    dist.all_gather(everyone, mine, group=mesh.host_group)
    return [t[:n].numpy() for t, n in zip(everyone, sizes)]


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank (over the host group); nothing without a mesh."""
    if mesh is not None:
        dist.barrier(group=mesh.host_group)


class _GatherRows(torch.autograd.Function):
    """Each rank's rows into the global tensor, in rank order: one all-reduce
    of a zero-filled global tensor in which each rank fills its own rows
    (exact: x + 0 = x). Backward: the same all-reduce of the gradient, then
    each rank takes its own rows."""

    @staticmethod
    def forward(ctx, local, group, rank, world):
        ctx.group, ctx.rows = group, slice(rank * len(local), (rank + 1) * len(local))
        full = local.new_zeros((world * len(local), *local.shape[1:]))
        full[ctx.rows] = local
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, grad):
        total = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(total, group=ctx.group)
        return total[ctx.rows], None, None, None


def gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global (world * n, ...) tensor of every rank's (n, ...) `local`
    rows in rank order, which is global row order (`local_rows`); exact and
    differentiable. The backward sums the incoming gradients over the ranks
    (with the global loss, the mean of the ranks' losses, every rank's rows
    feed every rank's loss) and gives each rank its own rows. BatchNorm
    gathers its per-image moments with it (models/bn.py), so every rank adds
    the same rows in the same order as one process. Over one rank it is
    `local` itself, bit for bit."""
    return _GatherRows.apply(local, mesh.group, mesh.rank, mesh.world)


def fingerprint(module: torch.nn.Module) -> str:
    """A digest of every parameter and buffer of `module` (names, dtypes,
    shapes and bytes)."""
    h = hashlib.blake2b(digest_size=16)
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        t = t.detach().cpu().contiguous()
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def replicate(module: torch.nn.Module, mesh: Mesh | None) -> torch.nn.Module:
    """`module`, replicated over the mesh without a broadcast: every rank
    built it from the same seed and weights (as the JAX package's `replicate`
    assumes), and one all-gather of a fingerprint checks that, once, at
    start-up; ranks that differ raise. Returns `module` itself."""
    if mesh is None or mesh.world == 1:
        return module
    mine = fingerprint(module)
    everyone = [None] * mesh.world
    dist.all_gather_object(everyone, mine, group=mesh.host_group)
    differ = [r for r, other in enumerate(everyone) if other != mine]
    if differ:
        raise RuntimeError(f"rank {mesh.rank}: the model's parameters or buffers differ from rank(s) {differ}; "
                           "every rank must build the same model")
    return module
