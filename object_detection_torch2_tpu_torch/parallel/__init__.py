"""Multi-process data parallelism on torch.distributed
(counterpart of object_detection_torch2_tpu/parallel/)."""

from object_detection_torch2_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather_rows,
    all_reduce_mean_,
    barrier,
    init_distributed,
    init_process,
    launch,
    local_rows,
    make_mesh,
    replicate,
    shutdown,
    sync_moments,
)
