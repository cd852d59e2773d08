"""Library-level batched detector
(counterpart of object_detection_torch2_tpu/infer.py:41-155, 165-269).

`Predictor` runs the serving path per batch of uint8 images: to_tensor ->
SSD forward -> box decode and one-class-kept scores -> greedy NMS (the CUDA
sweep kernel on the card) -> top-K -> packed (N, K, 6) rows plus `n_valid`.
Ragged final batches are padded by repeating the last image and masked: the pad
rows are excluded from BatchNorm batch statistics and their detections zeroed.

`DetectionPipeline` is that path as one module of tensors in and tensors out,
which serving.py exports; `build_detection_pipeline` runs it eagerly, one
batch or K stacked batches a call (`batches_per_dispatch`), with the packed
rows optionally cast to float16 before they leave the card (`d2h_half`).
`Predictor.predict` drains the results through `utils.hostsync.FetchPipeline`,
so that a batch's copy to the host overlaps the next batches.

Under a data-parallel mesh (`mesh=`, a parallel.mesh.Mesh; one process a
device) each rank runs its contiguous rows of every global batch with the
GLOBAL `n_real`: rows whose global index is >= n_real are masked out of the
BatchNorm statistics, which are the global batch's (models/bn.py), and their
detections zeroed; the NMS kernel sweeps the rank's own rows (greedy NMS is
per image). `Predictor(mesh=)` gathers the ranks' rows back, so every rank's
`predict` returns the detections of every image, as one process's does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from object_detection_torch2_tpu_torch import resolve_device
from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
from object_detection_torch2_tpu_torch.core.boxes import decode_boxes
from object_detection_torch2_tpu_torch.data.augment import to_tensor_batch
from object_detection_torch2_tpu_torch.models.bn import set_mesh
from object_detection_torch2_tpu_torch.ops.nms import non_maximum_suppression
from object_detection_torch2_tpu_torch.ops.scores import calc_scores, top_k_detections
from object_detection_torch2_tpu_torch.parallel.mesh import all_gather_rows, local_rows, replicate
from object_detection_torch2_tpu_torch.serving import unpack_detections
from object_detection_torch2_tpu_torch.utils.hostsync import FetchPipeline


@dataclass
class Detections:
    """Per-image detections in normalized center-form coordinates."""

    boxes: np.ndarray  # (K, 4) [cx, cy, w, h]
    class_ids: np.ndarray  # (K,) 0-based object class ids (void removed)
    scores: np.ndarray  # (K,)


def postprocess(out: torch.Tensor, df: torch.Tensor, mask: torch.Tensor, iou_thresh: float = 0.5,
                max_detections: int = 200, sweep=None):
    """Head outputs (N, P, 4+C) -> (packed (N, K, 6) float32, n_valid (N,)).

    packed rows are [cx, cy, w, h, class_id, score], score-descending; mask
    (N,) is 1 for real rows. `sweep` is the NMS sweep (None: the kernel on the
    card, the plain sweep on the CPU — see ops/nms.py)."""
    post = torch.cat([decode_boxes(out, df), calc_scores(out)], dim=-1)
    post = non_maximum_suppression(post, iou_thresh=iou_thresh, sweep=sweep)
    confs = post[..., 4:]
    n_valid = ((confs.amax(dim=-1) > 0) & (confs.argmax(dim=-1) != 0) & (mask > 0)[:, None]).sum(dim=-1)
    boxes, classes, scores = top_k_detections(post, max_detections, batch_mask=mask)
    packed = torch.cat([boxes, classes[..., None].to(boxes.dtype), scores[..., None]], dim=-1)
    return packed.to(torch.float32), n_valid


class DetectionPipeline(nn.Module):
    """forward(images_u8 (N, H, W, 3) uint8, n_real) -> (packed (N, K, 6),
    n_valid (N,)) for one SSD: the whole serving path as tensors in and out,
    the device taken from the images. n_real (an int or a 0-d tensor) masks
    a padded ragged final batch: pad rows are excluded from BN batch
    statistics and their detections zeroed. With d2h_half the packed rows
    come out as float16 (round to nearest even; boxes and scores to ~5e-4
    relative, class ids <= 20 exact, scores below 6e-8 flush to zero).
    Under a mesh the images are the rank's slice of the global batch and
    n_real counts the global batch's real rows."""

    def __init__(self, model, use_batch_stats: bool, imsize: int = 300, iou_thresh: float = 0.5,
                 max_detections: int = 200, d2h_half: bool = False, mesh=None):
        super().__init__()
        self.model = model
        self.rank = 0 if mesh is None else mesh.rank
        self.use_batch_stats = use_batch_stats
        self.iou_thresh = iou_thresh
        self.max_detections = max_detections
        self.d2h_half = d2h_half
        self.register_buffer("df", torch.from_numpy(default_boxes(feature_grids_for(imsize)).copy()),
                             persistent=False)

    def forward(self, images_u8: torch.Tensor, n_real):
        n = images_u8.shape[0]
        rows = torch.arange(n, device=images_u8.device)
        if self.rank:  # the rows' global indices: this rank holds [rank * n, (rank + 1) * n)
            rows = rows + self.rank * n
        mask = (rows < n_real).to(torch.float32)
        out = self.model(to_tensor_batch(images_u8), use_batch_stats=self.use_batch_stats,
                         batch_mask=mask if self.use_batch_stats else None)
        packed, n_valid = postprocess(out, self.df, mask, self.iou_thresh, self.max_detections)
        return (packed.to(torch.float16) if self.d2h_half else packed), n_valid


def build_detection_pipeline(model, use_batch_stats: bool, imsize: int = 300, iou_thresh: float = 0.5,
                             max_detections: int = 200, device=None, d2h_half: bool = False, mesh=None):
    """-> run(images_u8 (N, H, W, 3) uint8, n_real) -> (packed (N, K, 6), n_valid (N,)),
    both on `device`.

    device=None means the CUDA card, and raises without one; pass "cpu" to run
    on the CPU. The model is moved to `device` (in place, as `nn.Module.to`
    does) and used in eval mode: batch statistics, when asked for, normalize
    but never update the running ones. n_real masks a padded ragged final
    batch: pad rows are excluded from BN batch statistics and their detections
    zeroed. n_valid counts the survivors before the top-K cut.

    run also takes K stacked batches, images_u8 (K, N, H, W, 3) with n_real
    (K,), and returns (K, N, K_det, 6) / (K, N): each batch through the same
    path, with its own BN batch-statistics window (the same as K calls), and
    the K batches' rows in one tensor, so one copy brings them to the host.
    d2h_half: the packed rows as float16 (see `DetectionPipeline`).

    mesh: a parallel.mesh.Mesh; run then takes this rank's slice of each
    global batch and the global n_real (see the module docstring), on the
    mesh's device (the default device then). The model gets the mesh (its
    BatchNorms sync) and is checked equal on every rank once."""
    if mesh is not None and device is None:
        device = mesh.device
    device = resolve_device(device)
    replicate(set_mesh(model.to(device).eval(), mesh), mesh)
    pipe = DetectionPipeline(model, use_batch_stats, imsize, iou_thresh, max_detections, d2h_half,
                             mesh=mesh).to(device)

    @torch.inference_mode()
    def run(images_u8, n_real):
        images_u8 = torch.as_tensor(images_u8).to(device)
        if images_u8.dim() == 5:
            outs = [pipe(images_u8[k], int(r)) for k, r in enumerate(n_real)]
            return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
        return pipe(images_u8, n_real)

    return run


class Predictor:
    def __init__(self, model, imsize: int = 300, batch_size: int = 8, use_batch_stats: bool = True,
                 iou_thresh: float = 0.5, max_detections: int = 200, device=None, batches_per_dispatch: int = 1,
                 d2h_half: bool = False, mesh=None):
        """`model` is an `SSD` holding its weights. use_batch_stats=True is the
        reference-parity default (quirk Q9: the reference never calls .eval(),
        so its inference normalizes with batch statistics); pad rows of a
        ragged final batch are masked out of the statistics. device=None
        means the CUDA card; pass device="cpu" to run on the CPU.

        batches_per_dispatch=K runs K consecutive batches a call, their rows
        brought to the host in one copy (the same detections as K = 1);
        leftover batches at the end run one at a time. d2h_half=True copies
        the packed rows as float16 (see `DetectionPipeline`).

        mesh: a parallel.mesh.Mesh; `batch_size` is the global batch and
        must divide over its ranks. Every rank calls `predict` with the same
        images, runs its slice of each batch, and gets every image's
        detections back (the ranks' rows are all-gathered)."""
        if mesh is not None and batch_size % mesh.world:
            raise ValueError(f"batch_size {batch_size} must divide over {mesh.world} devices")
        if batches_per_dispatch < 1:
            raise ValueError(f"batches_per_dispatch must be >= 1, got {batches_per_dispatch}")
        self.model = model
        self.imsize = imsize
        self.batch_size = batch_size
        self.batches_per_dispatch = batches_per_dispatch
        self.mesh = mesh
        self._run = build_detection_pipeline(model, use_batch_stats, imsize=imsize, iou_thresh=iou_thresh,
                                             max_detections=max_detections, device=device, d2h_half=d2h_half,
                                             mesh=mesh)

    def predict(self, images_u8: np.ndarray, fetch_depth: int = 2) -> list[Detections]:
        """images_u8: (M, imsize, imsize, 3) uint8, any M — processed in
        static-size batches (final batch padded + masked, padding discarded).

        Pipelined (utils.hostsync.FetchPipeline): each dispatch's packed rows
        start their copy to the host at once and are consumed `fetch_depth`
        dispatches later."""
        images_u8 = np.asarray(images_u8)
        results: list[Detections] = []
        pipe = FetchPipeline(fetch_depth)
        chunks: list[np.ndarray] = []
        reals: list[int] = []
        for start in range(0, len(images_u8), self.batch_size):
            chunk = images_u8[start:start + self.batch_size]
            real = len(chunk)
            if real < self.batch_size:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], self.batch_size - real, 0)])
            chunks.append(local_rows(chunk, self.mesh))
            reals.append(real)
            if len(chunks) == self.batches_per_dispatch:
                packed, _ = self._run(np.stack(chunks), reals)
                self._drain(pipe.push((packed, reals)), results)
                chunks, reals = [], []
        for chunk, real in zip(chunks, reals):  # leftover batches (< K), one at a time
            packed, _ = self._run(chunk, real)
            self._drain(pipe.push((packed[None], [real])), results)
        for done in pipe.flush():
            self._drain(done, results)
        return results

    def _drain(self, done, results: list[Detections]):
        if done is None:
            return
        packed_k, reals = done
        for packed, real in zip(packed_k, reals):
            packed = packed.numpy()
            if self.mesh is not None:  # every rank's rows, in global order
                packed = np.concatenate(all_gather_rows(packed, self.mesh))
            boxes, classes, scores = unpack_detections(packed)
            for i in range(real):
                keep = scores[i] > 0
                results.append(Detections(
                    boxes=boxes[i, keep],
                    class_ids=classes[i, keep] - 1,  # shift void out (dataset +1 convention)
                    scores=scores[i, keep],
                ))
