"""Library-level batched detector
(counterpart of object_detection_torch2_tpu/infer.py:41-155, 165-269, single device).

`Predictor` runs the serving path per batch of uint8 images: to_tensor ->
SSD forward -> box decode and one-class-kept scores -> greedy NMS (the CUDA
sweep kernel on the card) -> top-K -> packed (N, K, 6) rows plus `n_valid`.
Ragged final batches are padded by repeating the last image and masked: the pad
rows are excluded from BatchNorm batch statistics and their detections zeroed.

Not ported here: the data-parallel `mesh`, `batches_per_dispatch` (the K-stacked
scan), `d2h_half` and the overlapped device-to-host fetch pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from object_detection_torch2_tpu_torch import resolve_device
from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
from object_detection_torch2_tpu_torch.core.boxes import decode_boxes
from object_detection_torch2_tpu_torch.data.augment import to_tensor_batch
from object_detection_torch2_tpu_torch.ops.nms import non_maximum_suppression
from object_detection_torch2_tpu_torch.ops.scores import calc_scores, top_k_detections


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


def build_detection_pipeline(model, use_batch_stats: bool, imsize: int = 300, iou_thresh: float = 0.5,
                             max_detections: int = 200, device=None):
    """-> run(images_u8 (N, H, W, 3) uint8, n_real) -> (packed (N, K, 6), n_valid (N,)),
    both on `device`.

    device=None means the CUDA card, and raises without one; pass "cpu" to run
    on the CPU. The model is moved to `device` (in place, as `nn.Module.to`
    does) and used in eval mode: batch statistics, when asked for, normalize
    but never update the running ones. n_real masks a padded ragged final
    batch: pad rows are excluded from BN batch statistics and their detections
    zeroed. n_valid counts the survivors before the top-K cut."""
    device = resolve_device(device)
    model.to(device).eval()
    df = torch.from_numpy(default_boxes(feature_grids_for(imsize)).copy()).to(device)

    @torch.inference_mode()
    def run(images_u8, n_real: int):
        images_u8 = torch.as_tensor(images_u8).to(device)
        n = images_u8.shape[0]
        mask = (torch.arange(n, device=device) < n_real).to(torch.float32)
        out = model(to_tensor_batch(images_u8), use_batch_stats=use_batch_stats,
                    batch_mask=mask if use_batch_stats else None)
        return postprocess(out, df, mask, iou_thresh, max_detections)

    return run


def unpack_detections(packed):
    """Host-side split of the pipeline's packed (N, K, 6) rows ->
    (boxes (N,K,4) f32, class_ids (N,K) int32, scores (N,K) f32)."""
    packed = np.asarray(packed, np.float32)
    return packed[..., :4], packed[..., 4].astype(np.int32), packed[..., 5]


class Predictor:
    def __init__(self, model, imsize: int = 300, batch_size: int = 8, use_batch_stats: bool = True,
                 iou_thresh: float = 0.5, max_detections: int = 200, device=None):
        """`model` is an `SSD` holding its weights. use_batch_stats=True is the
        reference-parity default (quirk Q9: the reference never calls .eval(),
        so its inference normalizes with batch statistics); pad rows of a
        ragged final batch are masked out of the statistics. device=None
        means the CUDA card; pass device="cpu" to run on the CPU."""
        self.model = model
        self.imsize = imsize
        self.batch_size = batch_size
        self._run = build_detection_pipeline(model, use_batch_stats, imsize=imsize, iou_thresh=iou_thresh,
                                             max_detections=max_detections, device=device)

    def predict(self, images_u8: np.ndarray) -> list[Detections]:
        """images_u8: (M, imsize, imsize, 3) uint8, any M — processed in
        static-size batches (final batch padded + masked, padding discarded)."""
        images_u8 = np.asarray(images_u8)
        results: list[Detections] = []
        for start in range(0, len(images_u8), self.batch_size):
            chunk = images_u8[start:start + self.batch_size]
            real = len(chunk)
            if real < self.batch_size:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], self.batch_size - real, 0)])
            packed, _ = self._run(chunk, real)
            boxes, classes, scores = unpack_detections(packed.cpu().numpy())
            for i in range(real):
                keep = scores[i] > 0
                results.append(Detections(
                    boxes=boxes[i, keep],
                    class_ids=classes[i, keep] - 1,  # shift void out (dataset +1 convention)
                    scores=scores[i, keep],
                ))
        return results
