"""Average precision, parity and strict modes
(copy of object_detection_torch2_tpu/metrics/ap.py:17-81, numpy only).

Quirk Q5: the reference sorts each column of its (correct, score) result
INDEPENDENTLY (`torch.sort(result, dim=0)` puts all TPs first, decoupled from
the scores), so its reported "average precision" equals recall = TP/count.
`strict=False` reproduces exactly that (the default — comparisons against the
published 0.314 mAP must use it). `strict=True` ranks by score descending, the
conventional VOC-style interpolated AP.

`merge_accumulators_across_processes` (multi-process evaluation) is not
ported yet; it goes with the scale-out slice.
"""

from __future__ import annotations

import numpy as np
import torch


def _interpolated_ap(correct: np.ndarray, count: float) -> float:
    """The reference's cummax-interpolated AP on an already-ranked 0/1 vector
    (reference: evaluate.py:55-67)."""
    correct = np.asarray(correct, np.float32)
    tp = np.cumsum(correct == 1.0)
    fp = np.cumsum(correct == 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = 1.0 * tp / (tp + fp)
        recall = 1.0 * tp / count
    mod_precision = np.concatenate([[0.0], precision, [0.0]])
    mod_precision = np.flip(np.maximum.accumulate(np.flip(mod_precision)))
    mod_recall = np.concatenate([[0.0], recall, [1.0]])
    return float(np.sum(mod_precision[1:] * (mod_recall[1:] - mod_recall[:-1])))


def average_precision(correct: np.ndarray, scores: np.ndarray, count: int, strict: bool = False) -> float:
    """correct: (X,) 0/1 flags, scores: (X,) detection scores, count: #GTs.

    strict=False: reference parity — rank = correct flags sorted descending
    (scores ignored; Q5). strict=True: rank by score descending.
    """
    correct = np.asarray(correct, np.float32)
    scores = np.asarray(scores, np.float32)
    if strict:
        order = np.argsort(-scores, kind="stable")
        ranked = correct[order]
    else:
        ranked = -np.sort(-correct)
    return _interpolated_ap(ranked, count)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class APAccumulator:
    """Streaming accumulation of detection_matches() outputs over eval batches."""

    def __init__(self, num_classes: int = 20):
        self.num_classes = num_classes
        self.correct = [[] for _ in range(num_classes)]
        self.scores = [[] for _ in range(num_classes)]
        self.counts = np.zeros(num_classes, np.int64)

    def update(self, matches: dict):
        """matches: detection_matches' dict, as tensors on any device or as
        numpy; each leaf is copied to the host once."""
        correct = _host(matches["correct"])  # (N, C, P)
        scores = _host(matches["scores"])
        counts = _host(matches["counts"])
        self.counts += counts.sum(0)
        present = scores > 0.0
        for c in range(self.num_classes):
            mask = present[:, c, :]
            if mask.any():
                self.correct[c].append(correct[:, c, :][mask])
                self.scores[c].append(scores[:, c, :][mask])

    def result(self, strict: bool = False):
        """Per-class AP array (nan where a class never appeared) + mean over
        classes with any rows — the reference takes the mean over the
        classes it collected (evaluate.py:174)."""
        aps = np.full(self.num_classes, np.nan, np.float32)
        for c in range(self.num_classes):
            if not self.correct[c]:
                continue
            correct = np.concatenate(self.correct[c])
            scores = np.concatenate(self.scores[c])
            aps[c] = average_precision(correct, scores, self.counts[c], strict=strict)
        mean = float(np.nanmean(aps)) if np.isfinite(aps).any() else float("nan")
        return aps, mean
