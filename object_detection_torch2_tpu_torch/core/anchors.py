"""Default-bbox ("anchor") generation for SSD300.

Copy of object_detection_torch2_tpu/core/anchors.py (numpy only), which
reproduces the reference generator (reference: src/model/ssd.py:108-133)
exactly, including quirk Q4: the first center coordinate is driven by the
feature-map *row* index `i`, i.e. the anchor grid is transposed relative to
image x/y. Training, decode, and NMS are self-consistent in this convention,
and bit-comparable boxes require reproducing it.
"""

from __future__ import annotations

import functools

import numpy as np

# Feature-grid config: (rows m, cols n, anchors-per-cell A) per pyramid level
# (reference: src/model/ssd.py:118). Total anchors:
# 38*38*4 + 19*19*6 + 10*10*6 + 5*5*6 + 3*3*4 + 1*1*4 = 8732.
FEATURE_GRIDS = ((38, 38, 4), (19, 19, 6), (10, 10, 6), (5, 5, 6), (3, 3, 4), (1, 1, 4))

S_MIN = 0.2
S_MAX = 0.9
NUM_ANCHORS = sum(m * n * a for m, n, a in FEATURE_GRIDS)

# anchors-per-cell at each of the six detector taps (reference: ssd.py:70-77)
ANCHORS_PER_LEVEL = (4, 6, 6, 6, 4, 4)


def feature_grids_for(imsize: int) -> tuple:
    """Detector-tap grid sizes for an arbitrary square input size, derived from
    the conv/pool arithmetic (floor semantics, M_P pad on pool_3):

      tap 4_3:  imsize -> pool1 -> pool2 -> padded pool3
      tap 7_1:  pool4 (layers 6/7 preserve size)
      tap 8_2 / 9_2: 3x3 stride-2 pad-1 convs
      tap 10_2 / 11_2: 3x3 valid convs (-2 each)
    """
    t = imsize // 2 // 2  # pool1, pool2
    t = t // 2 + 1  # pool3 with padding=1
    t43 = t
    t71 = t43 // 2  # pool4
    t82 = (t71 - 1) // 2 + 1  # 3x3 s2 p1
    t92 = (t82 - 1) // 2 + 1
    t102 = t92 - 2
    t112 = t102 - 2
    sizes = (t43, t71, t82, t92, t102, t112)
    if t112 < 1:
        raise ValueError(f"imsize {imsize} too small for the SSD pyramid (tap sizes {sizes})")
    return tuple((s, s, a) for s, a in zip(sizes, ANCHORS_PER_LEVEL))


def scale(k: int, num_levels: int = 6, s_min: float = S_MIN, s_max: float = S_MAX) -> float:
    """Anchor scale for level k (1-based): s_k = s_min + (s_max-s_min)(k-1)/(m-1).

    Levels 1..6 give [0.2, 0.34, 0.48, 0.62, 0.76, 0.9]; the 'add' box of level 6
    extrapolates s_7 = 1.04 with the same formula (reference: src/model/ssd.py:114-115).
    """
    return s_min + (s_max - s_min) * (k - 1) / (num_levels - 1)


@functools.lru_cache(maxsize=None)
def default_boxes(grids: tuple = FEATURE_GRIDS) -> np.ndarray:
    """Build the (P, 4) center-form [cx, cy, w, h] anchor table (P = 8732).

    Enumeration order is level-major, then i (0..m-1), then j (0..n-1), then
    aspect — matching the H-major flatten of the detector-head outputs
    (reference: src/model/ssd.py:120-131 and the permute at ssd.py:103).

    Aspect order per cell: [1, 2, 1/2, ('add')] for A=4, [1, 2, 1/2, 3, 1/3, ('add')]
    for A=6, where 'add' is the extra square box w = h = sqrt(s_k * s_{k+1})
    (reference: src/model/ssd.py:121-129). Box size: w = s_k*sqrt(a), h = s_k/sqrt(a).

    Computed in float64 then cast to float32, matching the reference's Python-float
    arithmetic feeding `torch.Tensor` (float32).
    """
    levels = []
    for k, (m, n, a_num) in enumerate(grids, start=1):
        aspects = (1.0, 2.0, 1 / 2) if a_num == 4 else (1.0, 2.0, 1 / 2, 3.0, 1 / 3)
        s_k = scale(k)
        wh = [(s_k * a ** 0.5, s_k * (1 / a) ** 0.5) for a in aspects]
        s_add = (scale(k) * scale(k + 1)) ** 0.5
        wh.append((s_add, s_add))
        wh = np.asarray(wh, dtype=np.float64)  # (A, 2)
        a = wh.shape[0]

        ii, jj = np.meshgrid(np.arange(m, dtype=np.float64), np.arange(n, dtype=np.float64), indexing="ij")
        centers = np.stack([(ii + 0.5) / m, (jj + 0.5) / n], axis=-1)  # (m, n, 2); Q4: cx <- row index

        boxes = np.concatenate(
            [
                np.broadcast_to(centers[:, :, None, :], (m, n, a, 2)),
                np.broadcast_to(wh[None, None, :, :], (m, n, a, 2)),
            ],
            axis=-1,
        )
        levels.append(boxes.reshape(-1, 4))

    out = np.concatenate(levels, axis=0).astype(np.float32)
    out.setflags(write=False)
    return out
