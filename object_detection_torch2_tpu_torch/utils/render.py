"""Detection rendering (counterpart of object_detection_torch2_tpu/utils/render.py:19-72;
reference: src/inference.py:51, 73-101).

PIL drawing with the reference's conventions: skip class 0 (void), scale
normalized center-form coords by imsize, clip to image bounds, draw box and
label text with the seaborn 'hls' palette (n = num_classes + 1), here from
stdlib colorsys. Rendering is host-side output: PIL is imported inside the
functions that draw (`require_pil` raises a clear error without it), so
importing this module needs only numpy.
"""

from __future__ import annotations

import colorsys
from pathlib import Path

import numpy as np


def require_pil():
    """The PIL modules the drawing needs; raises ImportError naming the
    package when PIL does not import."""
    try:
        from PIL import Image, ImageDraw
    except ImportError as e:
        raise ImportError("rendering detections needs PIL (the pillow package)") from e
    return Image, ImageDraw


def hls_palette(n_colors: int, h: float = 0.01, l: float = 0.6, s: float = 0.65):  # noqa: E741
    hues = (np.linspace(0, 1, n_colors + 1)[:-1] + h) % 1.0
    return [colorsys.hls_to_rgb(float(hue), l, s) for hue in hues]


def render_detections(image_f01: np.ndarray, locs: np.ndarray, confs: np.ndarray, labelmap, imsize: int,
                      palette=None):
    """image_f01: (H, W, 3) float [0,1]; locs: (P, 4) decoded center-form;
    confs: (P, C) one-class-kept scores (post-NMS). Returns a PIL image."""
    class_ids = np.argmax(confs, axis=1)
    scores = np.max(confs, axis=1)
    image_u8 = (np.asarray(image_f01) * 255).astype("uint8")
    return render_detections_compact(image_u8, locs, class_ids, scores, labelmap, imsize, palette)


def render_detections_compact(image_u8: np.ndarray, locs: np.ndarray, class_ids: np.ndarray,
                              scores: np.ndarray, labelmap, imsize: int, palette=None):
    """Compacted detections (the pipeline's top-K layout): image_u8 (H, W, 3)
    uint8; locs (K, 4); class_ids (K,) with 0 = void/empty; scores (K,).
    Returns a PIL image drawn on the host uint8 image."""
    Image, ImageDraw = require_pil()
    if palette is None:
        palette = hls_palette(len(labelmap) + 1)
    image = Image.fromarray(np.asarray(image_u8))
    draw = ImageDraw.Draw(image)
    for loc, class_id, score in zip(np.asarray(locs), np.asarray(class_ids), np.asarray(scores)):
        if class_id == 0:  # void
            continue
        cx, cy, w, h = (float(v) * imsize for v in loc)
        xmin, ymin, xmax, ymax = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
        left_top = (max(xmin, 0), max(ymin, 0))
        right_bottom = (min(xmax, imsize), min(ymax, imsize))
        if right_bottom[0] <= left_top[0] or right_bottom[1] <= left_top[1]:
            # box entirely outside the image: clipping would invert the
            # rectangle and PIL raises — nothing visible to draw
            continue

        text = f" {labelmap.id2name(int(class_id) - 1)} {round(float(score), 3)}"
        text_loc = (max(xmin, 0), max(ymin, 0) - 11)
        text_back_loc = (max(xmin, 0) + len(text) * 6, max(ymin, 0))

        color = tuple(int(c * 255) for c in palette[int(class_id)])
        draw.rectangle(left_top + right_bottom, outline=color)
        draw.rectangle(text_loc + text_back_loc, fill=color, outline=color)
        draw.text(text_loc, text, fill=(0, 0, 0, 0))
    return image


def save_detections(out_dir, index: int, image) -> Path:
    """Save a PIL image as <out_dir>/<index:06>.png."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{index:06}.png"
    image.save(path)
    return path
