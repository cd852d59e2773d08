"""Synthetic VOC-format shape dataset generator for the accuracy proofs
(the port's own copy of the repo's root tools/synth_voc.py: numpy and PIL
only, PIL imported where an image is drawn).

A VOC-layout tree (JPEGImages/, Annotations/, ImageSets/Main/{trainval,test}.txt)
of procedurally drawn scenes: colored shapes on a textured background, each
shape type + color mapped to a fixed VOC class name. Train and test splits
are disjoint draws from one distribution, so an evaluation on the test split
measures generalization, not memorization. For the same arguments
`generate` writes the same files, byte for byte, as tools/synth_voc.py, so
the port's proofs train and evaluate on the JAX proofs' images.

    python -m object_detection_torch2_tpu_torch.tools.synth_voc --out /tmp/synthvoc --n_train 200 --n_test 48
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

# shape archetype -> (VOC class name, RGB). Distinct hue + geometry per class.
CLASSES = [
    ("aeroplane", "rect", (220, 40, 40)),
    ("bicycle", "ellipse", (40, 200, 60)),
    ("bird", "triangle", (50, 80, 230)),
    ("boat", "cross", (230, 200, 40)),
    ("bottle", "ring", (200, 60, 220)),
    ("bus", "diamond", (40, 210, 210)),
]
# full 20-class vocabulary (--n_classes 20, the VOC-scale dress rehearsal):
# 10 geometries x 2 color families. Identity is carried primarily by GEOMETRY
# (hue jitter tolerant); the warm/cool split is far enough apart to survive
# the reduced_hue augmentation (±0.05).
_WARM, _COOL = (225, 70, 45), (45, 90, 225)
_GEOMETRIES = ["rect", "ellipse", "triangle", "vee", "cross",
               "ring", "diamond", "star", "bars", "checker"]
CLASSES_20 = [
    (name, _GEOMETRIES[i % 10], _WARM if i < 10 else _COOL)
    for i, name in enumerate([
        "aeroplane", "bicycle", "bird", "boat", "bottle",
        "bus", "car", "cat", "chair", "cow",
        "diningtable", "dog", "horse", "motorbike", "person",
        "pottedplant", "sheep", "sofa", "train", "tvmonitor",
    ])
]
IMSIZE = 300


def _draw_shape(draw, kind: str, box, color):
    """Draw one shape archetype into `draw` (a PIL ImageDraw) over `box`."""
    x1, y1, x2, y2 = box
    if kind == "rect":
        draw.rectangle(box, fill=color)
    elif kind == "ellipse":
        draw.ellipse(box, fill=color)
    elif kind == "triangle":
        draw.polygon([((x1 + x2) // 2, y1), (x1, y2), (x2, y2)], fill=color)
    elif kind == "cross":
        w3, h3 = (x2 - x1) // 3, (y2 - y1) // 3
        draw.rectangle((x1 + w3, y1, x2 - w3, y2), fill=color)
        draw.rectangle((x1, y1 + h3, x2, y2 - h3), fill=color)
    elif kind == "diamond":
        cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
        draw.polygon([(cx, y1), (x2, cy), (cx, y2), (x1, cy)], fill=color)
    elif kind == "ring":
        draw.ellipse(box, fill=color)
        rx, ry = (x2 - x1) // 4, (y2 - y1) // 4
        draw.ellipse((x1 + rx, y1 + ry, x2 - rx, y2 - ry), fill=(128, 128, 128))
    elif kind == "vee":  # inverted triangle
        draw.polygon([(x1, y1), (x2, y1), ((x1 + x2) // 2, y2)], fill=color)
    elif kind == "star":  # 4-point star (two overlapping slim diamonds)
        cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
        qw, qh = max(1, (x2 - x1) // 6), max(1, (y2 - y1) // 6)
        draw.polygon([(cx, y1), (cx + qw, cy), (cx, y2), (cx - qw, cy)], fill=color)
        draw.polygon([(x1, cy), (cx, cy - qh), (x2, cy), (cx, cy + qh)], fill=color)
    elif kind == "bars":  # three vertical stripes
        w5 = max(1, (x2 - x1) // 5)
        for k in range(3):
            bx = x1 + 2 * k * w5
            draw.rectangle((bx, y1, min(bx + w5, x2), y2), fill=color)
    elif kind == "checker":  # 2x2 alternating blocks
        mx, my = (x1 + x2) // 2, (y1 + y2) // 2
        draw.rectangle((x1, y1, mx, my), fill=color)
        draw.rectangle((mx, my, x2, y2), fill=color)


def _n_objects(rng: np.random.Generator, count_dist: str) -> int:
    if count_dist == "uniform3":  # original behavior (generalization proofs)
        return int(rng.integers(1, 4))
    # "voc": truncated geometric, p=0.42 -> mean ~2.3 objects/image, tail to
    # 10 — matches VOC07+12 trainval's ~2.4 objects/image with its long tail
    return min(int(rng.geometric(0.42)), 10)


def _make_scene(rng: np.random.Generator, classes=CLASSES, count_dist: str = "uniform3"):
    """-> (PIL image, [(class_name, (xmin,ymin,xmax,ymax)), ...])"""
    from PIL import Image, ImageDraw

    base = rng.integers(90, 170, 3)
    noise = rng.normal(0, 18, (IMSIZE, IMSIZE, 3)) + base
    img = Image.fromarray(np.clip(noise, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    objects = []
    for _ in range(_n_objects(rng, count_dist)):
        name, kind, color = classes[int(rng.integers(0, len(classes)))]
        if count_dist == "voc":
            # log-uniform 36..220 px with mild aspect jitter: a VOC-like size
            # spread (small objects matter for the low-level anchor rows)
            s = float(np.exp(rng.uniform(np.log(36), np.log(220))))
            a = float(np.exp(rng.uniform(np.log(0.6), np.log(1.67))))
            w = int(np.clip(s * np.sqrt(a), 20, IMSIZE - 2))
            h = int(np.clip(s / np.sqrt(a), 20, IMSIZE - 2))
        else:
            w = int(rng.integers(60, 150))
            h = int(rng.integers(60, 150))
        x1 = int(rng.integers(0, IMSIZE - w))
        y1 = int(rng.integers(0, IMSIZE - h))
        jitter = tuple(int(np.clip(c + rng.integers(-25, 26), 0, 255)) for c in color)
        _draw_shape(draw, kind, (x1, y1, x1 + w, y1 + h), jitter)
        objects.append((name, (x1, y1, x1 + w, y1 + h)))
    return img, objects


def _write_xml(path: Path, filename: str, objects):
    parts = [
        "<annotation>",
        f"    <filename>{filename}</filename>",
        f"    <size><width>{IMSIZE}</width><height>{IMSIZE}</height><depth>3</depth></size>",
    ]
    for name, (x1, y1, x2, y2) in objects:
        parts += [
            "    <object>",
            f"        <name>{name}</name>",
            f"        <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>",
            "    </object>",
        ]
    parts.append("</annotation>")
    path.write_text("\n".join(parts) + "\n")


def generate(out: Path, n_train: int, n_test: int, seed: int = 0,
             n_classes: int = 6, count_dist: str = "uniform3", log_every: int = 0):
    """n_classes 6 (default, the original generalization-proof vocabulary) or
    20 (full VOC vocabulary, the reference-scale dress rehearsal —
    the root tools/voc_scale_proof.py). count_dist 'uniform3' = 1-3 objects uniform
    (original); 'voc' = truncated geometric, VOC-like mean ~2.4 and size tail."""
    if n_classes not in (6, 20):
        raise ValueError("n_classes must be 6 or 20")
    classes = CLASSES if n_classes == 6 else CLASSES_20
    rng = np.random.default_rng(seed)
    (out / "JPEGImages").mkdir(parents=True, exist_ok=True)
    (out / "Annotations").mkdir(exist_ok=True)
    (out / "ImageSets" / "Main").mkdir(parents=True, exist_ok=True)

    splits = {"trainval": n_train, "test": n_test}
    counter = 1
    for split, n in splits.items():
        ids = []
        for _ in range(n):
            iid = f"{counter:06d}"
            counter += 1
            img, objects = _make_scene(rng, classes, count_dist)
            img.save(out / "JPEGImages" / f"{iid}.jpg", quality=92)
            _write_xml(out / "Annotations" / f"{iid}.xml", f"{iid}.jpg", objects)
            ids.append(iid)
            if log_every and counter % log_every == 0:
                print(f"synth_voc: {counter - 1} images written", flush=True)
        # trailing newline convention (reference: dataset.py:77)
        (out / "ImageSets" / "Main" / f"{split}.txt").write_text("\n".join(ids) + "\n")
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--n_train", type=int, default=200)
    parser.add_argument("--n_test", type=int, default=48)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n_classes", type=int, default=6, choices=[6, 20])
    parser.add_argument("--count_dist", type=str, default="uniform3", choices=["uniform3", "voc"])
    args = parser.parse_args()
    out = generate(Path(args.out), args.n_train, args.n_test, args.seed,
                   n_classes=args.n_classes, count_dist=args.count_dist)
    print(f"wrote synthetic VOC tree to {out} ({args.n_train} train / {args.n_test} test)")


if __name__ == "__main__":
    main()
