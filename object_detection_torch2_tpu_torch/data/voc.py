"""PASCAL VOC dataset (copy of object_detection_torch2_tpu/data/voc.py:32-143;
reference: src/dataset.py).

Host-side parsing of `ImageSets/Main/{trainval,test}.txt` + per-image XML
annotations, with the reference's two modes:

- 'classification': one sample per annotated object — crop bbox, resize,
  one-hot(20) label (reference: dataset.py:37-43, 80-86);
- 'detection': whole image resized to imsize x imsize, GT array (G, 4+21)
  where a row is normalized center-form (cx, cy, w, h) + one-hot of 21 classes
  with index 0 = void and object classes shifted +1 (reference:
  dataset.py:45-51, 92-116).

Images are HWC uint8. PIL decodes them, and is imported only where an image
is read: the packed records (data/records.py) need only numpy, so the port
does not depend on PIL for its fast path.
"""

from __future__ import annotations

import warnings
import xml.etree.ElementTree as ET
from enum import Enum
from pathlib import Path

import numpy as np

from object_detection_torch2_tpu_torch.data.labelmap import LabelMap


class Purpose(Enum):
    CLASSIFICATION = "classification"
    DETECTION = "detection"

    @classmethod
    def get_all(cls) -> set:
        return set(c.value for c in cls)


class PascalVOCDataset:
    def __init__(self, purpose: str, data_dirs, data_list_file_name: str, imsize: int, transform=None):
        self.transform = transform
        self.purpose = purpose
        if self.purpose not in Purpose.get_all():
            raise ValueError(f'purpose "{self.purpose}" is invalid')
        self.imsize = imsize
        self.labelmap = LabelMap("PascalVOC")
        self.num_classes = len(self.labelmap)
        self.data_list = self._get_list(data_dirs, data_list_file_name)

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, i):
        from PIL import Image

        if self.purpose == Purpose.CLASSIFICATION.value:
            class_id, coord, image_path = self.data_list[i]
            image = Image.open(image_path).convert("RGB").crop(coord).resize((self.imsize, self.imsize))
            image = np.asarray(image, np.uint8)
            gt = np.eye(self.num_classes, dtype=np.float32)[class_id]
        else:
            image_path, anno_path = self.data_list[i]
            image = Image.open(image_path).convert("RGB").resize((self.imsize, self.imsize))
            image = np.asarray(image, np.uint8)
            gt = self._get_gt(anno_path)
        if self.transform:
            image, gt = self.transform(image, gt)
        return image, gt

    def _get_list(self, data_dirs, data_list_file_name: str) -> list:
        if isinstance(data_dirs, (str, Path)):
            data_dirs = [data_dirs]
        data_list = []
        for data_dir in data_dirs:
            data_dir = Path(data_dir)
            with open(data_dir / "ImageSets" / "Main" / data_list_file_name, "r") as f:
                ids = f.read().split("\n")
            for i in ids[:-1]:  # trailing newline convention (reference: dataset.py:77)
                image_path = data_dir / "JPEGImages" / f"{i}.jpg"
                anno_path = data_dir / "Annotations" / f"{i}.xml"
                if self.purpose == Purpose.CLASSIFICATION.value:
                    root = ET.parse(anno_path).getroot()
                    for obj in root.iter("object"):
                        class_id = self.labelmap.name2id(obj.find("name").text)
                        bb = obj.find("bndbox")
                        coord = tuple(int(bb.find(k).text) for k in ("xmin", "ymin", "xmax", "ymax"))
                        data_list.append([class_id, coord, image_path])
                else:
                    data_list.append([image_path, anno_path])
        return data_list

    def _get_gt(self, anno_path: Path) -> np.ndarray:
        """(G, 4 + 21): normalized center-form box + one-hot(21) with void at 0."""
        num_classes = self.num_classes + 1
        root = ET.parse(anno_path).getroot()
        width = height = 1
        for size in root.iter("size"):
            width = int(size.find("width").text)
            height = int(size.find("height").text)
        rows = []
        for obj in root.iter("object"):
            bb = obj.find("bndbox")
            xmin, ymin, xmax, ymax = (int(bb.find(k).text) for k in ("xmin", "ymin", "xmax", "ymax"))
            coord = [
                (xmin + xmax) / 2 / width,
                (ymin + ymax) / 2 / height,
                (xmax - xmin) / width,
                (ymax - ymin) / height,
            ]
            class_id = self.labelmap.name2id(obj.find("name").text)
            onehot = np.eye(num_classes, dtype=np.float32)[class_id + 1]
            rows.append(np.concatenate([np.asarray(coord, np.float32), onehot]))
        if not rows:
            return np.zeros((0, 4 + num_classes), np.float32)
        return np.stack(rows)


def collate(batch, max_gt: int | None = None):
    """Stack images; zero-pad variable-G ground truth (reference: src/utils.py:8-16).

    Unlike torch's pad_sequence (pads to the batch max), `max_gt` pads to a
    STATIC bound, so every batch has one shape; padded all-zero rows are inert
    in the loss (zero area — reference: ssd.py:250) and in eval.
    """
    images = np.stack([b[0] for b in batch])
    gts = [np.asarray(b[1], np.float32) for b in batch]
    if gts and gts[0].ndim == 1:  # classification one-hot GT: plain stack
        return images, np.stack(gts)
    g_max = max_gt if max_gt is not None else max((g.shape[0] for g in gts), default=0)
    width = gts[0].shape[-1] if gts else 0
    out = np.zeros((len(batch), g_max, width), np.float32)
    for i, g in enumerate(gts):
        n = min(g.shape[0], g_max)
        if g.shape[0] > g_max:
            # the reference NEVER drops GT (pad_sequence to the batch max —
            # src/utils.py:8-16); a static bound must not lose boxes silently
            warnings.warn(
                f"collate: image has {g.shape[0]} GT boxes, truncating to max_gt={g_max}; "
                "raise --max_gt to keep them all",
                stacklevel=2,
            )
        out[i, :n] = g[:n]
    return images, out
