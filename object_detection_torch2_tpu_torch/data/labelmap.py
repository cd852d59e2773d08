"""Label vocabulary (reference: src/utils.py:119-137, src/labelmap.json).

Copy of object_detection_torch2_tpu/data/labelmap.py. `labelmap.json` keys
datasets to ordered class-name lists; ids are list positions, and the detection
pipeline shifts ids by +1 so one-hot index 0 is the void/background class.
"""

from __future__ import annotations

import json
from pathlib import Path


class LabelMap:
    def __init__(self, ds_name: str, labelmap_path: Path | None = None):
        self.ds_name = ds_name
        path = Path(labelmap_path) if labelmap_path else Path(__file__).parent.parent / "labelmap.json"
        with open(path, "r") as f:
            self.labels = json.load(f)[ds_name]

    def __len__(self) -> int:
        return len(self.labels)

    def name2id(self, name: str) -> int:
        return self.labels.index(name)

    def id2name(self, id: int) -> str:
        return self.labels[id]
