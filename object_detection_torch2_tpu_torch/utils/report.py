"""Markdown evaluation report
(counterpart of object_detection_torch2_tpu/utils/report.py:13-68).

The reference's template: date, runtime dump, config table, per-class score
table (reference: src/evaluate.py:12-28, 161-185). The reference printed
`nvidia-smi` into the runtime block; here it holds the torch and CUDA
versions and the card the evaluation ran on, or `cpu`.
"""

from __future__ import annotations

from datetime import date
from pathlib import Path

import torch

OUTPUT_FORMAT = """
# EVALUATION REPORT

## REPORTING DATE
{date}

## RUNTIME
```
{runtime}
```

## CONFIG
{config_table}

## SCORES
{score_table}
"""


def _float2str(val: float) -> str:
    return str(round(val, 3))


def runtime_info(device) -> str:
    """torch and CUDA versions, then the device the evaluation ran on."""
    device = torch.device(device)
    lines = [f"torch {torch.__version__}", f"CUDA {torch.version.cuda}"]
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        lines.append(f"{index}: {torch.cuda.get_device_name(index)} (cuda)")
    else:
        lines.append(device.type)
    return "\n".join(lines)


def write_report(out_dir, args_dict: dict, aps, mean_ap: float, labelmap, *, device) -> Path:
    """aps: iterable of per-class AP (may contain nan); device: where the
    evaluation ran. Returns the report's path."""
    config_table = ["|item|value|", "|-|-|"]
    for k, v in args_dict.items():
        config_table.append(f"|{k}|{v}|")

    score_table = ["|label|average precision|", "|-|-|"]
    for class_id, ap in enumerate(aps):
        score_table.append(f"|{labelmap.id2name(class_id)}|{_float2str(float(ap))}|")
    score_table.append(f"|**mean**|**{_float2str(float(mean_ap))}**|")

    d = date.today().isoformat()
    report = OUTPUT_FORMAT.format(
        date=d,
        runtime=runtime_info(device),
        config_table="\n".join(config_table),
        score_table="\n".join(score_table),
    )
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"report_{d}.md"
    with open(path, "w") as f:
        f.write(report)
    return path
