"""Parameter checkpoints in torch's own format (the JAX package uses orbax).

`save_params(dir, params, step)` writes `dir/params_<step>.pt`;
`restore_params(dir)` loads the highest step. Files hold CPU tensors and
load with `weights_only=True`.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"^params_(\d+)\.pt$")


def save_params(directory: str, params: dict, step: int) -> str:
    """Write the parameter dict at `step`; returns the file path. The file
    is written under a temporary name and renamed, so a reader never sees
    a partial checkpoint."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"params_{int(step)}.pt")
    cpu = _to_cpu(params)
    tmp = path + ".tmp"
    torch.save({"step": int(step), "params": cpu}, tmp)
    os.replace(tmp, path)
    return path


def _to_cpu(tree: dict) -> dict:
    return {
        k: _to_cpu(v) if isinstance(v, dict) else v.detach().to("cpu")
        for k, v in tree.items()
    }


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := _NAME.match(f))]
    return max(steps) if steps else None


def restore_params(directory: str, step: Optional[int] = None) -> dict:
    """Load the parameter dict at `step` (default: the latest)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no params_<step>.pt checkpoint in {directory}")
    path = os.path.join(directory, f"params_{int(step)}.pt")
    return torch.load(path, map_location="cpu", weights_only=True)["params"]
