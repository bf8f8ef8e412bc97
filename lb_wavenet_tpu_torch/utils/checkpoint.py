"""Checkpoints in torch's own format (the JAX package uses orbax).

`save_params(dir, params, step)` writes `dir/params_<step>.pt`;
`restore_params(dir)` loads the params of the highest step. The training
manager (`make_manager`, `save`, `restore_if_available`) writes the same
files with the rest of the train state beside the params (Adam moments and
count, the step, the EMA copy), keeps the newest `max_to_keep`, and
resumes exactly; `restore_params` reads the params of a training
checkpoint too, so `cli generate`/`serve` run from a training directory.
Files hold CPU tensors and load with `weights_only=True`; a file is
written under a temporary name and renamed, so a reader never sees a
partial checkpoint.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"^params_(\d+)\.pt$")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    return tree


def _write(directory: str, step: int, payload: dict) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"params_{int(step)}.pt")
    tmp = path + ".tmp"
    torch.save(_to(payload, "cpu"), tmp)
    os.replace(tmp, path)
    return path


def save_params(directory: str, params: dict, step: int) -> str:
    """Write the parameter dict at `step`; returns the file path."""
    return _write(directory, step, {"step": int(step), "params": params})


def steps(directory: str) -> list:
    """The checkpointed steps in `directory`, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory) if (m := _NAME.match(f)))


def latest_step(directory: str) -> Optional[int]:
    s = steps(directory)
    return s[-1] if s else None


def _load(directory: str, step: Optional[int]) -> dict:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no params_<step>.pt checkpoint in {directory}")
    path = os.path.join(directory, f"params_{int(step)}.pt")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_params(directory: str, step: Optional[int] = None) -> dict:
    """Load the parameter dict at `step` (default: the latest)."""
    return _load(directory, step)["params"]


class CheckpointManager:
    """Train-state checkpoints of one directory, the newest `max_to_keep`
    kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def save(self, state, step: int) -> str:
        path = _write(self.directory, step, {
            "step": int(step), "params": state.params, "opt_state": state.opt_state,
            "ema": state.ema,
        })
        for old in steps(self.directory)[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory, f"params_{old}.pt"))
        return path

    def restore(self, step: Optional[int] = None) -> dict:
        return _load(self.directory, step)


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, max_to_keep)


def save(manager: CheckpointManager, state, step: int) -> None:
    manager.save(state, step)


def restore_if_available(manager: CheckpointManager, state):
    """(state, start_step): the latest checkpoint onto the device of
    `state`'s params (a NamedTuple with params, opt_state, step, ema), or
    `state` and 0 when the directory holds none."""
    if manager.latest_step() is None:
        return state, 0
    ck = manager.restore()
    if "opt_state" not in ck:
        raise ValueError(f"{manager.directory}: the latest checkpoint holds params "
                         "only (save_params), not a train state")
    device = next(iter(_leaves(state.params))).device
    restored = state._replace(
        params=_to(ck["params"], device), opt_state=_to(ck["opt_state"], device),
        step=int(ck["step"]), ema=_to(ck["ema"], device),
    )
    return restored, int(ck["step"])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
