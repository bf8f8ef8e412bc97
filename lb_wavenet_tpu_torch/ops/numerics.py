"""Dtype and device helpers shared by the model and the kernel wrappers.

They live apart from models/wavenet.py so that the kernels' modules, and a
process that only serves an exported artifact (utils/export.py), import no
model-construction code.
"""
from __future__ import annotations

import torch


def compute_dtype(arch) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        arch.compute_dtype
    ]


def resolve_device(device) -> torch.device:
    """The torch.device to run on; a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch paths on the CPU"
        )
    return dev


def params_to(params, device):
    """The parameter tree (dicts and lists) with every leaf on `device` (no
    copy if there)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def rnd(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Round to the compute dtype, held in float32."""
    return x.to(dt).to(torch.float32)


def shift_right(x: torch.Tensor, d: int) -> torch.Tensor:
    """y[:, t] = x[:, t - d] with zeros for t < d. Shapes (B, T, C)."""
    if d == 0:
        return x
    t = x.shape[1]
    return torch.nn.functional.pad(x, (0, 0, d, 0))[:, :t]
