"""Mu-law companding codec (port of `lb_wavenet_tpu/ops/mulaw.py`).

    f(x)    = sign(x) * ln(1 + mu*|x|) / ln(1 + mu)     (encode, to [-1, 1])
    f^-1(y) = sign(y) * ((1 + mu)^|y| - 1) / mu         (decode)

with mu = Q - 1 and the mid-rise quantizer floor((f(x) + 1) / 2 * mu + 0.5).
Encode is float32 op for op as the JAX version; decode takes the power in
float64 and rounds it to float32 (torch's float32 pow is an ulp off XLA's on
some classes). Both are bit-identical to the JAX codec on the same inputs.
"""
from __future__ import annotations

import math

import torch


def mu_law_encode(x: torch.Tensor, quant_channels: int = 256) -> torch.Tensor:
    """Float waveform in [-1, 1] -> int32 classes in [0, quant_channels)."""
    mu = quant_channels - 1
    x = torch.clamp(x.to(torch.float32), -1.0, 1.0)
    # log1p(float(mu)) is a weak-typed constant in JAX: the f32 of the double.
    denom = torch.tensor(math.log1p(float(mu)), dtype=torch.float32)
    companded = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / denom
    return torch.clamp(
        torch.floor((companded + 1.0) / 2.0 * mu + 0.5), 0, mu
    ).to(torch.int32)


def mu_law_decode(y: torch.Tensor, quant_channels: int = 256) -> torch.Tensor:
    """Integer classes in [0, quant_channels) -> float32 waveform in [-1, 1]."""
    mu = quant_channels - 1
    companded = 2.0 * y.to(torch.float32) / mu - 1.0
    power = torch.pow(float(1 + mu), torch.abs(companded).double()).float()
    return torch.sign(companded) * (power - 1.0) / mu
