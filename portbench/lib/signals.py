"""Inputs made from the seed: weights, synthetic audio, and the traffic's
request lengths.

Every seed gets the same multiset of request lengths (stratified quantiles
of the mix's distribution), in an order the seed draws, so that two seeds
ask the same amount of work of the program.
Weights are drawn on the run's device by a torch.Generator in one call.
"""
from __future__ import annotations

import math

import numpy as np

from . import costs


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The numpy generator of one named stream of `seed` (any whole number)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), *stream]))


def torch_generator(seed: int, stream: int, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (1 << 63))
    return g


def log_uniform_lengths(n: int, lo: float, hi: float, order: np.random.Generator) -> np.ndarray:
    """n lengths at the stratified quantiles (i + 0.5) / n of the
    log-uniform law on [lo, hi], in an order drawn by `order`."""
    q = (np.arange(n) + 0.5) / n
    return order.permutation(np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo))))


def make_params(arch: dict, seed: int, device) -> dict:
    """Random weights in the port's layout, float32 (the type the port
    keeps them in), drawn on `device` in one normal draw: each weight is
    LeCun-normal (1 / sqrt(fan in)), each bias 0.1 of a standard normal."""
    import torch

    L, C, G = len(costs.dilations(arch)), arch["residual_channels"], arch["gate_channels"]
    S, Q, K = arch["skip_channels"], arch["quant_channels"], arch["input_kernel"]
    flat = torch.randn(costs.n_params(arch), generator=torch_generator(seed, 1, device),
                       device=device)
    off = 0

    def take(*shape, fan=0):
        nonlocal off
        n = math.prod(shape)
        leaf = flat[off: off + n].reshape(shape) * (fan ** -0.5 if fan else 0.1)
        off += n
        return leaf.contiguous()

    params = {
        "embed": take(Q, C, fan=C),
        "input_conv": {"w": take(K, C, C, fan=C), "b": take(C)},
        "layers": {"w_prev": take(L, C, 2 * G, fan=C), "w_cur": take(L, C, 2 * G, fan=C),
                   "b": take(L, 2 * G), "w_res": take(L, G, C, fan=G), "b_res": take(L, C),
                   "w_skip": take(L, G, S, fan=G), "b_skip": take(L, S)},
        "post": {"w1": take(S, S, fan=S), "b1": take(S), "w2": take(S, Q, fan=S),
                 "b2": take(Q)},
    }
    if arch["n_mels"] > 0:
        cc, m = arch["cond_channels"], arch["n_mels"]
        params["layers"]["w_cond"] = take(L, cc, 2 * G, fan=cc)
        params["upsampler"] = {
            "proj_w": take(m, cc, fan=m), "proj_b": take(cc),
            "stages": [{"w": take(2 * f + 1, cc, cc, fan=(2 * f + 1) * cc), "b": take(cc)}
                       for f in arch["upsample_factors"]]}
    if arch["n_speakers"] > 0:
        e = arch["speaker_embed_dim"]
        params["speaker_embed"] = take(arch["n_speakers"], e, fan=1)
        params["layers"]["w_gcond"] = take(L, e, 2 * G, fan=e)
    if off != flat.numel():
        raise ValueError(f"drew {flat.numel()} values for {off} parameters")
    return params


def chords(f0, n: int, sample_rate: int, device, noise=None):
    """(len(f0), n) synthetic waveforms, the chord recipe of chip_smoke.py's
    mel requests: 0.4 sin(2 pi f0 t) + 0.2 sin(2 pi 2.5 f0 t), plus
    `noise` (an (len(f0), n) tensor) where given."""
    import torch

    f0 = torch.as_tensor(np.asarray(f0, np.float32), device=device)
    t = torch.arange(n, device=device, dtype=torch.float32) / sample_rate
    wav = (0.4 * torch.sin(2 * math.pi * f0[:, None] * t)
           + 0.2 * torch.sin(2 * math.pi * 2.5 * f0[:, None] * t))
    if noise is not None:
        wav = wav + noise
    return torch.clamp(wav, -1.0, 1.0)
