"""Weights of the mol configuration (Tacotron 2's WaveNet vocoder) made from
the seed, in the program's layout: `signals.make_params`' recipe (one
normal draw on the run's device; each weight LeCun-normal, 1 / sqrt(fan
in), each bias 0.1 of a standard normal) over the mol model's leaves: the
scalar input conv (K, 1, C), the stack, the head (S, 3 n_mix), and the
upsampler and w_cond of a mel arch.
"""
from __future__ import annotations

import math

from . import costs, mol_costs
from .signals import torch_generator


def make_params(arch: dict, seed: int, device) -> dict:
    import torch

    L, C, G = len(costs.dilations(arch)), arch["residual_channels"], arch["gate_channels"]
    S, K, n3 = arch["skip_channels"], arch["input_kernel"], 3 * mol_costs.n_mix(arch)
    flat = torch.randn(mol_costs.n_params(arch), generator=torch_generator(seed, 1, device),
                       device=device)
    off = 0

    def take(*shape, fan=0):
        nonlocal off
        n = math.prod(shape)
        leaf = flat[off: off + n].reshape(shape) * (fan ** -0.5 if fan else 0.1)
        off += n
        return leaf.contiguous()

    params = {
        "input_conv": {"w": take(K, 1, C, fan=1), "b": take(C)},
        "layers": {"w_prev": take(L, C, 2 * G, fan=C), "w_cur": take(L, C, 2 * G, fan=C),
                   "b": take(L, 2 * G), "w_res": take(L, G, C, fan=G), "b_res": take(L, C),
                   "w_skip": take(L, G, S, fan=G), "b_skip": take(L, S)},
        "mol": {"w": take(S, n3, fan=S), "b": take(n3)},
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
