"""The yardstick of the mol cell (Tacotron 2's WaveNet vocoder): the MoL head
pair's operations and bytes, the mol training step's operations, and the
mol model's parameter count, all from shapes.

Frozen copies, as `costs.py` keeps the others: `mol_post_cost` is
`lb_wavenet_tpu_torch/utils/profiling.py`'s, so a change to the program
cannot move the bound its roofline share is read against. Each cost
counts every input byte read once and every output byte written once.
"""
from __future__ import annotations

from . import costs


def n_mix(arch: dict) -> int:
    return int(arch["n_mix"])


def mol_post_cost(arch: dict, b: int, t: int, w: int, backward: bool):
    """(bytes, flops) of the MoL head pair's forward or backward over the
    scored window: the skip rows (fp32), target samples and mask, the
    head's fp32 weight and bias in; the numerator out, or dskip (every row)
    and the head's gradients out. Operations: the head's products, y =
    relu(skip) w; backward its recompute, da = dy w^T and dw."""
    s, n3 = arch["skip_channels"], 3 * n_mix(arch)
    head = 4 * (s * n3 + n3)
    rows_in = 4 * b * w * s + 8 * b * w
    flops = 2 * b * w * s * n3
    if backward:
        return rows_in + head + 4 + 4 * b * t * s + head, 3 * flops
    return rows_in + head + 4, flops


def mol_post_bound_ms(arch: dict, b: int, w: int) -> float:
    """The pair's least time a training step (one forward and one backward
    call) at (B, W), T = R - 1 + W."""
    t = costs.receptive_field(arch) - 1 + w
    return sum(costs.bound_ms(*mol_post_cost(arch, b, t, w, bwd))[0] for bwd in (False, True))


def scalar_frontend_flops(arch: dict, b: int, t: int) -> int:
    """Operations of the scalar frontend's forward and backward: K taps from
    one channel to C a position, twice over in the backward."""
    return 3 * 2 * b * t * arch["input_kernel"] * arch["residual_channels"]


def mol_step_flops(arch: dict, b: int, w: int) -> int:
    """Operations of one mol training step at (B, W): the scalar frontend,
    the training stack (its conditioning product included) and the head,
    forward and backward; the upsampler left out, as `mfu.train` leaves
    it out."""
    t = costs.receptive_field(arch) - 1 + w
    wb, cc = costs.wbytes(arch), costs.cond_width(arch)
    stack = sum(costs.train_stack_cost(arch, b, t, wb, bwd, cc)[1] for bwd in (False, True))
    head = sum(mol_post_cost(arch, b, t, w, bwd)[1] for bwd in (False, True))
    return scalar_frontend_flops(arch, b, t) + stack + head


def n_params(arch: dict) -> int:
    """Parameters of the mol model the train step updates: the scalar input
    conv, the stack, the head, and the upsampler (mel) and speaker table."""
    L = len(costs.dilations(arch))
    C, G, S, K = (arch["residual_channels"], arch["gate_channels"], arch["skip_channels"],
                  arch["input_kernel"])
    n = K * C + C
    n += L * (2 * C * 2 * G + 2 * G + G * C + C + G * S + S)
    n += S * 3 * n_mix(arch) + 3 * n_mix(arch)
    if arch["n_mels"] > 0:
        cc = arch["cond_channels"]
        n += L * cc * 2 * G + arch["n_mels"] * cc + cc
        n += sum((2 * f + 1) * cc * cc + cc for f in arch["upsample_factors"])
    if arch["n_speakers"] > 0:
        e = arch["speaker_embed_dim"]
        n += arch["n_speakers"] * e + L * e * 2 * G
    return n
