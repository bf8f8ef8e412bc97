"""The yardstick: operations and bytes of the port's kernels, the chip's
peaks, and the model's parameter count, all from shapes.

A frozen copy of `lb_wavenet_tpu_torch/utils/profiling.py`'s `*_cost`,
`bound_ms` and peaks, kept here so that a change to the program cannot move
the bounds its roofline shares are read against. The parameter count is
worked out from the configuration's shapes (the program's `n_params` builds
the model to count it). Each cost counts every input byte read once and
every output byte written once, and the operations the function needs.
"""
from __future__ import annotations

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak (H100 SXM data sheet)
H100_BYTES_S = 3.35e12    # HBM3 bandwidth (H100 SXM data sheet)


def dilations(arch: dict) -> list:
    return [2 ** i for _ in range(arch["n_blocks"]) for i in range(arch["n_layers_per_block"])]


def receptive_field(arch: dict) -> int:
    return 1 + (arch["input_kernel"] - 1) + sum(dilations(arch))


def hop_size(arch: dict) -> int:
    h = 1
    for f in arch["upsample_factors"]:
        h *= f
    return h


def wbytes(arch: dict) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[arch["compute_dtype"]]


def cond_width(arch: dict) -> int:
    """Cc': the folded conditioning row [mel | speaker] the kernels read."""
    return ((arch["cond_channels"] if arch["n_mels"] > 0 else 0)
            + (arch["speaker_embed_dim"] if arch["n_speakers"] > 0 else 0))


def _dims(arch: dict):
    return (len(dilations(arch)), arch["residual_channels"], arch["gate_channels"],
            arch["skip_channels"], arch["quant_channels"], arch["input_kernel"])


def mega_cost(arch: dict, b: int, t: int, lane_rows: int, wb: int, cc: int = 0):
    """(bytes, flops) of one mega_generate launch of t steps over b lanes:
    weights, biases, the carry read and written once, forced and lane block
    in, classes out; with cc conditioning channels also w_cond, the (t, b,
    cc) cond rows and the cond product of every layer and step."""
    L, C, G, S, Q, K = _dims(arch)
    dsum = sum(dilations(arch))
    w = L * ((2 * C + cc) * 2 * G + G * (C + S)) + S * S + S * Q + Q * C + K * C * C
    bias = L * (2 * G + C + S) + S + Q + C
    carry = (dsum * C + L * 2 * C + C + (K - 1) * C) * b
    nbytes = (w * wb + 4 * (bias + 2 * carry + t * b + lane_rows * b + t * b)
              + t * b * cc * wb)
    return nbytes, mega_flops_per_sample(arch, cc) * b * t


def mega_flops_per_sample(arch: dict, cc: int = 0) -> int:
    """Model operations of one generated sample of one lane (the stack with
    its cond product, the post network, the input conv)."""
    L, C, G, S, Q, K = _dims(arch)
    return 2 * (L * ((2 * C + cc) * 2 * G + G * (C + S)) + S * S + S * Q + K * C * C)


def train_stack_cost(arch: dict, b: int, t: int, wb: int, backward: bool, cc: int = 0):
    """(bytes, flops) of the training stack's forward or backward at (b, t):
    each input read once, each output written once (the layer inputs the
    port's forward also stores are not counted: the function does not need
    them); with cc conditioning channels also cond and w_cond in, and in the
    backward d cond and d w_cond out, with their products."""
    L, C, G, S, _, _ = _dims(arch)
    w = L * ((2 * C + cc) * 2 * G + G * C + G * S)
    bias = L * (2 * G + C + S)
    z_all = L * b * t * G * wb
    cond = b * t * cc * wb
    if backward:
        nbytes = (z_all + 4 * b * t * (2 * C + S) + cond + 4 * b * t * cc + w * wb
                  + 4 * (bias + w + bias))
        macs = L * b * t * (2 * C * 2 * G + G * (S + C) + 2 * (2 * G * C)
                            + 2 * C * 2 * G + G * C + G * S + 3 * cc * 2 * G)
    else:
        nbytes = 4 * b * t * (2 * C + S) + cond + z_all + w * wb + 4 * bias
        macs = L * b * t * (2 * C * 2 * G + G * C + G * S + cc * 2 * G)
    return nbytes, 2 * macs


def post_loss_cost(arch: dict, b: int, t: int, w: int, wb: int, backward: bool):
    """(bytes, flops) of the post-loss forward or backward over the scored
    window (the head rows need no work)."""
    S, Q = arch["skip_channels"], arch["quant_channels"]
    weights = (S * S + S * Q) * wb + 4 * (S + Q)
    rows_in = 4 * b * w * S + 8 * b * w
    if backward:
        return (rows_in + weights + 4 * b * t * S + 4 * (S * S + S * Q + S + Q),
                2 * b * w * 3 * (S * S + S * Q))
    return rows_in + weights + 4, 2 * b * w * (S * S + S * Q)


def frontend_cost(arch: dict, b: int, t: int, backward: bool):
    """(bytes, flops) of the frontend's forward or backward at (b, t)."""
    C, Q, K = arch["residual_channels"], arch["quant_channels"], arch["input_kernel"]
    params = Q * C + K * C * C + C
    taps = 2 * b * t * K * C * C
    if backward:
        return 4 * (b * t + params + b * t * C + params), 2 * taps + b * t * C
    return 4 * (b * t + params + b * t * C), taps


def bound_ms(nbytes: int, flops: int):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over the bf16 peak."""
    by_bytes, by_ops = nbytes / H100_BYTES_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def n_params(arch: dict) -> int:
    """Parameters the train step updates, counted from the shapes (the
    upsampler and the speaker table included)."""
    L, C, G, S, Q, K = _dims(arch)
    n = Q * C + K * C * C + C
    n += L * (2 * C * 2 * G + 2 * G + G * C + C + G * S + S)
    n += S * S + S + S * Q + Q
    if arch["n_mels"] > 0:
        cc = arch["cond_channels"]
        n += L * cc * 2 * G + arch["n_mels"] * cc + cc
        n += sum((2 * f + 1) * cc * cc + cc for f in arch["upsample_factors"])
    if arch["n_speakers"] > 0:
        e = arch["speaker_embed_dim"]
        n += arch["n_speakers"] * e + L * e * 2 * G
    return n


def train_step_costs(arch: dict, batch: int, window: int) -> dict:
    """{kernel: (bytes, flops)} of one training step at (B, T = R - 1 + W)."""
    wb, cc = wbytes(arch), cond_width(arch)
    t = receptive_field(arch) - 1 + window
    return {
        "frontend_fwd": frontend_cost(arch, batch, t, False),
        "frontend_bwd": frontend_cost(arch, batch, t, True),
        "train_stack_fwd": train_stack_cost(arch, batch, t, wb, False, cc),
        "train_stack_bwd": train_stack_cost(arch, batch, t, wb, True, cc),
        "post_loss_fwd": post_loss_cost(arch, batch, t, window, wb, False),
        "post_loss_bwd": post_loss_cost(arch, batch, t, window, wb, True),
    }


def train_step_bound(arch: dict, batch: int, window: int) -> dict:
    """The least time of one training step: the kernels' bounds at the
    data-sheet rates plus Adam's 32 bytes a parameter; its operations."""
    costs = train_step_costs(arch, batch, window)
    opt_bytes = 32 * n_params(arch)
    return {
        "flops": sum(c[1] for c in costs.values()),
        "step_ms": (sum(bound_ms(*c)[0] for c in costs.values())
                    + opt_bytes / H100_BYTES_S * 1e3),
    }
