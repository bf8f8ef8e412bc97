"""The plain reference of the WaveNet vocoder, in plain PyTorch.

It imports nothing of the program. It follows the architecture as the
configuration states it: a width-K causal input conv over the class
embedding; L gated residual layers (tap at t - d and at t, optional
conditioning product, tanh * sigmoid, residual and skip projections);
relu, a dense layer, relu, the output layer; mel conditioning from a
learned upsampler (a projection over mel bins, then per factor f a
nearest-neighbour repeat, a SAME convolution of 2f + 1 taps and a leaky
relu of slope 0.4), run in float32.

Every product rounds its two operands to the configuration's compute
precision and sums in float32 with TF32 off (`set_precision`); the backward
rounds the cotangent of each rounded operand to the same precision, as a
cast does under autograd. `prec` names that precision: "float32",
"bfloat16", or "fp8" (float8 e4m3, saturating at 448: the control, one
step below bfloat16, whose cotangents stay in bfloat16).
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def set_precision() -> None:
    """Float32 products in full float32 (no TF32), in cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "float32":
        return x
    if prec == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    if prec == "fp8":
        return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(torch.float32)
    raise ValueError(f"unknown precision {prec!r}")


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, prec):
        ctx.prec = prec
        return _round(x, prec)

    @staticmethod
    def backward(ctx, g):
        return _round(g, "bfloat16" if ctx.prec == "fp8" else ctx.prec), None


def rnd(x: torch.Tensor, prec: str) -> torch.Tensor:
    return _Round.apply(x, prec) if torch.is_grad_enabled() else _round(x, prec)


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """(..., K) @ (K, N): operands rounded to `prec`, float32 sums."""
    return rnd(x, prec) @ rnd(w, prec)


def shift(x: torch.Tensor, d: int) -> torch.Tensor:
    """y[:, t] = x[:, t - d], zeros before the start. (B, T, C)."""
    if d == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0, d, 0))[:, : x.shape[1]]


def dilations(arch: dict) -> list:
    return [2 ** i for _ in range(arch["n_blocks"]) for i in range(arch["n_layers_per_block"])]


def receptive_field(arch: dict) -> int:
    return 1 + (arch["input_kernel"] - 1) + sum(dilations(arch))


def upsample(up: dict, arch: dict, frames: torch.Tensor) -> torch.Tensor:
    """(B, F, n_mels) frames -> (B, F * hop, Cc) conditioning, float32."""
    h = frames.to(torch.float32) @ up["proj_w"] + up["proj_b"]
    for f, stage in zip(arch["upsample_factors"], up["stages"]):
        h = torch.repeat_interleave(h, f, dim=1)
        t = h.shape[1]
        hp = torch.nn.functional.pad(h, (0, 0, f, f))
        out = stage["b"]
        for k in range(2 * f + 1):
            out = out + hp[:, k: k + t] @ stage["w"][k]
        h = torch.nn.functional.leaky_relu(out, 0.4)
    return h


def skip_sum(params: dict, arch: dict, x: torch.Tensor, prec: str, cond=None) -> torch.Tensor:
    """Classes x (B, T) (x[:, t] the input of step t) -> the skip sum (B, T, S)."""
    w_in = params["input_conv"]["w"]
    k_taps = w_in.shape[0]
    e = params["embed"][x.long()]
    h = params["input_conv"]["b"]
    for k in range(k_taps):
        h = h + mm(shift(e, k_taps - 1 - k), w_in[k], prec)
    lp = params["layers"]
    g = lp["w_cur"].shape[-1] // 2
    total = lp["b_skip"].sum(0)
    for i, d in enumerate(dilations(arch)):
        pre = mm(h, lp["w_cur"][i], prec) + mm(shift(h, d), lp["w_prev"][i], prec) + lp["b"][i]
        if cond is not None:
            pre = pre + mm(cond, lp["w_cond"][i], prec)
        z = torch.tanh(pre[..., :g]) * torch.sigmoid(pre[..., g:])
        total = total + mm(z, lp["w_skip"][i], prec)
        h = h + mm(z, lp["w_res"][i], prec) + lp["b_res"][i]
    return total


def post(params: dict, skip: torch.Tensor, prec: str) -> torch.Tensor:
    p = params["post"]
    hid = torch.relu(mm(torch.relu(skip), p["w1"], prec) + p["b1"])
    return mm(hid, p["w2"], prec) + p["b2"]


def logits(params: dict, arch: dict, x: torch.Tensor, prec: str, cond=None) -> torch.Tensor:
    """(B, T, Q) logits; logits[:, t] scores the class of step t."""
    return post(params, skip_sum(params, arch, x, prec, cond), prec)


def masked_loss(params: dict, arch: dict, batch: dict, window: int, prec: str) -> torch.Tensor:
    """Mean cross entropy over the last `window` positions where mask is 1
    (mask sum clamped at 1), with the batch's mel frames upsampled."""
    cond = None
    if batch.get("mel") is not None:
        cond = upsample(params["upsampler"], arch, batch["mel"])[:, : batch["inputs"].shape[1]]
    lg = logits(params, arch, batch["inputs"], prec, cond)[:, -window:]
    ce = -torch.log_softmax(lg, -1).gather(-1, batch["targets"].long()[..., None])[..., 0]
    return (ce * batch["mask"]).sum() / torch.clamp(batch["mask"].sum(), min=1.0)
