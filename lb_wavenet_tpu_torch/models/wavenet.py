"""WaveNet parameters and the teacher-forced forward pass (port of
`lb_wavenet_tpu/models/wavenet.py`).

The parameter layout is the JAX package's: a plain dict with per-layer
weights STACKED along a leading layer axis, so the training forward, the
ring-buffer samplers and the CUDA kernels consume the identical tensors and
`utils/convert.py` moves a JAX tree across leaf by leaf.

Matmuls follow the JAX `_mm` contract: operands rounded to the compute
dtype, products accumulated in float32. On the CPU `a.bfloat16() @
b.bfloat16()` would return a bf16 result, so the rounding is done by
`.to(dt).float()` on both operands (a product of two bf16 values is exact in
float32) and the product runs in float32.

Conditioning, as in the JAX package: local (mel) conditioning adds
cond @ w_cond[l] to every layer's gate pre-activation, after the bias, with
cond the upsampled frame features (`models/conditioning.py`); global
(speaker) conditioning adds speaker_embed[id] @ w_gcond[l] after that.

The forward is differentiable with autograd; `masked_loss_sums` /
`masked_loss` are the training loss. The embedding's gradient is the
gather's own backward (an index add), the same gradient as the JAX
package's `mm_embed_grad` (a matmul formulation written for the TPU), so
that training option is accepted and changes nothing here.

The sequence-parallel input mask (`input_mask` (B, T), 0/1,
parallel/halo.py) makes masked positions contribute exactly as the zero
padding before the sequence: the frontend zeroes the masked embedding rows
and then its masked output rows (after the bias, which would otherwise
leak), and `forward` re-masks the residual stream after every layer. The
mask is structural and gets no gradient (JAX's stop_gradient): it is
detached here.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..config import ArchConfig
from ..ops.numerics import compute_dtype, params_to, rnd, shift_right  # noqa: F401

Params = dict


def _generator(rng: Union[int, torch.Generator]) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))


def _dense_init(gen: torch.Generator, shape, device) -> torch.Tensor:
    """LeCun-normal (std = 1/sqrt(fan_in)), the classic conv/dense init."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.randn(shape, generator=gen, dtype=torch.float32)
    return (w / float(fan_in) ** 0.5).to(device)


def init_params(
    rng: Union[int, torch.Generator], arch: ArchConfig, device="cpu"
) -> Params:
    """Random parameters in the JAX package's layout (its own RNG stream:
    tests convert JAX parameters instead of relying on equal draws), the
    conditioning leaves in the JAX order after the others."""
    gen = _generator(rng)
    L = len(arch.dilations)
    C = arch.residual_channels
    G = arch.gate_channels
    S = arch.skip_channels
    Q = arch.quant_channels
    K = arch.input_kernel

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    params = {
        "embed": _dense_init(gen, (Q, C), device),
        "input_conv": {
            "w": _dense_init(gen, (K, C, C), device),  # taps t-(K-1) .. t
            "b": zeros(C),
        },
        "layers": {
            "w_prev": _dense_init(gen, (L, C, 2 * G), device),  # tap at t - d
            "w_cur": _dense_init(gen, (L, C, 2 * G), device),   # tap at t
            "b": zeros(L, 2 * G),
            "w_res": _dense_init(gen, (L, G, C), device),
            "b_res": zeros(L, C),
            "w_skip": _dense_init(gen, (L, G, S), device),
            "b_skip": zeros(L, S),
        },
        "post": {
            "w1": _dense_init(gen, (S, S), device),
            "b1": zeros(S),
            "w2": _dense_init(gen, (S, Q), device),
            "b2": zeros(Q),
        },
    }
    if arch.use_local_cond:
        from .conditioning import init_upsampler_params

        params["layers"]["w_cond"] = _dense_init(gen, (L, arch.cond_channels, 2 * G), device)
        params["upsampler"] = init_upsampler_params(gen, arch, device)
    if arch.use_global_cond:
        params["speaker_embed"] = _dense_init(
            gen, (arch.n_speakers, arch.speaker_embed_dim), device)
        params["layers"]["w_gcond"] = _dense_init(
            gen, (L, arch.speaker_embed_dim, 2 * G), device)
    return params


def _mm(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(..., C) @ (C, D): operands in compute dtype, float32 accumulation."""
    return rnd(x, dt) @ rnd(w, dt)


def gated_unit(x, x_prev, layer_params: Params, i: int, dt, cond=None, gcond=None):
    """Gated activation + residual update; returns (residual_out, z).
    `cond` (..., Cc) and `gcond` (..., E) add their products after the
    bias, in that order."""
    lp = layer_params
    pre = (
        _mm(x, lp["w_cur"][i], dt)
        + _mm(x_prev, lp["w_prev"][i], dt)
        + lp["b"][i]
    )
    if cond is not None:
        pre = pre + _mm(cond, lp["w_cond"][i], dt)
    if gcond is not None:
        pre = pre + _mm(gcond, lp["w_gcond"][i], dt)
    g = lp["w_cur"].shape[-1] // 2
    z = torch.tanh(pre[..., :g]) * torch.sigmoid(pre[..., g:])
    res = x + _mm(z, lp["w_res"][i], dt) + lp["b_res"][i]
    return res, z


def gated_layer(x, x_prev, layer_params: Params, i: int, dt, cond=None, gcond=None):
    """One gated residual unit; returns (residual_out, skip_contribution)."""
    lp = layer_params
    res, z = gated_unit(x, x_prev, layer_params, i, dt, cond, gcond)
    return res, _mm(z, lp["w_skip"][i], dt) + lp["b_skip"][i]


def input_frontend(params: Params, arch: ArchConfig, x_classes, dt,
                   fused_frontend: bool = False, input_mask=None):
    """Embed classes and apply the width-K causal input conv:
    (B, T) -> (B, T, C). `fused_frontend` runs it (and its gradient) through
    the frontend kernel pair (ops/cuda/frontend.py). `input_mask` (B, T)
    zeroes the masked embedding rows, then the masked output rows."""
    if input_mask is not None:
        input_mask = input_mask.detach().to(torch.float32)
    if fused_frontend:
        from ..ops.cuda.frontend import fused_frontend as _ff

        return _ff(params["embed"], params["input_conv"], x_classes,
                   input_mask=input_mask, compute_dtype=arch.compute_dtype)
    e = params["embed"][x_classes.long()]
    if input_mask is not None:
        e = e * input_mask[..., None]
    w = params["input_conv"]["w"]  # (K, C, C), tap k applies to t-(K-1-k)
    k_taps = w.shape[0]
    h = params["input_conv"]["b"].to(torch.float32)
    for k in range(k_taps):
        h = h + _mm(shift_right(e, k_taps - 1 - k), w[k], dt)
    if input_mask is not None:
        h = h * input_mask[..., None]
    return h


def input_step(params: Params, arch: ArchConfig, embed_buf, x_class):
    """One step of the input frontend for the ring-buffer engines.

    embed_buf (K-1, B, C) holds e(t-(K-1)) .. e(t-1); returns the residual
    input h (B, C) of class x_class (B,) and the shifted embedding stack."""
    dt = compute_dtype(arch)
    k_taps = arch.input_kernel
    e = params["embed"][x_class.long()]
    w_in = params["input_conv"]["w"]
    h = params["input_conv"]["b"].to(torch.float32) + _mm(e, w_in[k_taps - 1], dt)
    for j in range(k_taps - 1):
        h = h + _mm(embed_buf[j], w_in[j], dt)
    if k_taps > 1:
        embed_buf = torch.cat([embed_buf[1:], e[None].to(embed_buf.dtype)], 0)
    return h, embed_buf


def post_network(params: Params, skip_sum: torch.Tensor, dt) -> torch.Tensor:
    p = params["post"]
    h = torch.relu(skip_sum)
    h = torch.relu(_mm(h, p["w1"], dt) + p["b1"])
    return _mm(h, p["w2"], dt) + p["b2"]


def forward(
    params: Params,
    arch: ArchConfig,
    x_classes: torch.Tensor,
    cond_frames: Optional[torch.Tensor] = None,
    speaker_ids: Optional[torch.Tensor] = None,
    return_skip: bool = False,
    remat: bool = False,
    fused_frontend: bool = False,
    cond: Optional[torch.Tensor] = None,
    input_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Teacher-forced forward: classes (B, T) -> logits (B, T, Q), or the
    skip sum (B, T, S) with return_skip.

    logits[:, t] is the categorical distribution over sample t+1. The skip
    sum is ONE stacked contraction over (layer, gate), as in the JAX
    forward, plus the constant bias sum_l b_skip[l]. `remat` recomputes
    each layer in the backward (torch.utils.checkpoint) instead of keeping
    its activations; `fused_frontend` runs the frontend through its kernel
    pair.

    Conditioning comes as frame-rate `cond_frames` (B, F, n_mels),
    upsampled here, or as pre-upsampled sample-rate `cond` (B, T, Cc), not
    both; `speaker_ids` (B,) index the speaker table. `input_mask` (B, T) is
    the sequence-parallel halo mask: the masked frontend, and the residual
    stream re-masked after every layer (masked rows stay exactly 0).
    """
    if cond is not None and cond_frames is not None:
        raise ValueError("pass cond_frames OR pre-upsampled cond, not both")
    dt = compute_dtype(arch)
    lp = params["layers"]
    if cond_frames is not None:
        from .conditioning import upsample_cond

        cond = upsample_cond(params["upsampler"], arch, cond_frames, dt)
        cond = cond[:, : x_classes.shape[1]]
    gcond = None
    if speaker_ids is not None:
        table = params["speaker_embed"]
        gcond = table[torch.as_tensor(speaker_ids).to(table.device).long()][:, None, :]
    if input_mask is not None:
        input_mask = input_mask.detach().to(torch.float32)
    h = input_frontend(params, arch, x_classes, dt, fused_frontend, input_mask=input_mask)

    def one_layer(h, i, d):
        h_new, z = gated_unit(h, shift_right(h, d), lp, i, dt, cond=cond, gcond=gcond)
        if input_mask is not None:
            h_new = h_new * input_mask[..., None]
        return h_new, z

    zs = []
    for i, d in enumerate(arch.dilations):
        if remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            h, z = checkpoint(one_layer, h, i, d, use_reentrant=False)
        else:
            h, z = one_layer(h, i, d)
        zs.append(z)
    z_all = torch.stack(zs, dim=0)  # (L, B, T, G)
    skip_sum = torch.einsum(
        "lbtg,lgs->bts", rnd(z_all, dt), rnd(lp["w_skip"], dt)
    ) + lp["b_skip"].sum(dim=0)
    if return_skip:
        return skip_sum
    return post_network(params, skip_sum, dt)


def masked_loss_sums(logits: torch.Tensor, targets: torch.Tensor,
                     mask: torch.Tensor, window_size: int):
    """(sum of masked CE, sum of mask) over the last `window_size` logits:
    the accumulable form of masked_loss (gradient accumulation adds the
    numerators and the denominators and divides once)."""
    w_logits = logits[:, -window_size:, :]
    ce = -torch.log_softmax(w_logits, dim=-1)
    ce = ce.gather(-1, targets.long()[..., None])[..., 0]
    return (ce * mask).sum(), mask.sum()


def masked_loss(logits: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor, window_size: int) -> torch.Tensor:
    """Boundary-masked mean CE: logits (B, R-1+W, Q), targets/mask (B, W);
    logits[:, -W + j] predicts targets[:, j] (ops/geometry.py)."""
    num, den = masked_loss_sums(logits, targets, mask, window_size)
    return num / torch.clamp(den, min=1.0)
