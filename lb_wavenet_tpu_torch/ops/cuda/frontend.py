"""The input frontend of the training step: embedding lookup + width-K causal
input conv, forward and a hand-written backward (CUDA kernels
`csrc/frontend.cu`), as one `torch.autograd.Function`.

Replaces `lb_wavenet_tpu/ops/pallas/frontend.py` (`fused_frontend`, its
`_fwd_kernel` and `_bwd_kernel`). The TPU kernels write the gather as a
one-hot MXU contraction; here it is a gather (design and bound: the note at
the top of `csrc/frontend.cu`).

Which operand is rounded where (compute dtype dt; the reference is the JAX
kernel as it runs in interpret mode on the CPU, where a DEFAULT-precision
float32 dot does not round its operands):
  * forward: e = dt(embed[x]) (the one-hot contraction's value), w[k] in
    dt, fp32 sums; h = b + ((tap_0 + tap_1) + ...), the kernel's order.
    Positions before t = 0 (the sentinel class) embed to zero.
  * d_b = sum of dh, fp32.
  * d_w[k] = sum_t embed[x[t - (K-1-k)]]^T dh[t]: neither e nor dh rounded,
    an fp32 sum (unrounded like the TPU kernel's VMEM tile sum).
  * d_e pieces: dh (fp32, unrounded) @ dt(w[k])^T, each piece rounded to dt
    before the fp32 tap-sum; d_embed = the scatter-add of d_e by class.
The sequence-parallel input mask is not ported yet.

The same function runs as plain PyTorch (`frontend_fwd_plain`,
`frontend_bwd_plain`). A CPU tensor takes the plain version; a CUDA tensor
launches the kernels or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ...models.wavenet import rnd, shift_right
from . import build
from .train_stack import _shift_left

MAX_TAPS = 7   # the weight-gradient launch takes K outer products + 1 bias sum


def _embed_rows(embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """embed[x] (B, T, C) with zero rows for classes outside [0, Q)."""
    q = embed.shape[0]
    ok = (x >= 0) & (x < q)
    e = embed[torch.where(ok, x, 0).long()]
    return torch.where(ok[..., None], e, 0.0)


def frontend_fwd_plain(embed, w, b, x, dt):
    """PyTorch version of the forward kernel: h0 (B, T, C) fp32."""
    k_taps = w.shape[0]
    er = rnd(_embed_rows(embed, x), dt)
    acc = None
    for k in range(k_taps):
        part = shift_right(er, k_taps - 1 - k) @ rnd(w[k], dt)
        acc = part if acc is None else acc + part
    return b.to(torch.float32) + acc


def frontend_bwd_plain(embed, w, x, dt, dh):
    """PyTorch version of the backward kernels: (d_embed (Q, C), d_w
    (K, C, C), d_b (C,))."""
    k_taps = w.shape[0]
    q, c = embed.shape
    dh = dh.to(torch.float32)
    e = _embed_rows(embed, x)
    de = None
    for k in range(k_taps):
        piece = rnd(dh @ rnd(w[k], dt).T, dt)
        piece = _shift_left(piece, k_taps - 1 - k)
        de = piece if de is None else de + piece
    ok = ((x >= 0) & (x < q)).reshape(-1)
    d_embed = torch.zeros((q, c), dtype=torch.float32, device=dh.device)
    d_embed.index_add_(0, x.reshape(-1)[ok].long(), de.reshape(-1, c)[ok])
    d_w = torch.stack([torch.einsum("btc,btn->cn", shift_right(e, k_taps - 1 - k), dh)
                       for k in range(k_taps)])
    return d_embed, d_w, dh.sum((0, 1))


class _FrontArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "emb", "w", "wT", "bias", "h", "dh", "de", "e", "partial", "grads",
    )] + [(n, ctypes.c_int) for n in ("B", "T", "Q", "C", "K", "bf16")]


def _cuda_inputs(embed, w, b, x, dt):
    """The kernels' operands, checked: classes int32, weights in the compute
    dtype (and transposed for the backward), embedding and bias (None in
    the backward) fp32."""
    dev = embed.device
    q, c = embed.shape
    k_taps = w.shape[0]
    if w.shape != (k_taps, c, c) or x.dim() != 2 or (b is not None and b.shape != (c,)):
        raise ValueError(f"frontend shapes: embed {tuple(embed.shape)}, w "
                         f"{tuple(w.shape)}, x {tuple(x.shape)}")
    if not 1 <= k_taps <= MAX_TAPS or q * c * 4 > 227 * 1024 or c > 1024:
        raise ValueError(f"the CUDA frontend needs 1 <= K <= {MAX_TAPS}, C <= 1024 and "
                         f"a (Q, C) fp32 table within 227 KB (got K={k_taps}, Q={q}, C={c})")
    if x.device != dev or w.device != dev or (b is not None and b.device != dev):
        raise ValueError("embed, w, b and x must be on one device")
    wd = w.to(dt).contiguous()
    return dict(
        x=x.to(torch.int32).contiguous(), emb=embed.to(torch.float32).contiguous(),
        w=wd, wT=wd.transpose(1, 2).contiguous(),
        bias=None if b is None else b.to(torch.float32).contiguous(),
    )


def _args(ops, bsz, t, q, c, k, dt, **ptrs):
    p = {n: build.ptr(ops.get(n)) for n in ("x", "emb", "w", "wT", "bias")}
    p.update({n: build.ptr(v) for n, v in ptrs.items()})
    return _FrontArgs(*(p.get(n, 0) for n, _ in _FrontArgs._fields_[:11]),
                      bsz, t, q, c, k, int(dt == torch.bfloat16))


def frontend_fwd(embed, w, b, x, dt):
    """Forward kernel on the card: h0 (B, T, C) fp32. 1 launch."""
    ops = _cuda_inputs(embed, w, b, x, dt)
    bsz, t = x.shape
    q, c = embed.shape
    h = torch.empty((bsz, t, c), dtype=torch.float32, device=embed.device)
    args = _args(ops, bsz, t, q, c, w.shape[0], dt, h=h)
    frontend_fwd.launches += build.launch(build.load("frontend"), "wn_front_fwd", args,
                                          embed.device)
    return h


frontend_fwd.launches = 0


def frontend_bwd(embed, w, x, dt, dh):
    """Backward kernels on the card: (d_embed, d_w, d_b) as the plain
    version returns them. 4 launches."""
    dev = embed.device
    ops = _cuda_inputs(embed, w, None, x, dt)
    bsz, t = x.shape
    q, c = embed.shape
    k_taps = w.shape[0]
    if dh.shape != (bsz, t, c):
        raise ValueError(f"dh must be {(bsz, t, c)}, got {tuple(dh.shape)}")
    dh = dh.to(torch.float32).contiguous()
    lib = build.load("frontend")
    lib.wn_front_scatter_chunk.argtypes, lib.wn_front_scatter_chunk.restype = [], ctypes.c_int
    chunks = -(-bsz * t // lib.wn_front_scatter_chunk())
    nw = q * c + k_taps * c * c + c
    de = torch.empty_like(dh)
    e = torch.empty_like(dh)
    partial = torch.empty((chunks, nw), dtype=torch.float32, device=dev)
    grads = torch.empty(nw, dtype=torch.float32, device=dev)
    args = _args(ops, bsz, t, q, c, k_taps, dt, dh=dh, de=de, e=e, partial=partial,
                 grads=grads)
    frontend_bwd.launches += build.launch(lib, "wn_front_bwd", args, dev)
    d_embed, d_w, d_b = torch.split(grads, [q * c, k_taps * c * c, c])
    return d_embed.view(q, c), d_w.view(k_taps, c, c), d_b


frontend_bwd.launches = 0


class _Frontend(torch.autograd.Function):
    """h0 = frontend(embed, w, b; x); the backward is the hand-written one."""

    @staticmethod
    def forward(ctx, dt, x, embed, w, b):
        if build.on_card(embed.device, "the frontend"):
            h = frontend_fwd(embed, w, b, x, dt)
        else:
            h = frontend_fwd_plain(embed, w, b, x, dt)
        ctx.dt = dt
        ctx.save_for_backward(x, embed, w)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, embed, w = ctx.saved_tensors
        bwd = frontend_bwd if embed.device.type == "cuda" else frontend_bwd_plain
        d_embed, d_w, d_b = bwd(embed, w, x, ctx.dt, dh)
        return None, None, d_embed, d_w, d_b


def fused_frontend(embed: torch.Tensor, conv: dict, x_classes: torch.Tensor,
                   input_mask=None, compute_dtype: str = "bfloat16") -> torch.Tensor:
    """input_frontend (models/wavenet.py) through the kernel pair: h0
    (B, T, C) fp32 from classes (B, T), differentiable in embed and conv
    ({"w": (K, C, C), "b": (C,)}); the classes get no gradient."""
    if input_mask is not None:
        raise NotImplementedError(
            "the sequence-parallel input mask waits for the parallelism slice "
            "(ROADMAP.md A queue item 7b)")
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(compute_dtype)]
    return _Frontend.apply(dt, x_classes, embed, conv["w"], conv["b"])
