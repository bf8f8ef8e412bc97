"""The post network and the masked cross-entropy numerator, forward and
backward (CUDA kernels `csrc/post_loss.cu`), as one
`torch.autograd.Function`.

Replaces `lb_wavenet_tpu/ops/pallas/post_loss.py` (`fused_post_loss`, its
`_fwd_kernel` and `_bwd_kernel`). Only the scored window [T - W, T) is
computed: the rows before it (the receptive-field head) give 0 to the
numerator and exactly 0 to dskip, as the TPU kernel's skipped head tiles
do. The numerator and the post-weight gradients are reduced in a fixed
order (no float atomics). Design and bound: the note at the top of
`csrc/post_loss.cu`.

The same function runs as plain PyTorch (`post_loss_plain`,
`post_loss_bwd_plain`), with the kernels' rounding: operands of every
product in the compute dtype, fp32 sums. A CPU tensor takes the plain
version; a CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ...models.wavenet import rnd
from . import build
from .train_stack import wgrad_chunks

POST_KEYS = ("w1", "b1", "w2", "b2")


def _rows(post: dict, skip_w: torch.Tensor, dt):
    """(a, u, h1, v) of the scored rows: relu(skip), the hidden layer before
    and after its relu, and the logits."""
    a = torch.relu(skip_w)
    u = rnd(a, dt) @ rnd(post["w1"], dt) + post["b1"]
    h1 = torch.relu(u)
    return a, u, h1, rnd(h1, dt) @ rnd(post["w2"], dt) + post["b2"]


def post_loss_plain(post: dict, skip, targets, mask, window_size: int, dt):
    """sum over the window of mask * CE(post(skip), targets): a 0-dim fp32
    tensor."""
    skip_w = skip[:, skip.shape[1] - window_size:]
    _, _, _, v = _rows(post, skip_w, dt)
    m = v.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(v - m).sum(-1, keepdim=True)) + m
    ce = lse - v.gather(-1, targets.long()[..., None])
    return (ce[..., 0] * mask).sum()


def post_loss_bwd_plain(post: dict, skip, targets, mask, window_size: int, dt, gbar):
    """(dskip (B, T, S), {post key: grad}) for the numerator's cotangent
    gbar."""
    head = skip.shape[1] - window_size
    skip_w = skip[:, head:]
    a, u, h1, v = _rows(post, skip_w, dt)
    e = torch.exp(v - v.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(targets.long(), v.shape[-1]).to(p.dtype)
    g = (p - onehot) * (mask * gbar)[..., None]
    gr = rnd(g, dt)
    du = torch.where(u > 0.0, gr @ rnd(post["w2"], dt).T, 0.0)
    dur = rnd(du, dt)
    da = dur @ rnd(post["w1"], dt).T
    dskip = torch.zeros_like(skip)
    dskip[:, head:] = torch.where(skip_w > 0.0, da, 0.0)
    grads = {
        "w1": torch.einsum("bts,btn->sn", rnd(a, dt), dur),
        "b1": du.sum((0, 1)),
        "w2": torch.einsum("bts,btq->sq", rnd(h1, dt), gr),
        "b2": g.sum((0, 1)),
    }
    return dskip, grads


class _PostArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "skip", "tgt", "mask", "w1", "b1", "w2", "b2", "w1T", "w2T", "gbar",
        "partial", "num", "dskip", "h1", "g", "du", "grads",
    )] + [(n, ctypes.c_int) for n in ("B", "T", "W", "S", "Q", "bf16", "chunks")]


def _cuda_args(post, skip, targets, mask, window_size, dt):
    dev = skip.device
    b, t, s = skip.shape
    q = post["w2"].shape[-1]
    if post["w1"].shape != (s, s) or post["w2"].shape != (s, q):
        raise ValueError("post weights do not match skip's channels")
    if s % 4 or q % 4 or not 0 < window_size <= t:
        raise ValueError(f"the CUDA post-loss needs S, Q divisible by 4 and "
                         f"0 < W <= T (got S={s}, Q={q}, W={window_size}, T={t})")
    if targets.shape != (b, window_size) or mask.shape != (b, window_size):
        raise ValueError("targets and mask must be (B, window_size)")
    w = {k: post[k].to(dt if k.startswith("w") else torch.float32).contiguous()
         for k in POST_KEYS}
    keep = dict(
        skip=skip.to(torch.float32).contiguous(),
        tgt=targets.to(dev, torch.int32).contiguous(),
        mask=mask.to(dev, torch.float32).contiguous(), **w,
    )
    return keep, (b, t, window_size, s, q, int(dt == torch.bfloat16))


def post_loss_fwd(post: dict, skip, targets, mask, window_size: int, dt):
    """Forward kernels on the card: the numerator (0-dim). 2 launches."""
    keep, dims = _cuda_args(post, skip, targets, mask, window_size, dt)
    b, _, w, _, _, _ = dims
    lib = build.load("post_loss")
    blocks = b * -(-w // lib.wn_post_loss_rows())
    partial = torch.empty(blocks, dtype=torch.float32, device=skip.device)
    num = torch.empty((), dtype=torch.float32, device=skip.device)
    args = _PostArgs(
        *(keep[k].data_ptr() for k in ("skip", "tgt", "mask", "w1", "b1", "w2", "b2")),
        0, 0, 0, partial.data_ptr(), num.data_ptr(), 0, 0, 0, 0, 0, *dims, 0,
    )
    post_loss_fwd.launches += build.launch(lib, "wn_post_loss_fwd", args, skip.device)
    return num


post_loss_fwd.launches = 0


def post_loss_bwd(post: dict, skip, targets, mask, window_size: int, dt, gbar):
    """Backward kernels on the card: (dskip, {post key: grad}) as the plain
    version returns them. 3 launches."""
    keep, dims = _cuda_args(post, skip, targets, mask, window_size, dt)
    b, t, w, s, q, _ = dims
    dev = skip.device
    chunks = wgrad_chunks(b * w)
    nw = s * s + s + s * q + q
    w1t = keep["w1"].T.contiguous()
    w2t = keep["w2"].T.contiguous()
    gbar = gbar.to(dev, torch.float32).reshape(()).contiguous()
    dskip = torch.zeros((b, t, s), dtype=torch.float32, device=dev)
    h1 = torch.empty((b, w, s), dtype=torch.float32, device=dev)
    g = torch.empty((b, w, q), dtype=torch.float32, device=dev)
    du = torch.empty((b, w, s), dtype=torch.float32, device=dev)
    partial = torch.empty((chunks, nw), dtype=torch.float32, device=dev)
    grads = torch.empty(nw, dtype=torch.float32, device=dev)
    args = _PostArgs(
        *(keep[k].data_ptr() for k in ("skip", "tgt", "mask", "w1", "b1", "w2", "b2")),
        w1t.data_ptr(), w2t.data_ptr(), gbar.data_ptr(), partial.data_ptr(), 0,
        dskip.data_ptr(), h1.data_ptr(), g.data_ptr(), du.data_ptr(), grads.data_ptr(),
        *dims, chunks,
    )
    post_loss_bwd.launches += build.launch(build.load("post_loss"), "wn_post_loss_bwd",
                                           args, dev)
    parts = torch.split(grads, [s * s, s, s * q, q])
    shapes = [(s, s), (s,), (s, q), (q,)]
    return dskip, {k: p.reshape(sh) for k, p, sh in zip(POST_KEYS, parts, shapes)}


post_loss_bwd.launches = 0


class _PostLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, window_size, dt, skip, targets, mask, *weights):
        post = dict(zip(POST_KEYS, weights))
        if build.on_card(skip.device, "the post-loss"):
            num = post_loss_fwd(post, skip, targets, mask, window_size, dt)
        else:
            num = post_loss_plain(post, skip, targets, mask, window_size, dt)
        ctx.cfg = (window_size, dt)
        ctx.save_for_backward(skip, targets, mask, *weights)
        return num

    @staticmethod
    def backward(ctx, gbar):
        window_size, dt = ctx.cfg
        skip, targets, mask, *weights = ctx.saved_tensors
        post = dict(zip(POST_KEYS, weights))
        bwd = post_loss_bwd if skip.device.type == "cuda" else post_loss_bwd_plain
        dskip, grads = bwd(post, skip, targets, mask, window_size, dt, gbar)
        return (None, None, dskip, None, None, *(grads[k] for k in POST_KEYS))


def fused_post_loss(post: dict, skip: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor, window_size: int,
                    compute_dtype: str = "bfloat16") -> torch.Tensor:
    """sum(CE * mask) over the last `window_size` positions of skip
    (B, T, S) fp32 with targets/mask (B, W): the masked-CE NUMERATOR of
    masked_loss_sums with the post network fused in. Differentiable in
    (post, skip); targets and mask are structural."""
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(compute_dtype)]
    return _PostLoss.apply(int(window_size), dt, skip, targets, mask,
                           *(post[k] for k in POST_KEYS))
