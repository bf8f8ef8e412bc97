"""The training stack: all L gated dilated layers over whole rows, forward
and a hand-written backward (CUDA kernels `csrc/train_stack.cu`), as one
`torch.autograd.Function`.

Replaces `lb_wavenet_tpu/ops/pallas/train_stack.py` (`_fwd_call`,
`_bwd_call`, `make_fused_stack`). The TPU kernel keeps a whole row in VMEM
across the layers and reconstructs the layer inputs backwards; the CUDA
version launches once per layer (a row does not fit in an SM) and keeps
every layer's input in `x_all` (L, B, T, C) fp32 for the backward (design
and bound: the note at the top of `csrc/train_stack.cu`). z is kept in the
compute dtype, as the TPU kernel writes it.

The same function runs as plain PyTorch (`stack_fwd_plain`,
`stack_bwd_plain`): operands of every product rounded to the compute
dtype, fp32 sums, the TPU kernels' order of additions. A CPU tensor takes
the plain version; a CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ...config import ArchConfig
from ...models.wavenet import compute_dtype, rnd, shift_right
from . import build

LAYER_KEYS = ("w_cur", "w_prev", "b", "w_res", "b_res", "w_skip", "b_skip")


def _shift_left(y: torch.Tensor, d: int) -> torch.Tensor:
    """y[:, t + d] with zeros past the end. Shapes (B, T, C)."""
    t = y.shape[1]
    return torch.nn.functional.pad(y, (0, 0, 0, d))[:, d:d + t]


def _pre(xr, xsh, lp, i, dt, tapcat):
    """Gate pre-activation from rounded x(t) and x(t - d)."""
    wc, wp = rnd(lp["w_cur"][i], dt), rnd(lp["w_prev"][i], dt)
    if tapcat:
        return torch.cat([xr, xsh], -1) @ torch.cat([wc, wp], 0) + lp["b"][i]
    return (xr @ wc + xsh @ wp) + lp["b"][i]


def stack_fwd_plain(lp: dict, h0: torch.Tensor, dils, dt, tapcat: bool):
    """PyTorch version of the forward kernels: (skip (B, T, S) fp32,
    z_all (L, B, T, G) compute dtype, x_all (L, B, T, C) fp32)."""
    g = lp["w_cur"].shape[-1] // 2
    x, xs, zs, skip = h0, [], [], None
    for i, d in enumerate(dils):
        xs.append(x)
        xr = rnd(x, dt)
        pre = _pre(xr, shift_right(xr, d), lp, i, dt, tapcat)
        z = (torch.tanh(pre[..., :g]) * torch.sigmoid(pre[..., g:])).to(dt)
        zs.append(z)
        zf = z.float()
        x = (x + zf @ rnd(lp["w_res"][i], dt)) + lp["b_res"][i]
        contrib = zf @ rnd(lp["w_skip"][i], dt) + lp["b_skip"][i]
        skip = contrib if skip is None else skip + contrib
    return skip, torch.stack(zs), torch.stack(xs)


def stack_bwd_plain(lp: dict, dils, dt, tapcat: bool, z_all, x_all, g_skip):
    """PyTorch version of the backward kernels: (dh0, {layer key: grad})."""
    g = lp["w_cur"].shape[-1] // 2
    gs = rnd(g_skip, dt)
    dx = torch.zeros_like(x_all[0])
    out = {k: [None] * len(dils) for k in LAYER_KEYS}
    for i in reversed(range(len(dils))):
        d = dils[i]
        xr = rnd(x_all[i], dt)
        xsh = shift_right(xr, d)
        z = z_all[i].float()
        pre = _pre(xr, xsh, lp, i, dt, tapcat)
        th, sg = torch.tanh(pre[..., :g]), torch.sigmoid(pre[..., g:])
        dxr = rnd(dx, dt)
        dz = gs @ rnd(lp["w_skip"][i], dt).T + dxr @ rnd(lp["w_res"][i], dt).T
        dpre = torch.cat([dz * sg * (1.0 - th * th), dz * th * sg * (1.0 - sg)], -1)
        dpr = rnd(dpre, dt)
        proj_p = dpr @ rnd(lp["w_prev"][i], dt).T
        dx_new = (dx + dpr @ rnd(lp["w_cur"][i], dt).T) + _shift_left(proj_p, d)
        out["w_cur"][i] = torch.einsum("btc,btn->cn", xr, dpr)
        out["w_prev"][i] = torch.einsum("btc,btn->cn", xsh, dpr)
        out["b"][i] = dpre.sum((0, 1))
        out["w_res"][i] = torch.einsum("btg,btc->gc", z, dxr)
        out["b_res"][i] = dx.sum((0, 1))
        out["w_skip"][i] = torch.einsum("btg,bts->gs", z, gs)
        out["b_skip"][i] = g_skip.sum((0, 1))
        dx = dx_new
    return dx, {k: torch.stack(v) for k, v in out.items()}


class _FwdArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "h0", "x_all", "z_all", "skip", "w_cur", "w_prev", "b", "w_res",
        "b_res", "w_skip", "b_skip", "dils",
    )] + [(n, ctypes.c_int) for n in ("B", "T", "L", "C", "G", "S", "bf16", "tapcat")]


class _BwdArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x_all", "z_all", "g_skip", "dx", "dpre", "partial", "grads", "w_cur",
        "w_prev", "b", "wcT", "wpT", "wrT", "wsT", "dils",
    )] + [(n, ctypes.c_int) for n in (
        "B", "T", "L", "C", "G", "S", "bf16", "tapcat", "chunks")]


def _check_shapes(lp: dict, h0: torch.Tensor):
    b, t, c = h0.shape
    L, c2, two_g = lp["w_cur"].shape
    s = lp["w_skip"].shape[-1]
    g = two_g // 2
    if c2 != c or lp["w_res"].shape != (L, g, c) or lp["w_skip"].shape != (L, g, s):
        raise ValueError("layer weights do not match h0's channels")
    if c % 4 or g % 4 or s % 4 or s > 512:
        raise ValueError(f"the CUDA stack needs C, G, S divisible by 4 and S <= 512 "
                         f"(got C={c}, G={g}, S={s})")
    return b, t, c, g, s, L


def _cuda_weights(lp: dict, dt) -> dict:
    """Weights in the compute dtype (plus the transposes the backward
    reads), biases fp32, all contiguous."""
    w = {k: lp[k].to(dt if k.startswith("w") else torch.float32).contiguous()
         for k in LAYER_KEYS}
    for k, t in (("w_cur", "wcT"), ("w_prev", "wpT"), ("w_res", "wrT"), ("w_skip", "wsT")):
        w[t] = w[k].transpose(1, 2).contiguous()
    return w


def train_stack_fwd(lp: dict, h0: torch.Tensor, dils, dt, tapcat: bool):
    """Forward kernels on the card: (skip, z_all, x_all) as the plain
    version returns them. L + 1 launches."""
    dev = h0.device
    b, t, c, g, s, L = _check_shapes(lp, h0)
    if len(dils) != L or h0.dtype != torch.float32:
        raise ValueError("h0 must be fp32 and the dilations one per layer")
    w = _cuda_weights(lp, dt)
    h0 = h0.contiguous()
    x_all = torch.empty((L, b, t, c), dtype=torch.float32, device=dev)
    z_all = torch.empty((L, b, t, g), dtype=dt, device=dev)
    skip = torch.empty((b, t, s), dtype=torch.float32, device=dev)
    dil = (ctypes.c_int * L)(*dils)
    args = _FwdArgs(
        h0.data_ptr(), x_all.data_ptr(), z_all.data_ptr(), skip.data_ptr(),
        *(w[k].data_ptr() for k in LAYER_KEYS), ctypes.addressof(dil),
        b, t, L, c, g, s, int(dt == torch.bfloat16), int(tapcat),
    )
    train_stack_fwd.launches += build.launch(
        build.load("train_stack"), "wn_train_stack_fwd", args, dev)
    return skip, z_all, x_all


train_stack_fwd.launches = 0


def wgrad_chunks(n_pos: int) -> int:
    """Position chunks of the weight-gradient reduction (fixed per shape,
    so the summation order is too)."""
    return max(1, min(64, -(-n_pos // 2048)))


def train_stack_bwd(lp: dict, dils, dt, tapcat: bool, z_all, x_all, g_skip):
    """Backward kernels on the card: (dh0, {layer key: grad}) as the plain
    version returns them. 3 L + 1 launches."""
    dev = x_all.device
    L, b, t, c = x_all.shape
    g = z_all.shape[-1]
    s = g_skip.shape[-1]
    w = _cuda_weights(lp, dt)
    g_skip = g_skip.to(torch.float32).contiguous()
    chunks = wgrad_chunks(b * t)
    nw = 2 * c * 2 * g + 2 * g + g * c + c + g * s + s
    dx = torch.empty((2, b, t, c), dtype=torch.float32, device=dev)
    dpre = torch.empty((b, t, 2 * g), dtype=torch.float32, device=dev)
    partial = torch.empty((L, chunks, nw), dtype=torch.float32, device=dev)
    grads = torch.empty((L, nw), dtype=torch.float32, device=dev)
    dil = (ctypes.c_int * L)(*dils)
    args = _BwdArgs(
        x_all.data_ptr(), z_all.data_ptr(), g_skip.data_ptr(), dx.data_ptr(),
        dpre.data_ptr(), partial.data_ptr(), grads.data_ptr(),
        w["w_cur"].data_ptr(), w["w_prev"].data_ptr(), w["b"].data_ptr(),
        w["wcT"].data_ptr(), w["wpT"].data_ptr(), w["wrT"].data_ptr(),
        w["wsT"].data_ptr(), ctypes.addressof(dil),
        b, t, L, c, g, s, int(dt == torch.bfloat16), int(tapcat), chunks,
    )
    train_stack_bwd.launches += build.launch(
        build.load("train_stack"), "wn_train_stack_bwd", args, dev)
    sizes = [c * 2 * g, c * 2 * g, 2 * g, g * c, c, g * s, s]
    shapes = [(c, 2 * g), (c, 2 * g), (2 * g,), (g, c), (c,), (g, s), (s,)]
    parts = torch.split(grads, sizes, dim=1)
    out = {k: p.reshape((L,) + sh) for k, p, sh in zip(LAYER_KEYS, parts, shapes)}
    return dx[L % 2], out


train_stack_bwd.launches = 0


class _Stack(torch.autograd.Function):
    """skip = stack(lp, h0); the backward is the hand-written one."""

    @staticmethod
    def forward(ctx, dils, dt, tapcat, h0, *weights):
        lp = dict(zip(LAYER_KEYS, weights))
        if build.on_card(h0.device, "the training stack"):
            skip, z_all, x_all = train_stack_fwd(lp, h0, dils, dt, tapcat)
        else:
            skip, z_all, x_all = stack_fwd_plain(lp, h0, dils, dt, tapcat)
        ctx.cfg = (dils, dt, tapcat)
        ctx.save_for_backward(z_all, x_all, *weights)
        return skip

    @staticmethod
    def backward(ctx, g_skip):
        dils, dt, tapcat = ctx.cfg
        z_all, x_all, *weights = ctx.saved_tensors
        lp = dict(zip(LAYER_KEYS, weights))
        if x_all.device.type == "cuda":
            dh0, grads = train_stack_bwd(lp, dils, dt, tapcat, z_all, x_all, g_skip)
        else:
            dh0, grads = stack_bwd_plain(lp, dils, dt, tapcat, z_all, x_all, g_skip)
        return (None, None, None, dh0, *(grads[k] for k in LAYER_KEYS))


def make_fused_stack(arch: ArchConfig, has_cond: bool = False, tapcat: bool = False,
                     has_mask: bool = False):
    """fn(lp, h0) -> skip_sum (B, T, S) fp32 over the layers dict `lp`
    (w_cur, w_prev, b, w_res, b_res, w_skip, b_skip) and h0 (B, T, C) fp32,
    differentiable in both. `tapcat` sums the two taps as one 2C-deep
    contraction (the order of the TPU kernel's tap concat)."""
    if has_cond:
        raise NotImplementedError(
            "the conditioned training stack waits for the mel/speaker slice "
            "(ROADMAP.md A queue item 4)")
    if has_mask:
        raise NotImplementedError(
            "the sequence-parallel input mask waits for the parallelism slice "
            "(ROADMAP.md A queue item 7b)")
    dils = tuple(arch.dilations)
    dt = compute_dtype(arch)

    def fused(lp: dict, h0: torch.Tensor) -> torch.Tensor:
        return _Stack.apply(dils, dt, bool(tapcat), h0, *(lp[k] for k in LAYER_KEYS))

    return fused
