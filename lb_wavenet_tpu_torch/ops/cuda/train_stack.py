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

Two routes of kernels, chosen before the launch from dtype and widths
(`route`): bf16 with C, G, S multiples of 16 runs on tensor cores; fp32 and
other bf16 widths run the first-version CUDA-core kernels.

The same function runs as plain PyTorch (`stack_fwd_plain`,
`stack_bwd_plain`): operands of every product rounded to the compute
dtype, fp32 sums, the TPU kernels' order of additions; on a CUDA tensor on
the tensor-core route each product is summed as the tensor cores sum it
(`tc_mm`), so kernel and plain version agree bit for bit in z, x, skip and
dh0. A CPU tensor takes the plain version; a CUDA tensor launches the
kernels or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...config import ArchConfig
from ...models.wavenet import compute_dtype, rnd, shift_right
from . import ar_tc, build

LAYER_KEYS = ("w_cur", "w_prev", "b", "w_res", "b_res", "w_skip", "b_skip")


def _shift_left(y: torch.Tensor, d: int) -> torch.Tensor:
    """y[:, t + d] with zeros past the end. Shapes (B, T, C)."""
    t = y.shape[1]
    return torch.nn.functional.pad(y, (0, 0, 0, d))[:, d:d + t]


def tc_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ w (K, M), both holding bf16 values, summed as the
    tensor-core route sums every product: one mma from zero per 16-deep
    k-step (ar_tc.tc_sum16), added in k-step order in fp32. In float64, in
    row chunks of about 2 GB of temporaries."""
    k, m = w.shape
    rows = a.reshape(-1, k)
    out = torch.empty((rows.shape[0], m), dtype=torch.float32, device=a.device)
    step = max(1, (2 << 30) // (m * k * 8 * 5))
    for i in range(0, rows.shape[0], step):
        out[i:i + step] = ar_tc.tc_product(w.t(), rows[i:i + step].t()).t()
    return out.reshape(a.shape[:-1] + (m,))


def default_order(device, c: int, g: int, s: int, dt) -> bool:
    """Whether the plain versions sum as the tensor-core route does: on a
    CUDA tensor (where they are the kernels' reference) on that route. A
    bf16 stack of 30 layers carries any other order's rounding flips of z
    and x from layer to layer (a few 1e-2 of a gradient leaf at WaveNet-30);
    on the CPU one fp32 sum per product is several times cheaper."""
    return torch.device(device).type == "cuda" and route(c, g, s, dt) == "tensor_cores"


def _pre(xr, xsh, lp, i, dt, tapcat, mm):
    """Gate pre-activation from rounded x(t) and x(t - d)."""
    wc, wp = rnd(lp["w_cur"][i], dt), rnd(lp["w_prev"][i], dt)
    if tapcat:
        return mm(torch.cat([xr, xsh], -1), torch.cat([wc, wp], 0)) + lp["b"][i]
    return (mm(xr, wc) + mm(xsh, wp)) + lp["b"][i]


def _widths(lp: dict):
    """(C, G, S) of the layer weights."""
    return lp["w_cur"].shape[1], lp["w_cur"].shape[2] // 2, lp["w_skip"].shape[2]


def stack_fwd_plain(lp: dict, h0: torch.Tensor, dils, dt, tapcat: bool,
                    tensor_cores: Optional[bool] = None):
    """PyTorch version of the forward kernels: (skip (B, T, S) fp32,
    z_all (L, B, T, G) compute dtype, x_all (L, B, T, C) fp32). With
    tensor_cores (default: `default_order`) each product is summed as the
    tensor-core route sums it (tc_mm), else in one fp32 product."""
    if tensor_cores is None:
        tensor_cores = default_order(h0.device, *_widths(lp), dt)
    mm = tc_mm if tensor_cores else torch.matmul
    g = lp["w_cur"].shape[-1] // 2
    x, xs, zs, skip = h0, [], [], None
    for i, d in enumerate(dils):
        xs.append(x)
        xr = rnd(x, dt)
        pre = _pre(xr, shift_right(xr, d), lp, i, dt, tapcat, mm)
        z = (torch.tanh(pre[..., :g]) * torch.sigmoid(pre[..., g:])).to(dt)
        zs.append(z)
        zf = z.float()
        x = (x + mm(zf, rnd(lp["w_res"][i], dt))) + lp["b_res"][i]
        contrib = mm(zf, rnd(lp["w_skip"][i], dt)) + lp["b_skip"][i]
        skip = contrib if skip is None else skip + contrib
    return skip, torch.stack(zs), torch.stack(xs)


def stack_bwd_plain(lp: dict, dils, dt, tapcat: bool, z_all, x_all, g_skip,
                    tensor_cores: Optional[bool] = None):
    """PyTorch version of the backward kernels: (dh0, {layer key: grad}).
    tensor_cores as in stack_fwd_plain (the products of pre, dz and dx; the
    weight gradients are fp32 sums over positions, whose order moves them by
    rounding only)."""
    if tensor_cores is None:
        tensor_cores = default_order(x_all.device, *_widths(lp), dt)
    mm = tc_mm if tensor_cores else torch.matmul
    g = lp["w_cur"].shape[-1] // 2
    gs = rnd(g_skip, dt)
    dx = torch.zeros_like(x_all[0])
    out = {k: [None] * len(dils) for k in LAYER_KEYS}
    for i in reversed(range(len(dils))):
        d = dils[i]
        xr = rnd(x_all[i], dt)
        xsh = shift_right(xr, d)
        z = z_all[i].float()
        pre = _pre(xr, xsh, lp, i, dt, tapcat, mm)
        th, sg = torch.tanh(pre[..., :g]), torch.sigmoid(pre[..., g:])
        dxr = rnd(dx, dt)
        dz = mm(gs, rnd(lp["w_skip"][i], dt).T) + mm(dxr, rnd(lp["w_res"][i], dt).T)
        dpre = torch.cat([dz * sg * (1.0 - th * th), dz * th * sg * (1.0 - sg)], -1)
        dpr = rnd(dpre, dt)
        proj_p = mm(dpr, rnd(lp["w_prev"][i], dt).T)
        dx_new = (dx + mm(dpr, rnd(lp["w_cur"][i], dt).T)) + _shift_left(proj_p, d)
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
    )] + [(n, ctypes.c_int) for n in ("B", "T", "L", "C", "G", "S", "bf16", "tapcat", "tc")]


class _BwdArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x_all", "z_all", "g_skip", "dx", "dpre", "partial", "grads", "w_cur",
        "w_prev", "b", "wcT", "wpT", "wrT", "wsT", "dils",
    )] + [(n, ctypes.c_int) for n in (
        "B", "T", "L", "C", "G", "S", "bf16", "tapcat", "chunks")]


class _BwdTcArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x_all", "z_all", "g_skip", "gs", "dx", "dpre", "partial", "grads", "part_s",
        "dbs", "w_cur", "w_prev", "b", "w_res", "w_skip", "dils",
    )] + [(n, ctypes.c_int) for n in (
        "B", "T", "L", "C", "G", "S", "tapcat", "chunks", "s_chunks")]


# Tensor-core route (csrc/train_stack.cu, namespace tsc): positions per tile,
# row padding, skip columns per pass of the backward layer pass, positions
# and columns of a skip-pass item and the layers it stages ahead, and the
# shared memory a block may use on an H100 (227 KB).
TC_TILE, TC_PAD, TC_SKIP_COLS = 64, 8, 256
TC_SKIP_TILE, TC_SKIP_STAGES, TC_SMEM_MAX = 128, 3, 232448


def tc_smem(c: int, g: int, s: int) -> int:
    """Bytes of dynamic shared memory of the largest tensor-core kernel, as
    csrc/train_stack.cu carves them (its `wn_train_stack_tc_smem` must agree:
    `_route` checks it before a launch). The skip pass and the backward layer
    pass take S in passes of TC_SKIP_TILE and TC_SKIP_COLS columns, so S
    beyond those adds only the backward's fp32 tile of dz over the passes."""
    tp, pad, ts = TC_TILE, TC_PAD, TC_SKIP_TILE
    sc = min(s, TC_SKIP_COLS)
    fwd = 2 * (2 * c * (2 * g + pad) + g * (c + pad) + tp * (2 * c + pad) + tp * (g + pad))
    skip = TC_SKIP_STAGES * (2 * (g * (min(s, ts) + pad) + ts * (g + pad)) + 4 * min(s, ts))
    bwd = (2 * (2 * c * (2 * g + pad) + g * (c + pad) + g * (sc + pad)
                + tp * (2 * c + g + c + sc + 2 * g + 5 * pad))
           + 4 * (tp * (c + (g if s > TC_SKIP_COLS else 0)) + tp // 16 * 2 * g + 2 * g + c))
    dx = 2 * (2 * c * (2 * g + pad) + 2 * tp * (2 * g + pad))
    return max(fwd, skip, bwd, dx)


def route(c: int, g: int, s: int, dt) -> str:
    """Which kernels run the stack, decided before launch from the compute
    dtype and widths: "tensor_cores" for bf16 with C, G and S multiples of
    16 whose tiles fit in a block's shared memory (any such S); "cuda_cores"
    (the first-version fp32-FMA kernels) for fp32, where tensor cores (TF32)
    would change the function, and for any other bf16 width."""
    if (dt == torch.bfloat16 and not (c % 16 or g % 16 or s % 16)
            and tc_smem(c, g, s) <= TC_SMEM_MAX):
        return "tensor_cores"
    return "cuda_cores"


def lib_tc_smem(lib, c: int, g: int, s: int) -> int:
    """The built library's own count of tc_smem's bytes."""
    f = lib.wn_train_stack_tc_smem
    f.argtypes, f.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    return int(f(c, g, s))


def _route(lib, c: int, g: int, s: int, dt) -> bool:
    """route() on the card: whether the tensor-core kernels run, after
    checking that the library carves shared memory as tc_smem reckons it
    (else a shape could be sent to the wrong route)."""
    if lib_tc_smem(lib, c, g, s) != tc_smem(c, g, s):
        raise RuntimeError(
            f"csrc/train_stack.cu carves {lib_tc_smem(lib, c, g, s)} bytes of shared memory "
            f"at C={c}, G={g}, S={s}; train_stack.tc_smem reckons {tc_smem(c, g, s)}")
    return route(c, g, s, dt) == "tensor_cores"


def _check_shapes(lp: dict, h0: torch.Tensor, dt):
    b, t, c = h0.shape
    L, c2, two_g = lp["w_cur"].shape
    s = lp["w_skip"].shape[-1]
    g = two_g // 2
    if c2 != c or lp["w_res"].shape != (L, g, c) or lp["w_skip"].shape != (L, g, s):
        raise ValueError("layer weights do not match h0's channels")
    if route(c, g, s, dt) == "cuda_cores" and (c % 4 or g % 4 or s % 4 or s > 512):
        raise ValueError(f"the CUDA-core stack needs C, G, S divisible by 4 and S <= 512 "
                         f"(got C={c}, G={g}, S={s}, {dt})")
    return b, t, c, g, s, L


def _cuda_weights(lp: dict, dt, transposes: bool) -> dict:
    """Weights in the compute dtype (plus, for the CUDA-core backward, the
    transposes it reads), biases fp32, all contiguous."""
    w = {k: lp[k].to(dt if k.startswith("w") else torch.float32).contiguous()
         for k in LAYER_KEYS}
    if transposes:
        for k, t in (("w_cur", "wcT"), ("w_prev", "wpT"), ("w_res", "wrT"),
                     ("w_skip", "wsT")):
            w[t] = w[k].transpose(1, 2).contiguous()
    return w


def train_stack_fwd(lp: dict, h0: torch.Tensor, dils, dt, tapcat: bool):
    """Forward kernels on the card: (skip, z_all, x_all) as the plain
    version returns them. L + 1 launches."""
    dev = h0.device
    b, t, c, g, s, L = _check_shapes(lp, h0, dt)
    if len(dils) != L or h0.dtype != torch.float32:
        raise ValueError("h0 must be fp32 and the dilations one per layer")
    lib = build.load("train_stack")
    tc = _route(lib, c, g, s, dt)
    w = _cuda_weights(lp, dt, transposes=False)
    h0 = h0.contiguous()
    x_all = torch.empty((L, b, t, c), dtype=torch.float32, device=dev)
    z_all = torch.empty((L, b, t, g), dtype=dt, device=dev)
    skip = torch.empty((b, t, s), dtype=torch.float32, device=dev)
    dil = (ctypes.c_int * L)(*dils)
    args = _FwdArgs(
        h0.data_ptr(), x_all.data_ptr(), z_all.data_ptr(), skip.data_ptr(),
        *(w[k].data_ptr() for k in LAYER_KEYS), ctypes.addressof(dil),
        b, t, L, c, g, s, int(dt == torch.bfloat16), int(tapcat), int(tc),
    )
    train_stack_fwd.launches += build.launch(lib, "wn_train_stack_fwd", args, dev)
    return skip, z_all, x_all


train_stack_fwd.launches = 0


def wgrad_chunks(n_pos: int) -> int:
    """Position chunks of the weight-gradient reduction (fixed per shape,
    so the summation order is too)."""
    return max(1, min(64, -(-n_pos // 2048)))


def train_stack_bwd(lp: dict, dils, dt, tapcat: bool, z_all, x_all, g_skip):
    """Backward kernels on the card: (dh0, {layer key: grad}) as the plain
    version returns them. 2 L + 3 launches on the tensor-core route, 3 L + 1
    on the CUDA-core one."""
    dev = x_all.device
    L, b, t, c = x_all.shape
    g = z_all.shape[-1]
    s = g_skip.shape[-1]
    lib = build.load("train_stack")
    tc = _route(lib, c, g, s, dt)
    w = _cuda_weights(lp, dt, transposes=not tc)
    g_skip = g_skip.to(torch.float32).contiguous()
    nw = 2 * c * 2 * g + 2 * g + g * c + c + g * s + s
    dx = torch.empty((2, b, t, c), dtype=torch.float32, device=dev)
    grads = torch.empty((L, nw), dtype=torch.float32, device=dev)
    dil = (ctypes.c_int * L)(*dils)
    if tc:
        # One gradient slot per block of the layer pass (one block per SM, at
        # most one per tile), and position chunks of the db_skip sum.
        tiles = b * -(-t // TC_TILE)
        chunks = min(tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
        s_chunks = max(1, min(256, -(-b * t // 512)))
        gs = torch.empty((b, t, s), dtype=torch.bfloat16, device=dev)
        dpre = torch.empty((b, t, 2 * g), dtype=torch.bfloat16, device=dev)
        partial = torch.empty((L, chunks, nw), dtype=torch.float32, device=dev)
        part_s = torch.empty((s_chunks, s), dtype=torch.float32, device=dev)
        dbs = torch.empty((s,), dtype=torch.float32, device=dev)
        ptr = build.ptr
        args = _BwdTcArgs(
            ptr(x_all), ptr(z_all), ptr(g_skip), ptr(gs), ptr(dx), ptr(dpre), ptr(partial),
            ptr(grads), ptr(part_s), ptr(dbs),
            *(ptr(w[k]) for k in ("w_cur", "w_prev", "b", "w_res", "w_skip")),
            ctypes.addressof(dil), b, t, L, c, g, s, int(tapcat), chunks, s_chunks,
        )
        train_stack_bwd.launches += build.launch(lib, "wn_train_stack_bwd_tc", args, dev)
    else:
        chunks = wgrad_chunks(b * t)
        dpre = torch.empty((b, t, 2 * g), dtype=torch.float32, device=dev)
        partial = torch.empty((L, chunks, nw), dtype=torch.float32, device=dev)
        args = _BwdArgs(
            x_all.data_ptr(), z_all.data_ptr(), g_skip.data_ptr(), dx.data_ptr(),
            dpre.data_ptr(), partial.data_ptr(), grads.data_ptr(),
            w["w_cur"].data_ptr(), w["w_prev"].data_ptr(), w["b"].data_ptr(),
            w["wcT"].data_ptr(), w["wpT"].data_ptr(), w["wrT"].data_ptr(),
            w["wsT"].data_ptr(), ctypes.addressof(dil),
            b, t, L, c, g, s, int(dt == torch.bfloat16), int(tapcat), chunks,
        )
        train_stack_bwd.launches += build.launch(lib, "wn_train_stack_bwd", args, dev)
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
