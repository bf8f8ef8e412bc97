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
(`tc_mm`) and each weight and bias gradient as the backward layer pass
sums it (per tile, per block slot), so kernel and plain version agree bit
for bit in z, x, skip, dh0 and every gradient. A CPU tensor takes the
plain version; a CUDA tensor launches the kernels or raises.

Conditioning (the TPU kernels' `has_cond`): cond (B, T, Cc') fp32, the
upsampled mel and/or the speaker rows, against w_cond (L, Cc', 2G) (the
fold [w_cond ; w_gcond] with both), enters every layer's gate; the
backward returns d cond and d w_cond. On the tensor-core route cond's
k-steps extend the gate product; elsewhere cond w_cond is added after the
bias, the JAX order (`_pre`). No extra launch on either route.

The sequence-parallel halo mask (the TPU kernels' `has_mask`, m (B, T) 0/1
fp32, parallel/halo.py): x_{l+1} = ((x_l + z w_res) + b_res) * m, so masked
rows of the residual stream stay exactly 0; the backward takes dx_{l+1} * m
(in dz, d w_res, d b_res and dx_l) and returns dh0 unmasked; the mask gets
no gradient. h0 arrives masked (the masked frontend's output, the TPU
kernels' contract), so x_all's masked rows are 0 at every layer and the
TPU backward's re-mask of the reconstructed layer input is the identity
here. No extra launch on either route; conditioned or not.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ...config import ArchConfig
from ..numerics import compute_dtype, rnd, shift_right
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


def default_order(device, c: int, g: int, s: int, dt, cc: int = 0) -> bool:
    """Whether the plain versions sum as the tensor-core route does: on a
    CUDA tensor (where they are the kernels' reference) on that route. A
    bf16 stack of 30 layers carries any other order's rounding flips of z
    and x from layer to layer (a few 1e-2 of a gradient leaf at WaveNet-30);
    on the CPU one fp32 sum per product is several times cheaper."""
    return torch.device(device).type == "cuda" and route(c, g, s, dt, cc) == "tensor_cores"


def _pre(xr, xsh, lp, i, dt, tapcat, mm, cr=None, tc=False):
    """Gate pre-activation from rounded x(t), x(t - d) and, conditioned, the
    rounded cond rows cr. In the tensor-core order (tc) cond's k-steps
    continue the tap's chain before the bias: [x | x(t-d) | cond] @ [w_cur ;
    w_prev ; w_cond] with tapcat, else x @ w_cur + [x(t-d) | cond] @ [w_prev
    ; w_cond]; otherwise the JAX order, cond @ w_cond after the bias."""
    wc, wp = rnd(lp["w_cur"][i], dt), rnd(lp["w_prev"][i], dt)
    if cr is not None and tc:
        wcd = rnd(lp["w_cond"][i], dt)
        if tapcat:
            return mm(torch.cat([xr, xsh, cr], -1), torch.cat([wc, wp, wcd], 0)) + lp["b"][i]
        return (mm(xr, wc) + mm(torch.cat([xsh, cr], -1), torch.cat([wp, wcd], 0))) + lp["b"][i]
    if tapcat:
        pre = mm(torch.cat([xr, xsh], -1), torch.cat([wc, wp], 0)) + lp["b"][i]
    else:
        pre = (mm(xr, wc) + mm(xsh, wp)) + lp["b"][i]
    if cr is not None:
        pre = pre + mm(cr, rnd(lp["w_cond"][i], dt))
    return pre


def _order(lp: dict, device, dt, cond) -> bool:
    """default_order at the widths of the layer weights and the
    conditioning (Cc' = 0 without)."""
    c, g, s = lp["w_cur"].shape[1], lp["w_cur"].shape[2] // 2, lp["w_skip"].shape[2]
    return default_order(device, c, g, s, dt, 0 if cond is None else cond.shape[-1])


def stack_fwd_plain(lp: dict, h0: torch.Tensor, dils, dt, tapcat: bool,
                    tensor_cores: Optional[bool] = None, cond=None, mask=None):
    """PyTorch version of the forward kernels: (skip (B, T, S) fp32,
    z_all (L, B, T, G) compute dtype, x_all (L, B, T, C) fp32). With
    tensor_cores (default: `default_order`) each product is summed as the
    tensor-core route sums it (tc_mm), else in one fp32 product. `cond`
    (B, T, Cc') fp32 (or None) enters every layer's gate against
    lp["w_cond"] (L, Cc', 2G), as `_pre` orders it. The halo `mask` (B, T)
    (or None) multiplies each layer's residual output."""
    if tensor_cores is None:
        tensor_cores = _order(lp, h0.device, dt, cond)
    mm = tc_mm if tensor_cores else torch.matmul
    g = lp["w_cur"].shape[-1] // 2
    cr = None if cond is None else rnd(cond, dt)
    x, xs, zs, skip = h0, [], [], None
    for i, d in enumerate(dils):
        xs.append(x)
        xr = rnd(x, dt)
        pre = _pre(xr, shift_right(xr, d), lp, i, dt, tapcat, mm, cr, tensor_cores)
        z = (torch.tanh(pre[..., :g]) * torch.sigmoid(pre[..., g:])).to(dt)
        zs.append(z)
        zf = z.float()
        x = (x + mm(zf, rnd(lp["w_res"][i], dt))) + lp["b_res"][i]
        if mask is not None:
            x = x * mask[..., None]
        contrib = mm(zf, rnd(lp["w_skip"][i], dt)) + lp["b_skip"][i]
        skip = contrib if skip is None else skip + contrib
    return skip, torch.stack(zs), torch.stack(xs)


# ---- the tensor-core route's order of the weight and bias gradients --------

def tc_slots(b: int, t: int, device) -> int:
    """Blocks of the tensor-core backward layer pass (one gradient slot
    each): one per SM, at most one per tile. On the CPU the H100's 132 SMs,
    so that the CPU tests model the card's order."""
    tiles = b * -(-t // TC_TILE)
    dev = torch.device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if (
        dev.type == "cuda") else 132
    return min(tiles, sms)


def _tiles(x: torch.Tensor) -> torch.Tensor:
    """(B, T, K) -> (B * ceil(T / TC_TILE), TC_TILE, K): the layer pass's
    position tiles, rows past T zero."""
    b, t, k = x.shape
    per = -(-t // TC_TILE)
    x = torch.nn.functional.pad(x, (0, 0, 0, per * TC_TILE - t))
    return x.reshape(b * per, TC_TILE, k)


def _slot_sum(parts: torch.Tensor, chunks: int) -> torch.Tensor:
    """parts (tiles, ...) as the layer pass and reduce_tc add them: block i
    adds its tiles i, i + chunks, ... in order into its slot (the first
    stores), then the slots are added in block order from zero."""
    n = parts.shape[0]
    rounds = -(-n // chunks)
    pad = parts.new_zeros((rounds * chunks - n,) + parts.shape[1:])
    p = torch.cat([parts, pad]).reshape((rounds, chunks) + parts.shape[1:])
    slot = p[0]
    for r in range(1, rounds):
        slot = slot + p[r]
    out = torch.zeros_like(slot[0])
    for c in range(chunks):
        out = out + slot[c]
    return out


def _tc_outer(a: torch.Tensor, bm: torch.Tensor, chunks: int) -> torch.Tensor:
    """a (B, T, M)^T @ bm (B, T, N), both holding bf16 values, summed as the
    layer pass sums a weight gradient (`wgrad_item`): per tile of TC_TILE
    positions one mma from zero per 16 positions, added in order
    (ar_tc.tc_sum16), then the tiles by _slot_sum. In float64, in tile
    chunks of about 2 GB of temporaries."""
    at, bt = _tiles(a), _tiles(bm)
    n, _, m = at.shape
    k = bt.shape[-1]
    ks = TC_TILE // 16
    out = torch.empty((n, m, k), dtype=torch.float32, device=a.device)
    step = max(1, (2 << 30) // (m * k * TC_TILE * 8 * 5))
    for i in range(0, n, step):
        j = min(n, i + step)
        s = ar_tc.tc_sum16(at[i:j].reshape((j - i) * ks, 16, m).permute(2, 0, 1),
                           bt[i:j].reshape((j - i) * ks, 16, k))
        s = s.reshape(m, j - i, ks, k)
        acc = s[:, :, 0]
        for q in range(1, ks):
            acc = acc + s[:, :, q]
        out[i:j] = acc.permute(1, 0, 2)
    return _slot_sum(out, chunks)


def _tc_db(dpre: torch.Tensor, chunks: int) -> torch.Tensor:
    """colsum of the unrounded dpre (B, T, 2G) as the layer pass sums it:
    per 16-row strip rows g and g + 8 first, then the warp's butterfly over
    g (pairs, quads, halves), the tile's four strips in order, then the
    tiles by _slot_sum."""
    x = _tiles(dpre)
    x = x.reshape(x.shape[0], TC_TILE // 16, 16, x.shape[-1])
    v = x[:, :, :8] + x[:, :, 8:]
    while v.shape[2] > 1:
        v = v[:, :, 0::2] + v[:, :, 1::2]
    v = v[:, :, 0]
    s = v[:, 0]
    for r in range(1, v.shape[1]):
        s = s + v[:, r]
    return _slot_sum(s, chunks)


def _tc_dbr(dx: torch.Tensor, chunks: int) -> torch.Tensor:
    """colsum of dx_{l+1} (B, T, C) as the layer pass sums it: each tile's
    rows in order from zero, then the tiles by _slot_sum."""
    x = _tiles(dx)
    s = torch.zeros_like(x[:, 0])
    for r in range(TC_TILE):
        s = s + x[:, r]
    return _slot_sum(s, chunks)


def _tc_dbs(g_skip: torch.Tensor) -> torch.Tensor:
    """colsum of g_skip (B, T, S) as `gskip_prep` and `reduce_partials` sum
    it: s_chunks position chunks, each in position order from zero, then the
    chunks in order from zero."""
    s = g_skip.shape[-1]
    rows = g_skip.reshape(-1, s)
    n = rows.shape[0]
    n_chunks = max(1, min(256, -(-n // 512)))
    chunk = -(-n // n_chunks)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, n_chunks * chunk - n))
    rows = rows.reshape(n_chunks, chunk, s)
    part = torch.zeros_like(rows[:, 0])
    for p in range(chunk):
        part = part + rows[:, p]
    out = torch.zeros_like(part[0])
    for c in range(n_chunks):
        out = out + part[c]
    return out


def stack_bwd_plain(lp: dict, dils, dt, tapcat: bool, z_all, x_all, g_skip,
                    tensor_cores: Optional[bool] = None, cond=None, mask=None):
    """PyTorch version of the backward kernels: (dh0, {layer key: grad}),
    with cond (as stack_fwd_plain's) also {"w_cond": d w_cond (L, Cc', 2G),
    "cond": d cond (B, T, Cc'), summed over the layers in reverse}.
    tensor_cores as in stack_fwd_plain; in that order the weight and bias
    gradients are summed as the tensor-core layer pass sums them too (per
    tile, per block slot, the slots in order: `_tc_outer`, `_tc_db`,
    `_tc_dbr`, `_tc_dbs`), so every gradient agrees bit for bit with the
    kernels; otherwise one fp32 sum each. With the halo `mask`, each layer
    takes dx_{l+1} * mask (dh0 is returned unmasked)."""
    if tensor_cores is None:
        tensor_cores = _order(lp, x_all.device, dt, cond)
    mm = tc_mm if tensor_cores else torch.matmul
    g = lp["w_cur"].shape[-1] // 2
    L, b, t, c = x_all.shape
    chunks = tc_slots(b, t, x_all.device) if tensor_cores else 0
    dbs = _tc_dbs(g_skip) if tensor_cores else g_skip.sum((0, 1))
    gs = rnd(g_skip, dt)
    cr = None if cond is None else rnd(cond, dt)
    dcond = None if cond is None else torch.zeros_like(cond, dtype=torch.float32)
    dx = torch.zeros_like(x_all[0])
    keys = LAYER_KEYS + (() if cond is None else ("w_cond",))
    out = {k: [None] * len(dils) for k in keys}
    for i in reversed(range(len(dils))):
        d = dils[i]
        if mask is not None:
            dx = dx * mask[..., None]
        xr = rnd(x_all[i], dt)
        xsh = shift_right(xr, d)
        z = z_all[i].float()
        pre = _pre(xr, xsh, lp, i, dt, tapcat, mm, cr, tensor_cores)
        th, sg = torch.tanh(pre[..., :g]), torch.sigmoid(pre[..., g:])
        dxr = rnd(dx, dt)
        dz = mm(gs, rnd(lp["w_skip"][i], dt).T) + mm(dxr, rnd(lp["w_res"][i], dt).T)
        dpre = torch.cat([dz * sg * (1.0 - th * th), dz * th * sg * (1.0 - sg)], -1)
        dpr = rnd(dpre, dt)
        proj_p = mm(dpr, rnd(lp["w_prev"][i], dt).T)
        dx_new = (dx + mm(dpr, rnd(lp["w_cur"][i], dt).T)) + _shift_left(proj_p, d)
        if cond is not None:
            dcond = dcond + mm(dpr, rnd(lp["w_cond"][i], dt).T)
        if tensor_cores:
            taps = [xr, xsh] + ([] if cond is None else [cr])
            dw = _tc_outer(torch.cat(taps, -1), dpr, chunks)
            out["w_cur"][i], out["w_prev"][i] = dw[:c], dw[c:2 * c]
            if cond is not None:
                out["w_cond"][i] = dw[2 * c:]
            out["b"][i] = _tc_db(dpre, chunks)
            out["w_res"][i] = _tc_outer(z, dxr, chunks)
            out["b_res"][i] = _tc_dbr(dx, chunks)
            out["w_skip"][i] = _tc_outer(z, gs, chunks)
        else:
            out["w_cur"][i] = torch.einsum("btc,btn->cn", xr, dpr)
            out["w_prev"][i] = torch.einsum("btc,btn->cn", xsh, dpr)
            if cond is not None:
                out["w_cond"][i] = torch.einsum("btc,btn->cn", cr, dpr)
            out["b"][i] = dpre.sum((0, 1))
            out["w_res"][i] = torch.einsum("btg,btc->gc", z, dxr)
            out["b_res"][i] = dx.sum((0, 1))
            out["w_skip"][i] = torch.einsum("btg,bts->gs", z, gs)
        out["b_skip"][i] = dbs
        dx = dx_new
    grads = {k: torch.stack(v) for k, v in out.items()}
    if cond is not None:
        grads["cond"] = dcond
    return dx, grads


class _FwdArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "h0", "x_all", "z_all", "skip", "w_cur", "w_prev", "b", "w_res",
        "b_res", "w_skip", "b_skip", "dils",
    )] + [(n, ctypes.c_int) for n in ("B", "T", "L", "C", "G", "S", "bf16", "tapcat", "tc")] + [
        (n, ctypes.c_void_p) for n in ("cond", "w_cond")] + [("Cc", ctypes.c_int),
                                                            ("mask", ctypes.c_void_p)]


class _BwdArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x_all", "z_all", "g_skip", "dx", "dpre", "partial", "grads", "w_cur",
        "w_prev", "b", "wcT", "wpT", "wrT", "wsT", "dils",
    )] + [(n, ctypes.c_int) for n in (
        "B", "T", "L", "C", "G", "S", "bf16", "tapcat", "chunks")] + [
        (n, ctypes.c_void_p) for n in ("cond", "w_cond", "wcdT", "dcond")] + [
        ("Cc", ctypes.c_int), ("mask", ctypes.c_void_p)]


class _BwdTcArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x_all", "z_all", "g_skip", "gs", "dx", "dpre", "partial", "grads", "part_s",
        "dbs", "w_cur", "w_prev", "b", "w_res", "w_skip", "dils",
    )] + [(n, ctypes.c_int) for n in (
        "B", "T", "L", "C", "G", "S", "tapcat", "chunks", "s_chunks")] + [
        (n, ctypes.c_void_p) for n in ("cond", "w_cond", "dcond")] + [
        ("Cc", ctypes.c_int), ("mask", ctypes.c_void_p)]


# Tensor-core route (csrc/train_stack.cu, namespace tsc): positions per tile,
# row padding, skip columns per pass of the backward layer pass, positions
# and columns of a skip-pass item and the layers it stages ahead, and the
# shared memory a block may use on an H100 (227 KB).
TC_TILE, TC_PAD, TC_SKIP_COLS = 64, 8, 256
TC_SKIP_TILE, TC_SKIP_STAGES, TC_SMEM_MAX = 128, 3, 232448


def tc_smem(c: int, g: int, s: int, cc: int = 0) -> int:
    """Bytes of dynamic shared memory of the largest tensor-core kernel, as
    csrc/train_stack.cu carves them (its `wn_train_stack_tc_smem` must agree:
    `_route` checks it before a launch). The skip pass and the backward layer
    pass take S in passes of TC_SKIP_TILE and TC_SKIP_COLS columns, so S
    beyond those adds only the backward's fp32 tile of dz over the passes.
    `cc`: conditioning channels (0: unconditioned), which add w_cond's rows
    to the staged gate weights and a cond tile's columns to the tap tile of
    the forward and backward layer passes."""
    tp, pad, ts = TC_TILE, TC_PAD, TC_SKIP_TILE
    sc = min(s, TC_SKIP_COLS)
    k = 2 * c + cc
    fwd = 2 * (k * (2 * g + pad) + g * (c + pad) + tp * (k + pad) + tp * (g + pad))
    skip = TC_SKIP_STAGES * (2 * (g * (min(s, ts) + pad) + ts * (g + pad)) + 4 * min(s, ts))
    bwd = (2 * (k * (2 * g + pad) + g * (c + pad) + g * (sc + pad)
                + tp * (k + g + c + sc + 2 * g + 5 * pad))
           + 4 * (tp * (c + (g if s > TC_SKIP_COLS else 0)) + tp // 16 * 2 * g + 2 * g + c))
    dx = 2 * (2 * c * (2 * g + pad) + 2 * tp * (2 * g + pad))
    return max(fwd, skip, bwd, dx)


def route(c: int, g: int, s: int, dt, cc: int = 0) -> str:
    """Which kernels run the stack, decided before launch from the compute
    dtype and widths (and `cc` conditioning channels, 0: unconditioned):
    "tensor_cores" for bf16 with C, G, S and cc multiples of 16 whose tiles
    fit in a block's shared memory (any such S); "cuda_cores" (the
    first-version fp32-FMA kernels) for fp32, where tensor cores (TF32)
    would change the function, and for any other bf16 width."""
    if (dt == torch.bfloat16 and not (c % 16 or g % 16 or s % 16 or cc % 16)
            and tc_smem(c, g, s, cc) <= TC_SMEM_MAX):
        return "tensor_cores"
    return "cuda_cores"


def lib_tc_smem(lib, c: int, g: int, s: int, cc: int = 0) -> int:
    """The built library's own count of tc_smem's bytes."""
    f = build.entry(lib, "wn_train_stack_tc_smem", [ctypes.c_int] * 4, ctypes.c_longlong)
    return int(f(c, g, s, cc))


def _route(lib, c: int, g: int, s: int, dt, cc: int = 0) -> bool:
    """route() on the card: whether the tensor-core kernels run, after
    checking that the library carves shared memory as tc_smem reckons it
    (else a shape could be sent to the wrong route)."""
    got, want = lib_tc_smem(lib, c, g, s, cc), tc_smem(c, g, s, cc)
    if got != want:
        raise RuntimeError(
            f"csrc/train_stack.cu carves {got} bytes of shared memory at C={c}, G={g}, "
            f"S={s}, Cc={cc}; train_stack.tc_smem reckons {want}")
    return route(c, g, s, dt, cc) == "tensor_cores"


def _mask_operand(mask, b: int, t: int, device):
    """The halo mask as the kernels read it: (B, T) fp32, contiguous (or
    None)."""
    if mask is None:
        return None
    if mask.shape != (b, t) or mask.device != device:
        raise ValueError(f"mask {tuple(mask.shape)} on {mask.device} must be {(b, t)} "
                         f"on {device}")
    return mask.to(torch.float32).contiguous()


def _check_shapes(lp: dict, h0: torch.Tensor, dt, cond=None):
    b, t, c = h0.shape
    L, c2, two_g = lp["w_cur"].shape
    s = lp["w_skip"].shape[-1]
    g = two_g // 2
    if c2 != c or lp["w_res"].shape != (L, g, c) or lp["w_skip"].shape != (L, g, s):
        raise ValueError("layer weights do not match h0's channels")
    cc = 0
    if cond is not None:
        cc = cond.shape[-1]
        if cond.shape != (b, t, cc) or lp["w_cond"].shape != (L, cc, two_g):
            raise ValueError(f"cond {tuple(cond.shape)} and w_cond "
                             f"{tuple(lp['w_cond'].shape)} do not match h0 {tuple(h0.shape)}")
    if route(c, g, s, dt, cc) == "cuda_cores" and (c % 4 or g % 4 or s % 4 or cc % 4
                                                   or s > 512):
        raise ValueError(f"the CUDA-core stack needs C, G, S, Cc divisible by 4 and S <= 512 "
                         f"(got C={c}, G={g}, S={s}, Cc={cc}, {dt})")
    return b, t, c, g, s, L, cc


def _cuda_weights(lp: dict, dt, transposes: bool) -> dict:
    """Weights in the compute dtype (plus, for the CUDA-core backward, the
    transposes it reads), biases fp32, all contiguous; w_cond too when lp
    holds it."""
    keys = LAYER_KEYS + (("w_cond",) if "w_cond" in lp else ())
    w = {k: lp[k].to(dt if k.startswith("w") else torch.float32).contiguous() for k in keys}
    if transposes:
        for k, t in (("w_cur", "wcT"), ("w_prev", "wpT"), ("w_res", "wrT"),
                     ("w_skip", "wsT"), ("w_cond", "wcdT")):
            if k in w:
                w[t] = w[k].transpose(1, 2).contiguous()
    return w


def _cond_operand(cond, dt, tc: bool):
    """cond as the kernels read it: bf16 rows for the tensor-core route
    (16-byte copies, rounded here), fp32 for the CUDA-core one (rounded
    as staged)."""
    if cond is None:
        return None
    return cond.to(torch.bfloat16 if tc else torch.float32).contiguous()


def train_stack_fwd(lp: dict, h0: torch.Tensor, dils, dt, tapcat: bool, cond=None,
                    mask=None):
    """Forward kernels on the card: (skip, z_all, x_all) as the plain
    version returns them. L + 1 launches, conditioned or not, masked or
    not."""
    dev = h0.device
    b, t, c, g, s, L, cc = _check_shapes(lp, h0, dt, cond)
    msk = _mask_operand(mask, b, t, dev)
    if len(dils) != L or h0.dtype != torch.float32:
        raise ValueError("h0 must be fp32 and the dilations one per layer")
    lib = build.load("train_stack")
    tc = _route(lib, c, g, s, dt, cc)
    w = _cuda_weights(lp if cond is not None else {k: lp[k] for k in LAYER_KEYS}, dt,
                      transposes=False)
    cnd = _cond_operand(cond, dt, tc)
    h0 = h0.contiguous()
    x_all = torch.empty((L, b, t, c), dtype=torch.float32, device=dev)
    z_all = torch.empty((L, b, t, g), dtype=dt, device=dev)
    skip = torch.empty((b, t, s), dtype=torch.float32, device=dev)
    dil = (ctypes.c_int * L)(*dils)
    args = _FwdArgs(
        h0.data_ptr(), x_all.data_ptr(), z_all.data_ptr(), skip.data_ptr(),
        *(w[k].data_ptr() for k in LAYER_KEYS), ctypes.addressof(dil),
        b, t, L, c, g, s, int(dt == torch.bfloat16), int(tapcat), int(tc),
        build.ptr(cnd), build.ptr(w.get("w_cond")), cc, build.ptr(msk),
    )
    n = build.launch(lib, "wn_train_stack_fwd", args, dev)
    train_stack_fwd.launches += n
    if cond is not None:
        train_stack_fwd.cond_launches += n
    if mask is not None:
        train_stack_fwd.mask_launches += n
    return skip, z_all, x_all


# Kernel launches of the forward, and of those the conditioned and the masked ones.
train_stack_fwd.launches = train_stack_fwd.cond_launches = train_stack_fwd.mask_launches = 0


def wgrad_chunks(n_pos: int) -> int:
    """Position chunks of the weight-gradient reduction (fixed per shape,
    so the summation order is too)."""
    return max(1, min(64, -(-n_pos // 2048)))


def grad_pack(c: int, g: int, s: int, cc: int = 0) -> list:
    """[(key, shape)] of a layer's row of the kernels' gradient pack, in
    order: d w_cur | d w_prev | d w_cond (conditioned) | d b | d w_res |
    d b_res | d w_skip | d b_skip (the tensor-core pass takes [w_cur ;
    w_prev ; w_cond]'s gradient as one (2C + Cc') x 2G product)."""
    return ([("w_cur", (c, 2 * g)), ("w_prev", (c, 2 * g))]
            + ([("w_cond", (cc, 2 * g))] if cc else [])
            + [("b", (2 * g,)), ("w_res", (g, c)), ("b_res", (c,)), ("w_skip", (g, s)),
               ("b_skip", (s,))])


def train_stack_bwd(lp: dict, dils, dt, tapcat: bool, z_all, x_all, g_skip, cond=None,
                    mask=None):
    """Backward kernels on the card: (dh0, {layer key: grad}) as the plain
    version returns them (with cond, "w_cond" and "cond" too). 2 L + 3
    launches on the tensor-core route, 3 L + 1 on the CUDA-core one,
    conditioned or not, masked or not: d cond (B, T, Cc') fp32 is added to
    by each layer's pass (tensor cores) or its dx launch (CUDA cores); the
    halo mask multiplies each layer's dx output but the first's."""
    dev = x_all.device
    L, b, t, c = x_all.shape
    msk = _mask_operand(mask, b, t, dev)
    g = z_all.shape[-1]
    s = g_skip.shape[-1]
    cc = 0 if cond is None else cond.shape[-1]
    lib = build.load("train_stack")
    tc = _route(lib, c, g, s, dt, cc)
    w = _cuda_weights(lp if cond is not None else {k: lp[k] for k in LAYER_KEYS}, dt,
                      transposes=not tc)
    cnd = _cond_operand(cond, dt, tc)
    dcond = None if cond is None else torch.empty((b, t, cc), dtype=torch.float32, device=dev)
    g_skip = g_skip.to(torch.float32).contiguous()
    pack = grad_pack(c, g, s, cc)
    nw = sum(math.prod(sh) for _, sh in pack)
    dx = torch.empty((2, b, t, c), dtype=torch.float32, device=dev)
    grads = torch.empty((L, nw), dtype=torch.float32, device=dev)
    dil = (ctypes.c_int * L)(*dils)
    ptr = build.ptr
    if tc:
        # One gradient slot per block of the layer pass (one block per SM, at
        # most one per tile), and position chunks of the db_skip sum.
        chunks = tc_slots(b, t, dev)
        s_chunks = max(1, min(256, -(-b * t // 512)))
        gs = torch.empty((b, t, s), dtype=torch.bfloat16, device=dev)
        dpre = torch.empty((b, t, 2 * g), dtype=torch.bfloat16, device=dev)
        partial = torch.empty((L, chunks, nw), dtype=torch.float32, device=dev)
        part_s = torch.empty((s_chunks, s), dtype=torch.float32, device=dev)
        dbs = torch.empty((s,), dtype=torch.float32, device=dev)
        args = _BwdTcArgs(
            ptr(x_all), ptr(z_all), ptr(g_skip), ptr(gs), ptr(dx), ptr(dpre), ptr(partial),
            ptr(grads), ptr(part_s), ptr(dbs),
            *(ptr(w[k]) for k in ("w_cur", "w_prev", "b", "w_res", "w_skip")),
            ctypes.addressof(dil), b, t, L, c, g, s, int(tapcat), chunks, s_chunks,
            ptr(cnd), ptr(w.get("w_cond")), ptr(dcond), cc, ptr(msk),
        )
        n = build.launch(lib, "wn_train_stack_bwd_tc", args, dev)
    else:
        chunks = wgrad_chunks(b * t)
        dpre = torch.empty((b, t, 2 * g), dtype=torch.float32, device=dev)
        partial = torch.empty((L, chunks, nw), dtype=torch.float32, device=dev)
        args = _BwdArgs(
            ptr(x_all), ptr(z_all), ptr(g_skip), ptr(dx), ptr(dpre), ptr(partial), ptr(grads),
            *(ptr(w[k]) for k in ("w_cur", "w_prev", "b", "wcT", "wpT", "wrT", "wsT")),
            ctypes.addressof(dil), b, t, L, c, g, s, int(dt == torch.bfloat16), int(tapcat),
            chunks, ptr(cnd), ptr(w.get("w_cond")), ptr(w.get("wcdT")), ptr(dcond), cc,
            ptr(msk),
        )
        n = build.launch(lib, "wn_train_stack_bwd", args, dev)
    train_stack_bwd.launches += n
    if cond is not None:
        train_stack_bwd.cond_launches += n
    if mask is not None:
        train_stack_bwd.mask_launches += n
    parts = torch.split(grads, [math.prod(sh) for _, sh in pack], dim=1)
    out = {k: p.reshape((L,) + sh) for (k, sh), p in zip(pack, parts)}
    if cond is not None:
        out["cond"] = dcond
    return dx[L % 2], out


# Kernel launches of the backward, and of those the conditioned and the masked ones.
train_stack_bwd.launches = train_stack_bwd.cond_launches = train_stack_bwd.mask_launches = 0


class _Stack(torch.autograd.Function):
    """skip = stack(lp, h0[, cond][, mask]); the backward is the
    hand-written one. With cond, the last weight is w_cond; the mask gets
    no gradient."""

    @staticmethod
    def forward(ctx, dils, dt, tapcat, h0, cond, mask, *weights):
        keys = LAYER_KEYS + (() if cond is None else ("w_cond",))
        lp = dict(zip(keys, weights))
        kw = dict(cond=cond, mask=mask)
        if build.on_card(h0.device, "the training stack"):
            skip, z_all, x_all = train_stack_fwd(lp, h0, dils, dt, tapcat, **kw)
        else:
            skip, z_all, x_all = stack_fwd_plain(lp, h0, dils, dt, tapcat, **kw)
        ctx.cfg = (dils, dt, tapcat, keys)
        ctx.save_for_backward(z_all, x_all, cond, mask, *weights)
        return skip

    @staticmethod
    def backward(ctx, g_skip):
        dils, dt, tapcat, keys = ctx.cfg
        z_all, x_all, cond, mask, *weights = ctx.saved_tensors
        lp = dict(zip(keys, weights))
        bwd = train_stack_bwd if x_all.device.type == "cuda" else stack_bwd_plain
        dh0, grads = bwd(lp, dils, dt, tapcat, z_all, x_all, g_skip, cond=cond, mask=mask)
        return (None, None, None, dh0, grads.get("cond"), None, *(grads[k] for k in keys))


def make_fused_stack(arch: ArchConfig, has_cond: bool = False, tapcat: bool = False,
                     has_mask: bool = False):
    """fn(lp, h0[, cond][, mask]) -> skip_sum (B, T, S) fp32 over the layers
    dict `lp` (w_cur, w_prev, b, w_res, b_res, w_skip, b_skip, and w_cond
    (L, Cc', 2G) with has_cond) and h0 (B, T, C) fp32, differentiable in
    every input but the mask. `tapcat` sums the two taps as one 2C-deep
    contraction (the order of the TPU kernel's tap concat). With has_cond,
    `cond` (B, T, Cc') fp32 is the upsampled (and/or speaker) conditioning:
    each layer adds cond @ w_cond[l] to its gate pre-activation, and the
    backward returns d cond and d w_cond. With has_mask, `mask` (B, T) 0/1
    is the sequence-parallel halo mask: masked rows of the residual stream
    stay exactly 0 through the stack (h0 must arrive masked, as the masked
    frontend gives it); an all-ones mask gives the unmasked stack's
    bits."""
    dils = tuple(arch.dilations)
    dt = compute_dtype(arch)

    def fused(lp: dict, h0: torch.Tensor, *rest) -> torch.Tensor:
        if len(rest) != int(has_cond) + int(has_mask):
            raise ValueError(f"this stack was built with has_cond={has_cond}, "
                             f"has_mask={has_mask}: it takes lp, h0"
                             f"{', cond' if has_cond else ''}{', mask' if has_mask else ''}")
        cond = rest[0] if has_cond else None
        mask = rest[-1].detach().to(torch.float32) if has_mask else None
        keys = LAYER_KEYS + (("w_cond",) if has_cond else ())
        return _Stack.apply(dils, dt, bool(tapcat), h0, cond, mask, *(lp[k] for k in keys))

    return fused
