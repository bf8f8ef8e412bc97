"""The input frontend of the training step: embedding lookup + width-K causal
input conv, forward and a hand-written backward (CUDA kernels
`csrc/frontend.cu`), as one `torch.autograd.Function`.

Replaces `lb_wavenet_tpu/ops/pallas/frontend.py` (`fused_frontend`, its
`_fwd_kernel` and `_bwd_kernel`). The TPU kernels write the gather as a
one-hot MXU contraction. Here the forward computes the per-class tap table
P[k] = rnd(embed) @ rnd(w[k]) once and gathers from it; the backward regroups
the weight gradients by class (d_w[k] = embed^T G[k], G[k] the scatter of dh
rows by the class of their tap) and, on the tensor-core route, keeps d_e and
the scatter tables on chip (design and bound: the note at the top of
`csrc/frontend.cu`).

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

The sequence-parallel halo mask (the TPU kernels' `input_mask`, m (B, T)
0/1 fp32, parallel/halo.py): JAX multiplies the embedded rows by m and h0's
rows by m after the bias, and the mask gets no gradient. Here a masked
position's class counts as invalid (a zero embedding row: e * m for a 0/1
mask), h0 = (b + taps) * m, and the backward takes dh * m, so masked
positions scatter nothing into d_embed and add nothing to d_w. Same
launches, kernel and plain version alike (`masked_classes`).

Two routes of the backward, chosen before the launch from (dtype, Q, C, K)
(`route`): bf16 with C a multiple of 16 up to 64 whose tables fit in a
block's shared memory runs the tensor-core pass (3 launches); fp32 and other
shapes run the first-version kernels (4 launches). The forward takes 2 launches on either
route, its table on tensor cores on the first.

The same function runs as plain PyTorch (`frontend_fwd_plain`,
`frontend_bwd_plain`): the table and its gather, d_w through the same
regrouping. On a CUDA tensor on the tensor-core route the table and the d_e
products are summed as the tensor cores sum them (`train_stack.tc_mm`, with
dh split into bf16 hi + lo for d_e), so kernel and plain h0 agree bit for
bit; on the CPU one fp32 sum per product. A CPU tensor takes the plain
version; a CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..numerics import rnd, shift_right
from . import build
from .train_stack import _shift_left, tc_mm

MAX_TAPS = 7   # the first-version weight-gradient launch takes K outer products + 1 bias sum

# Tensor-core backward (csrc/frontend.cu, namespace ftc): positions per tile,
# bf16 row padding of the split dh tiles, the widest C (8 warps own 16 columns
# of a 16-row strip each), the (tap, k-step) B fragments a warp keeps in
# registers, the warps of the other half (one per table), and the shared
# memory a block may use on an H100 (227 KB).
TC_TILE, TC_PAD, TC_MAX_C, TC_MAX_PAIRS, TC_AUX_WARPS = 32, 8, 64, 8, 8
TC_SMEM_MAX = 232448


def tc_smem(q: int, c: int, k: int) -> int:
    """Bytes of dynamic shared memory of the tensor-core backward pass, as
    csrc/frontend.cu carves them (`ftc::Carve`; its `wn_front_tc_smem` must
    agree: `_route` checks it before a launch): the d_embed and K G tables
    (Q, C) fp32 with d_b after them; the tile's TC_TILE + K - 1 dh rows split
    into bf16 hi and lo tiles of padded rows; two fp32 landing tiles; the
    d_e tile; two rows of classes; per table the tile's group masks; the
    d_embed table's classes; two mbarriers. Each region a multiple of 16
    bytes."""
    rows = TC_TILE + k - 1
    return 4 * ((k + 1) * q * c + c + rows * (c + TC_PAD) + 2 * rows * c + TC_TILE * c
                + 2 * (-(-rows // 4) * 4) + (k + 1) * TC_TILE + TC_TILE + 4)


def route(q: int, c: int, k: int, dt) -> str:
    """Which kernels run the frontend, decided before launch from the compute
    dtype and widths: "tensor_cores" for bf16 with C a multiple of 16 up to
    TC_MAX_C, K C / 16 <= TC_MAX_PAIRS, K + 1 <= TC_AUX_WARPS, and
    backward tables and staging that fit in a block's shared memory (the
    table on tensor cores, the one-pass backward); "cuda_cores" (the table by
    fp32 FMAs, the first-version backward) for fp32, where tensor cores
    (TF32) would change the function, and for any other shape (e.g. K = 3 at
    C = 64)."""
    if (dt == torch.bfloat16 and c % 16 == 0 and c <= TC_MAX_C
            and k * (c // 16) <= TC_MAX_PAIRS and k + 1 <= TC_AUX_WARPS
            and tc_smem(q, c, k) <= TC_SMEM_MAX):
        return "tensor_cores"
    return "cuda_cores"


def default_order(device, q: int, c: int, k: int, dt) -> bool:
    """Whether the plain versions sum the table and the d_e products as the
    tensor-core route does: on a CUDA tensor (where they are the kernels'
    reference) on that route. On the CPU one fp32 sum per product is much
    cheaper than the float64 emulation."""
    return torch.device(device).type == "cuda" and route(q, c, k, dt) == "tensor_cores"


def _widths(embed: torch.Tensor, w: torch.Tensor):
    """(Q, C, K) of the frontend's parameters."""
    return embed.shape[0], embed.shape[1], w.shape[0]


def _embed_rows(embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """embed[x] (B, T, C) with zero rows for classes outside [0, Q)."""
    q = embed.shape[0]
    ok = (x >= 0) & (x < q)
    e = embed[torch.where(ok, x, 0).long()]
    return torch.where(ok[..., None], e, 0.0)


def masked_classes(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """x with the classes of masked positions (mask 0) replaced by -1, an
    invalid class, whose embedding row is zero."""
    return x if mask is None else torch.where(mask != 0, x, torch.full_like(x, -1))


def frontend_fwd_plain(embed, w, b, x, dt, tensor_cores: Optional[bool] = None, mask=None):
    """PyTorch version of the forward kernels: h0 (B, T, C) fp32. The tap
    table P[k] = rnd(embed) @ rnd(w[k]) (with tensor_cores, default
    `default_order`, summed as tc_mm sums it), then h0 = b + ((P[0][x_0] +
    P[1][x_1]) + ...) with zero taps before t = 0 and for invalid classes;
    with the halo `mask` (B, T), masked positions' classes are invalid and
    h0's rows are multiplied by it."""
    if tensor_cores is None:
        tensor_cores = default_order(embed.device, *_widths(embed, w), dt)
    mm = tc_mm if tensor_cores else torch.matmul
    k_taps = w.shape[0]
    x = masked_classes(x, mask)
    er = rnd(embed.to(torch.float32), dt)
    acc = None
    for k in range(k_taps):
        part = shift_right(_embed_rows(mm(er, rnd(w[k], dt)), x), k_taps - 1 - k)
        acc = part if acc is None else acc + part
    h = b.to(torch.float32) + acc
    return h if mask is None else h * mask[..., None]


def _split_bf16(v: torch.Tensor):
    """v (fp32) as bf16 values hi + lo, lo = rnd(v - hi)."""
    hi = rnd(v, torch.bfloat16)
    return hi, rnd(v - hi, torch.bfloat16)


def frontend_bwd_plain(embed, w, x, dt, dh, tensor_cores: Optional[bool] = None, mask=None):
    """PyTorch version of the backward kernels: (d_embed (Q, C), d_w
    (K, C, C), d_b (C,)). d_w[k] = embed^T G[k], G[k] the scatter of
    dh[s + K-1-k] by x[s]; each d_e piece rnd(dh @ rnd(w[k])^T), with
    tensor_cores (default `default_order`) as the kernel computes it:
    rnd(tc_mm(hi, .) + tc_mm(lo, .)) of dh split into bf16 hi + lo. With
    the halo `mask`, dh * mask and the masked classes."""
    k_taps = w.shape[0]
    q, c = embed.shape
    if tensor_cores is None:
        tensor_cores = default_order(dh.device, q, c, k_taps, dt)
    dh = dh.to(torch.float32)
    if mask is not None:
        dh = dh * mask[..., None]
    x = masked_classes(x, mask)
    split = _split_bf16(dh) if tensor_cores else None
    ok = ((x >= 0) & (x < q)).reshape(-1)
    idx = x.reshape(-1)[ok].long()
    de, d_w = None, []
    for k in range(k_taps):
        wt = rnd(w[k], dt).T
        if tensor_cores:
            piece = tc_mm(split[0], wt) + tc_mm(split[1], wt)
        else:
            piece = dh @ wt
        piece = _shift_left(rnd(piece, dt), k_taps - 1 - k)
        de = piece if de is None else de + piece
        g = torch.zeros((q, c), dtype=torch.float32, device=dh.device)
        g.index_add_(0, idx, _shift_left(dh, k_taps - 1 - k).reshape(-1, c)[ok])
        d_w.append(embed.to(torch.float32).T @ g)
    d_embed = torch.zeros((q, c), dtype=torch.float32, device=dh.device)
    d_embed.index_add_(0, idx, de.reshape(-1, c)[ok])
    return d_embed, torch.stack(d_w), dh.sum((0, 1))


class _FrontArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "emb", "w", "wT", "bias", "h", "dh", "de", "e", "partial", "grads", "table",
    )] + [(n, ctypes.c_int) for n in ("B", "T", "Q", "C", "K", "bf16", "tc", "blocks")] + [
        (n, ctypes.c_void_p) for n in ("mask", "dhm")]


def lib_tc_smem(lib, q: int, c: int, k: int) -> int:
    """The built library's own count of tc_smem's bytes."""
    return int(build.entry(lib, "wn_front_tc_smem", [ctypes.c_int] * 3, ctypes.c_longlong)(
        q, c, k))


def _route(lib, q: int, c: int, k: int, dt) -> bool:
    """route() on the card: whether the tensor-core kernels run, after
    checking that the library carves shared memory as tc_smem reckons it
    (else a shape could be sent to the wrong route)."""
    if lib_tc_smem(lib, q, c, k) != tc_smem(q, c, k):
        raise RuntimeError(
            f"csrc/frontend.cu carves {lib_tc_smem(lib, q, c, k)} bytes of shared memory at "
            f"Q={q}, C={c}, K={k}; frontend.tc_smem reckons {tc_smem(q, c, k)}")
    return route(q, c, k, dt) == "tensor_cores"


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sms(device.index if device.index is not None else torch.cuda.current_device())


def _cuda_inputs(embed, w, b, x, dt, mask=None):
    """The kernels' operands, checked: classes int32, weights in the compute
    dtype and transposed (made once per weight set, `build.prepared`),
    embedding and bias (None in the backward) and the halo mask (or None)
    fp32."""
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
    if mask is not None and (mask.shape != x.shape or mask.device != dev):
        raise ValueError(f"mask {tuple(mask.shape)} must match x {tuple(x.shape)} on {dev}")

    def cast():
        wd = w.detach().to(dt).contiguous()
        return wd, wd.transpose(1, 2).contiguous()

    wd, wt = build.prepared(f"frontend {dev} {dt}", (w,), cast)
    return dict(x=_as(x, torch.int32), emb=_as(embed, torch.float32), w=wd, wT=wt,
                bias=None if b is None else _as(b, torch.float32),
                mask=None if mask is None else _as(mask, torch.float32))


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    """t in dtype, contiguous (t itself when it already is)."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def _args(ops, bsz, t, q, c, k, dt, tc, blocks, **bufs):
    """The launch's FrontArgs: the operands' and buffers' pointers (0 for
    those the launch does not use), then the sizes and flags."""
    a = _FrontArgs(B=bsz, T=t, Q=q, C=c, K=k, bf16=int(dt == torch.bfloat16), tc=int(tc),
                   blocks=blocks)
    for n, v in (*ops.items(), *bufs.items()):
        if v is not None:
            setattr(a, n, v.data_ptr())
    return a


def frontend_fwd(embed, w, b, x, dt, mask=None):
    """Forward kernels on the card: h0 (B, T, C) fp32. 2 launches (the tap
    table, the gather), masked or not."""
    ops = _cuda_inputs(embed, w, b, x, dt, mask)
    bsz, t = x.shape
    q, c = embed.shape
    k_taps = w.shape[0]
    lib = build.load("frontend")
    tc = _route(lib, q, c, k_taps, dt)
    # One allocation: the tap table, then h0 (16-byte aligned where C % 4 == 0,
    # the only width the gather stores 16 bytes at a time).
    n_tab = k_taps * q * c
    buf = torch.empty(n_tab + bsz * t * c, dtype=torch.float32, device=embed.device)
    table, h = buf[:n_tab].view(k_taps, q, c), buf[n_tab:].view(bsz, t, c)
    # The gather's grid: 8 blocks of 256 threads an SM, at most a vector each.
    vecs = bsz * t * (c // 4 if c % 4 == 0 else c)
    blocks = min(-(-vecs // 256), 8 * _sm_count(embed.device))
    args = _args(ops, bsz, t, q, c, k_taps, dt, tc, blocks, h=h, table=table)
    n = build.launch(lib, "wn_front_fwd", args, embed.device)
    frontend_fwd.launches += n
    if mask is not None:
        frontend_fwd.mask_launches += n
    return h


# Kernel launches of the forward, and of those the masked ones.
frontend_fwd.launches = frontend_fwd.mask_launches = 0


def tc_slots(bsz: int, t: int, sms: int) -> int:
    """Blocks (and gradient slots) of the tensor-core backward pass: one per
    SM, at most one per tile."""
    return max(1, min(bsz * -(-t // TC_TILE), sms))


def frontend_bwd(embed, w, x, dt, dh, mask=None):
    """Backward kernels on the card: (d_embed, d_w, d_b) as the plain
    version returns them. 3 launches on the tensor-core route, 4 on the
    CUDA-core one, masked or not (masked, the CUDA-core route also writes
    dh * mask to a scratch copy)."""
    dev = embed.device
    ops = _cuda_inputs(embed, w, None, x, dt, mask)
    bsz, t = x.shape
    q, c = embed.shape
    k_taps = w.shape[0]
    if dh.shape != (bsz, t, c):
        raise ValueError(f"dh must be {(bsz, t, c)}, got {tuple(dh.shape)}")
    dh = _as(dh, torch.float32)
    lib = build.load("frontend")
    nw = q * c + k_taps * c * c + c
    grads = torch.empty(nw, dtype=torch.float32, device=dev)
    if _route(lib, q, c, k_taps, dt):
        slots = tc_slots(bsz, t, _sm_count(dev))
        n_tab = k_taps * q * c   # the G totals, then the slots (one scratch allocation)
        scratch = torch.empty(n_tab + slots * (n_tab + q * c + c), dtype=torch.float32,
                              device=dev)
        args = _args(ops, bsz, t, q, c, k_taps, dt, True, slots, dh=dh,
                     partial=scratch[n_tab:], grads=grads, table=scratch[:n_tab])
    else:
        chunks = -(-bsz * t // build.entry(lib, "wn_front_scatter_chunk", [], ctypes.c_int)())
        de = torch.empty_like(dh)
        e = torch.empty_like(dh)
        partial = torch.empty((chunks, nw), dtype=torch.float32, device=dev)
        args = _args(ops, bsz, t, q, c, k_taps, dt, False, 0, dh=dh, de=de, e=e,
                     partial=partial, grads=grads,
                     dhm=None if mask is None else torch.empty_like(dh))
    n = build.launch(lib, "wn_front_bwd", args, dev)
    frontend_bwd.launches += n
    if mask is not None:
        frontend_bwd.mask_launches += n
    d_embed, d_w, d_b = torch.split(grads, [q * c, k_taps * c * c, c])
    return d_embed.view(q, c), d_w.view(k_taps, c, c), d_b


# Kernel launches of the backward, and of those the masked ones.
frontend_bwd.launches = frontend_bwd.mask_launches = 0


class _Frontend(torch.autograd.Function):
    """h0 = frontend(embed, w, b; x[, mask]); the backward is the
    hand-written one."""

    @staticmethod
    def forward(ctx, dt, x, mask, embed, w, b):
        if build.on_card(embed.device, "the frontend"):
            h = frontend_fwd(embed, w, b, x, dt, mask=mask)
        else:
            h = frontend_fwd_plain(embed, w, b, x, dt, mask=mask)
        ctx.dt = dt
        ctx.save_for_backward(x, mask, embed, w)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, mask, embed, w = ctx.saved_tensors
        bwd = frontend_bwd if embed.device.type == "cuda" else frontend_bwd_plain
        d_embed, d_w, d_b = bwd(embed, w, x, ctx.dt, dh, mask=mask)
        return None, None, None, d_embed, d_w, d_b


def fused_frontend(embed: torch.Tensor, conv: dict, x_classes: torch.Tensor,
                   input_mask=None, compute_dtype: str = "bfloat16") -> torch.Tensor:
    """input_frontend (models/wavenet.py) through the kernel pair: h0
    (B, T, C) fp32 from classes (B, T), differentiable in embed and conv
    ({"w": (K, C, C), "b": (C,)}); the classes get no gradient.
    `input_mask` (B, T), 0/1: the sequence-parallel halo mask (masked
    positions embed to zero, h0's masked rows are zero); it gets no
    gradient either."""
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(compute_dtype)]
    mask = None if input_mask is None else input_mask.detach().to(torch.float32)
    return _Frontend.apply(dt, x_classes, mask, embed, conv["w"], conv["b"])
