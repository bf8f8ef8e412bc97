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

Two routes of kernels, chosen before the launch from dtype and widths
(`route`): bf16 with S and Q multiples of 16, Q <= 256, whose tiles fit in
a block's shared memory runs on tensor cores (namespace `ptc`); fp32 and
other bf16 widths run the first-version CUDA-core kernels.

The same function runs as plain PyTorch (`post_loss_plain`,
`post_loss_bwd_plain`), with the kernels' rounding: operands of every
product in the compute dtype, fp32 sums; on a CUDA tensor on the
tensor-core route the four row products are summed as the tensor cores sum
them (`train_stack.tc_mm`). A CPU tensor takes the plain version; a CUDA
tensor launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..numerics import rnd
from . import ar_tc, build
from .train_stack import tc_mm, wgrad_chunks

POST_KEYS = ("w1", "b1", "w2", "b2")

# Tensor-core route (csrc/post_loss.cu, namespace ptc): window rows per
# tile, row padding, columns per product block, the weight ring's slots and
# their bytes, consumer threads, the widest logits a tile keeps in
# registers, and the shared memory a block may use on an H100 (227 KB).
TC_TILE, TC_PAD, TC_COLS, TC_SLOTS, TC_SLOT = 64, 8, 256, 4, 16384
TC_THREADS, TC_MAX_Q, TC_SMEM_MAX = 512, 256, 232448


def tc_smem(s: int, q: int) -> int:
    """Bytes of dynamic shared memory of the tensor-core row kernels, as
    csrc/post_loss.cu carves them (`ptc::carve`; its `wn_post_loss_tc_smem`
    must agree: `_route` checks it before a launch): the weight ring and
    its barriers, the two bf16 row tiles, the row statistics, the u > 0
    flags and the block's bias gradients, each start aligned to 16 bytes."""
    tp, warps = TC_TILE, TC_THREADS // 32
    sizes = [TC_SLOTS * TC_SLOT, 8 * TC_SLOTS, 8 * TC_SLOTS, 2 * tp * (s + TC_PAD),
             2 * tp * (max(s, q) + TC_PAD), 4 * warps * tp, 4 * warps * tp, 4 * tp, 4 * tp,
             4 * tp, 4 * -(-s // TC_COLS) * TC_COLS * tp // 32, 4 * (s + q)]
    off = 0
    for n in sizes:
        off = -(-off // 16) * 16 + n
    return off


def route(s: int, q: int, dt) -> str:
    """Which kernels run the post-loss, decided before launch from the
    compute dtype and widths: "tensor_cores" for bf16 with S and Q multiples
    of 16 (mma tiles), Q <= 256 (a tile's logits stay in registers) and
    tiles that fit in a block's shared memory (S up to 576 at Q = 256);
    "cuda_cores" (the first-version fp32-FMA kernels) for fp32, where tensor
    cores (TF32) would change the function, and for any other bf16 width."""
    if (dt == torch.bfloat16 and not (s % 16 or q % 16) and q <= TC_MAX_Q
            and tc_smem(s, q) <= TC_SMEM_MAX):
        return "tensor_cores"
    return "cuda_cores"


def default_order(device, s: int, q: int, dt) -> bool:
    """Whether the plain versions sum the row products as the tensor-core
    route does: on a CUDA tensor (where they are the kernels' reference) on
    that route. On the CPU one fp32 sum per product is much cheaper than
    the float64 emulation."""
    return torch.device(device).type == "cuda" and route(s, q, dt) == "tensor_cores"


def stream_blocks(s: int, q: int) -> list:
    """[(matrix, k, c0, n)] of the packed weight stream in order: w1 (S, S),
    w2 (S, Q), w2^T (Q, S), w1^T (S, S), each as column blocks [c0, c0 + n)
    of TC_COLS, every block k / 16 k-steps of n / 16 fragment tiles. The
    forward streams the first two matrices, the backward all four."""
    shapes = (("w1", s, s), ("w2", s, q), ("w2T", q, s), ("w1T", s, s))
    return [(name, k, c0, min(TC_COLS, n - c0)) for name, k, n in shapes
            for c0 in range(0, n, TC_COLS)]


def pack_stream(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The weight stream of the tensor-core kernels: each block of
    stream_blocks in bf16, packed in mma.sync fragment order
    (ar_tc.pack_mma, whose A fragment of W^T gives the kernel's B fragments
    of W), back to back."""
    mats = {"w1": w1, "w2": w2, "w2T": w2.t(), "w1T": w1.t()}
    mats = {k: v.to(torch.bfloat16) for k, v in mats.items()}
    s, q = w2.shape
    return torch.cat([ar_tc.pack_mma(mats[name][:, c0:c0 + n].contiguous()).reshape(-1)
                      for name, _, c0, n in stream_blocks(s, q)]).contiguous()


def _widths(post: dict):
    """(S, Q) of the post weights."""
    return post["w2"].shape[0], post["w2"].shape[1]


def _rows(post: dict, skip_w: torch.Tensor, dt, mm):
    """(a, u, h1, v) of the scored rows: relu(skip), the hidden layer before
    and after its relu, and the logits."""
    a = torch.relu(skip_w)
    u = mm(rnd(a, dt), rnd(post["w1"], dt)) + post["b1"]
    h1 = torch.relu(u)
    return a, u, h1, mm(rnd(h1, dt), rnd(post["w2"], dt)) + post["b2"]


def post_loss_plain(post: dict, skip, targets, mask, window_size: int, dt,
                    tensor_cores: Optional[bool] = None):
    """sum over the window of mask * CE(post(skip), targets): a 0-dim fp32
    tensor. With tensor_cores (default: `default_order`) the two products
    are summed as the tensor-core route sums them (tc_mm), else in one fp32
    product each."""
    if tensor_cores is None:
        tensor_cores = default_order(skip.device, *_widths(post), dt)
    skip_w = skip[:, skip.shape[1] - window_size:]
    _, _, _, v = _rows(post, skip_w, dt, tc_mm if tensor_cores else torch.matmul)
    m = v.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(v - m).sum(-1, keepdim=True)) + m
    ce = lse - v.gather(-1, targets.long()[..., None])
    return (ce[..., 0] * mask).sum()


def post_loss_bwd_plain(post: dict, skip, targets, mask, window_size: int, dt, gbar,
                        tensor_cores: Optional[bool] = None):
    """(dskip (B, T, S), {post key: grad}) for the numerator's cotangent
    gbar. tensor_cores as in post_loss_plain (the products u, v, dh1 and
    da; the weight gradients are fp32 sums over positions, whose order
    moves them by rounding only)."""
    if tensor_cores is None:
        tensor_cores = default_order(skip.device, *_widths(post), dt)
    mm = tc_mm if tensor_cores else torch.matmul
    head = skip.shape[1] - window_size
    skip_w = skip[:, head:]
    a, u, h1, v = _rows(post, skip_w, dt, mm)
    e = torch.exp(v - v.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(targets.long(), v.shape[-1]).to(p.dtype)
    g = (p - onehot) * (mask * gbar)[..., None]
    gr = rnd(g, dt)
    du = torch.where(u > 0.0, mm(gr, rnd(post["w2"], dt).T), 0.0)
    dur = rnd(du, dt)
    da = mm(dur, rnd(post["w1"], dt).T)
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


class _PostTcArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "skip", "tgt", "mask", "wpk", "b1", "b2", "gbar", "partial", "dskip", "a_bf",
        "h1_bf", "gr_bf", "du_bf", "dbp",
    )] + [(n, ctypes.c_int) for n in ("B", "T", "W", "S", "Q")] + [
        (n, ctypes.c_void_p) for n in ("num", "wpart", "grads")] + [
        (n, ctypes.c_int) for n in ("blocks", "chunks")]


def lib_tc_smem(lib, s: int, q: int) -> int:
    """The built library's own count of tc_smem's bytes."""
    f = lib.wn_post_loss_tc_smem
    f.argtypes, f.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    return int(f(s, q))


def _route(lib, s: int, q: int, dt) -> bool:
    """route() on the card: whether the tensor-core kernels run, after
    checking that the library carves shared memory as tc_smem reckons it
    (else a shape could be sent to the wrong route)."""
    if lib_tc_smem(lib, s, q) != tc_smem(s, q):
        raise RuntimeError(
            f"csrc/post_loss.cu carves {lib_tc_smem(lib, s, q)} bytes of shared memory at "
            f"S={s}, Q={q}; post_loss.tc_smem reckons {tc_smem(s, q)}")
    return route(s, q, dt) == "tensor_cores"


def tc_chunks(n_pos: int, s: int, q: int, sms: int) -> int:
    """Position chunks of the tensor-core weight-gradient pass: two blocks
    per SM over its 128 x 128 output tiles, at least 256 positions a chunk
    (fixed per shape and card, so the summation order is too)."""
    tm = -(-s // 128)
    tiles = tm * tm + tm * -(-q // 128)
    return max(1, min(-(-n_pos // 256), -(-2 * sms // tiles)))


def _cuda_args(post, skip, targets, mask, window_size):
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
    keep = dict(
        skip=skip.to(torch.float32).contiguous(),
        tgt=targets.to(dev, torch.int32).contiguous(),
        mask=mask.to(dev, torch.float32).contiguous(),
        b1=post["b1"].to(torch.float32).contiguous(),
        b2=post["b2"].to(torch.float32).contiguous(),
    )
    return keep, (b, t, window_size, s, q)


def _cuda_weights(post, dt) -> dict:
    """w1, w2 in the compute dtype (CUDA-core route)."""
    return {k: post[k].to(dt).contiguous() for k in ("w1", "w2")}


def _tc_blocks(b: int, w: int, dev) -> int:
    """Blocks of the tensor-core row kernels: one per SM at most (each holds
    ~142 KB of shared memory at WaveNet-30), none without a tile; the
    backward's db slots, one per block."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return min(b * -(-w // TC_TILE), sms)


_TC_OUT = ("gbar", "partial", "dskip", "a_bf", "h1_bf", "gr_bf", "du_bf", "dbp")


def _tc_args(post, keep, dims, blocks: int, chunks: int = 0, **out) -> "_PostTcArgs":
    """Arguments of the tensor-core kernels, with the packed weight stream
    (made once per weight set) kept alive in `keep`."""
    keep["wpk"] = build.prepared("post_loss_tc", (post["w1"], post["w2"]),
                                 lambda: pack_stream(post["w1"], post["w2"]))
    ins = (build.ptr(keep[k]) for k in ("skip", "tgt", "mask", "wpk", "b1", "b2"))
    return _PostTcArgs(*ins, *(build.ptr(out.get(k)) for k in _TC_OUT), *dims,
                       *(build.ptr(out.get(k)) for k in ("num", "wpart", "grads")),
                       blocks, chunks)


def post_loss_fwd(post: dict, skip, targets, mask, window_size: int, dt):
    """Forward kernels on the card: the numerator (0-dim). 2 launches on
    either route."""
    keep, dims = _cuda_args(post, skip, targets, mask, window_size)
    b, _, w, s, q = dims
    dev = skip.device
    lib = build.load("post_loss")
    num = torch.empty((), dtype=torch.float32, device=dev)
    if _route(lib, s, q, dt):
        partial = torch.empty(b * -(-w // TC_TILE), dtype=torch.float32, device=dev)
        args = _tc_args(post, keep, dims, _tc_blocks(b, w, dev), partial=partial, num=num)
        post_loss_fwd.launches += build.launch(lib, "wn_post_loss_fwd_tc", args, dev)
        return num
    wts = _cuda_weights(post, dt)
    blocks = b * -(-w // lib.wn_post_loss_rows())
    partial = torch.empty(blocks, dtype=torch.float32, device=dev)
    args = _PostArgs(
        *(build.ptr(keep[k]) for k in ("skip", "tgt", "mask")), build.ptr(wts["w1"]),
        build.ptr(keep["b1"]), build.ptr(wts["w2"]), build.ptr(keep["b2"]),
        0, 0, 0, partial.data_ptr(), num.data_ptr(), 0, 0, 0, 0, 0, *dims,
        int(dt == torch.bfloat16), 0,
    )
    post_loss_fwd.launches += build.launch(lib, "wn_post_loss_fwd", args, dev)
    return num


post_loss_fwd.launches = 0


def post_loss_bwd(post: dict, skip, targets, mask, window_size: int, dt, gbar):
    """Backward kernels on the card: (dskip, {post key: grad}) as the plain
    version returns them. 3 launches on either route."""
    keep, dims = _cuda_args(post, skip, targets, mask, window_size)
    b, t, w, s, q = dims
    dev = skip.device
    lib = build.load("post_loss")
    nw = s * s + s + s * q + q
    gbar = gbar.to(dev, torch.float32).reshape(()).contiguous()
    grads = torch.empty(nw, dtype=torch.float32, device=dev)
    if _route(lib, s, q, dt):
        n_pos, blocks = b * w, _tc_blocks(b, w, dev)
        chunks = tc_chunks(n_pos, s, q, torch.cuda.get_device_properties(dev).multi_processor_count)
        # The row kernel writes every row of dskip, the head's zeros too.
        dskip = torch.empty((b, t, s), dtype=torch.float32, device=dev)
        ops = {k: torch.empty((n_pos, n), dtype=torch.bfloat16, device=dev)
               for k, n in (("a_bf", s), ("h1_bf", s), ("gr_bf", q), ("du_bf", s))}
        wpart = torch.empty((chunks, s * s + s * q), dtype=torch.float32, device=dev)
        dbp = torch.empty((blocks, s + q), dtype=torch.float32, device=dev)
        args = _tc_args(post, keep, dims, blocks, chunks, gbar=gbar, dskip=dskip, dbp=dbp,
                        wpart=wpart, grads=grads, **ops)
        post_loss_bwd.launches += build.launch(lib, "wn_post_loss_bwd_tc", args, dev)
    else:
        wts = _cuda_weights(post, dt)
        chunks = wgrad_chunks(b * w)
        w1t = wts["w1"].T.contiguous()
        w2t = wts["w2"].T.contiguous()
        dskip = torch.zeros((b, t, s), dtype=torch.float32, device=dev)
        h1 = torch.empty((b, w, s), dtype=torch.float32, device=dev)
        g = torch.empty((b, w, q), dtype=torch.float32, device=dev)
        du = torch.empty((b, w, s), dtype=torch.float32, device=dev)
        partial = torch.empty((chunks, nw), dtype=torch.float32, device=dev)
        args = _PostArgs(
            *(build.ptr(keep[k]) for k in ("skip", "tgt", "mask")), build.ptr(wts["w1"]),
            build.ptr(keep["b1"]), build.ptr(wts["w2"]), build.ptr(keep["b2"]),
            w1t.data_ptr(), w2t.data_ptr(), gbar.data_ptr(), partial.data_ptr(), 0,
            dskip.data_ptr(), h1.data_ptr(), g.data_ptr(), du.data_ptr(), grads.data_ptr(),
            *dims, int(dt == torch.bfloat16), chunks,
        )
        post_loss_bwd.launches += build.launch(lib, "wn_post_loss_bwd", args, dev)
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
