"""The mixture-of-logistics head and its masked NLL numerator, forward and
backward (CUDA kernels `csrc/post_mol.cu`), as one `torch.autograd.Function`.

The head of a mol arch (Tacotron 2's WaveNet vocoder): y = relu(skip) w + b,
w (S, 3 n_mix), over the scored window [T - W, T) of the skip sum, and
sum(mask * NLL(y, target)) (ops/mol.py). The rows before the window (the
receptive-field head) give 0 to the numerator and exactly 0 to dskip. No
TPU kernel is replaced (the JAX package has no mixture output); the
design and bound are in the note at the top of `csrc/post_mol.cu`.

Two routes, chosen before the launch from dtype and widths (`route`): bf16
with S a multiple of 16 runs the products on tensor cores (mma.sync, one
mma from zero per 16-deep k-step, summed in k-step order), fp32 with S a
multiple of 4 on CUDA cores; both take 3 n_mix <= 32. Any other shape
raises.

The same function runs as plain PyTorch (`post_mol_plain`,
`post_mol_bwd_plain`), with the kernels' rounding: operands of every
product in the compute dtype, fp32 sums; on a CUDA tensor on the
tensor-core route the head's and dskip's products are summed as the
tensor cores sum them (`train_stack.tc_mm`), so kernel and plain differ in
the NLL's transcendental functions and the weight gradient's order only. A
CPU tensor takes the plain version; a CUDA tensor launches the kernels or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..mol import mol_nll_bwd, masked_nll_sum
from ..numerics import rnd
from . import build
from .train_stack import tc_mm

HEAD_KEYS = ("w", "b")
# csrc/post_mol.cu: rows per tile, head outputs padded, row padding, warps.
TM, NP, PADK, THREADS = 64, 32, 8, 128


def smem(s: int, tc: bool, bwd: bool) -> int:
    """Bytes of dynamic shared memory of a row kernel, as csrc/post_mol.cu
    carves them (`carve`; its `wn_post_mol_smem` must agree)."""
    e = 2 if tc else 4
    sizes = [e * s * (NP + PADK), e * TM * (s + PADK), 4 * TM * (NP + 1)]
    sizes += [e * TM * (NP + PADK), 4 * s * NP] if bwd else [4 * TM]
    off = 0
    for n in sizes:
        off = -(-(off + n) // 16) * 16
    return off


def route(s: int, n_mix: int, dt) -> str:
    """"tensor_cores" (bf16, S a multiple of 16) or "cuda_cores" (fp32, S a
    multiple of 4), both with 3 n_mix <= 32; other shapes raise."""
    if 3 * n_mix > NP:
        raise ValueError(f"the MoL head kernels take 3 n_mix <= {NP} (n_mix <= {NP // 3}), "
                         f"got n_mix={n_mix}")
    if dt == torch.bfloat16 and s % 16 == 0:
        return "tensor_cores"
    if dt == torch.float32 and s % 4 == 0:
        return "cuda_cores"
    raise ValueError(f"the MoL head kernels take bf16 with S % 16 == 0 or fp32 with S % 4 == 0, "
                     f"got {dt} with S={s}")


def default_order(device, s: int, n_mix: int, dt) -> bool:
    """Whether the plain versions sum the row products as the tensor-core
    route does: on a CUDA tensor on that route."""
    return torch.device(device).type == "cuda" and route(s, n_mix, dt) == "tensor_cores"


def _n_mix(head: dict) -> int:
    return head["w"].shape[1] // 3


def _rows(head: dict, skip_w, dt, tensor_cores: bool):
    """(a, y): relu(skip) of the scored rows and the head outputs."""
    a = torch.relu(skip_w)
    w = rnd(head["w"], dt)
    y = (tc_mm(rnd(a, dt), w) if tensor_cores else rnd(a, dt) @ w) + head["b"]
    return a, y


def post_mol_plain(head: dict, skip, targets, mask, window_size: int, dt,
                   tensor_cores: Optional[bool] = None):
    """sum over the window of mask * NLL(head(skip), targets): a 0-dim fp32
    tensor. tensor_cores as in the module's note (default: `default_order`)."""
    n_mix = _n_mix(head)
    if tensor_cores is None:
        tensor_cores = default_order(skip.device, skip.shape[-1], n_mix, dt)
    _, y = _rows(head, skip[:, skip.shape[1] - window_size:], dt, tensor_cores)
    return masked_nll_sum(y, targets, mask, n_mix)


def post_mol_bwd_plain(head: dict, skip, targets, mask, window_size: int, dt, gbar,
                       tensor_cores: Optional[bool] = None):
    """(dskip (B, T, S), {"w", "b"}) for the numerator's cotangent gbar:
    dy in closed form (ops/mol.py `mol_nll_bwd`), da = rnd(dy) w^T, dskip =
    (skip > 0) da, dw = rnd(relu(skip))^T rnd(dy) and db = sum dy."""
    n_mix = _n_mix(head)
    if tensor_cores is None:
        tensor_cores = default_order(skip.device, skip.shape[-1], n_mix, dt)
    head_rows = skip.shape[1] - window_size
    skip_w = skip[:, head_rows:]
    a, y = _rows(head, skip_w, dt, tensor_cores)
    dy = mol_nll_bwd(y, targets, n_mix, mask.to(torch.float32) * gbar)
    dyr = rnd(dy, dt)
    w = rnd(head["w"], dt)
    if tensor_cores:   # K padded to the kernel's 32 with zeros (exact)
        pad = NP - dyr.shape[-1]
        da = tc_mm(torch.nn.functional.pad(dyr, (0, pad)),
                   torch.nn.functional.pad(w.t(), (0, 0, 0, pad)))
    else:
        da = dyr @ w.t()
    dskip = torch.zeros_like(skip)
    dskip[:, head_rows:] = torch.where(skip_w > 0.0, da, 0.0)
    grads = {"w": torch.einsum("bts,btj->sj", rnd(a, dt), dyr), "b": dy.sum((0, 1))}
    return dskip, grads


class _MolArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "skip", "tgt", "mask", "w", "bias", "gbar", "partial", "num", "dskip", "grads",
    )] + [(n, ctypes.c_int) for n in ("B", "T", "W", "S", "M", "tc", "blocks")]


def lib_smem(lib, s: int, tc: bool, bwd: bool) -> int:
    """The built library's own count of smem's bytes."""
    f = build.entry(lib, "wn_post_mol_smem", [ctypes.c_int] * 3, ctypes.c_longlong)
    return int(f(s, int(tc), int(bwd)))


def _tc(lib, s: int, n_mix: int, dt, bwd: bool) -> bool:
    """route() on the card, after checking that the library carves shared
    memory as `smem` reckons it."""
    tc = route(s, n_mix, dt) == "tensor_cores"
    if lib_smem(lib, s, tc, bwd) != smem(s, tc, bwd):
        raise RuntimeError(f"csrc/post_mol.cu carves {lib_smem(lib, s, tc, bwd)} bytes at "
                           f"S={s}; post_mol.smem reckons {smem(s, tc, bwd)}")
    return tc


def _tiles(b: int, w: int) -> int:
    return -(-b * w // TM)


def _blocks(tiles: int, dev, per_sm: int) -> int:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(tiles, per_sm * sms))


def _args(head, skip, targets, mask, window_size, **out):
    """The launch arguments, the inputs kept alive in `out["keep"]`."""
    b, t, s = skip.shape
    n3 = head["w"].shape[1]
    if head["w"].shape[0] != s or n3 % 3 or head["b"].shape != (n3,):
        raise ValueError("the head's w (S, 3 n_mix) and b (3 n_mix,) do not match skip")
    if not 0 < window_size <= t or targets.shape != (b, window_size) \
            or mask.shape != (b, window_size):
        raise ValueError(f"targets and mask must be (B, W) with 0 < W <= T, got "
                         f"{tuple(targets.shape)}, {tuple(mask.shape)}, W={window_size}, T={t}")
    dev = skip.device
    keep = out.pop("keep")
    keep.update(skip=skip.to(torch.float32).contiguous(),
                tgt=targets.to(dev, torch.float32).contiguous(),
                mask=mask.to(dev, torch.float32).contiguous(),
                w=head["w"].to(torch.float32).contiguous(),
                bias=head["b"].to(torch.float32).contiguous())
    ptrs = [build.ptr(keep[k]) for k in ("skip", "tgt", "mask", "w", "bias")]
    ptrs += [build.ptr(out.get(k)) for k in ("gbar", "partial", "num", "dskip", "grads")]
    return _MolArgs(*ptrs, b, t, window_size, s, n3 // 3, int(out["tc"]), out["blocks"])


def post_mol_fwd(head: dict, skip, targets, mask, window_size: int, dt):
    """Forward kernels on the card: the numerator (0-dim). 2 launches."""
    dev = skip.device
    lib = build.load("post_mol")
    b, s = skip.shape[0], skip.shape[2]
    tc = _tc(lib, s, _n_mix(head), dt, False)
    tiles = _tiles(b, window_size)
    num = torch.empty((), dtype=torch.float32, device=dev)
    partial = torch.empty(tiles, dtype=torch.float32, device=dev)
    keep: dict = {}
    args = _args(head, skip, targets, mask, window_size, keep=keep, tc=tc,
                 blocks=_blocks(tiles, dev, 3), partial=partial, num=num)
    post_mol_fwd.launches += build.launch(lib, "wn_post_mol_fwd", args, dev)
    return num


post_mol_fwd.launches = 0


def post_mol_bwd(head: dict, skip, targets, mask, window_size: int, dt, gbar):
    """Backward kernels on the card: (dskip, {"w", "b"}) as the plain
    version returns them. 2 launches."""
    dev = skip.device
    lib = build.load("post_mol")
    b, t, s = skip.shape
    n3 = head["w"].shape[1]
    tc = _tc(lib, s, n3 // 3, dt, True)
    blocks = _blocks(_tiles(b, window_size), dev, 2)
    gbar = gbar.to(dev, torch.float32).reshape(()).contiguous()
    dskip = torch.empty((b, t, s), dtype=torch.float32, device=dev)   # every row written
    partial = torch.empty((blocks, s * NP + NP), dtype=torch.float32, device=dev)
    grads = torch.empty(s * n3 + n3, dtype=torch.float32, device=dev)
    keep: dict = {}
    args = _args(head, skip, targets, mask, window_size, keep=keep, tc=tc, blocks=blocks,
                 gbar=gbar, partial=partial, dskip=dskip, grads=grads)
    post_mol_bwd.launches += build.launch(lib, "wn_post_mol_bwd", args, dev)
    return dskip, {"w": grads[: s * n3].reshape(s, n3), "b": grads[s * n3:]}


post_mol_bwd.launches = 0


class _MolHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, window_size, dt, skip, targets, mask, *weights):
        head = dict(zip(HEAD_KEYS, weights))
        if build.on_card(skip.device, "the MoL head"):
            num = post_mol_fwd(head, skip, targets, mask, window_size, dt)
        else:
            num = post_mol_plain(head, skip, targets, mask, window_size, dt)
        ctx.cfg = (window_size, dt)
        ctx.save_for_backward(skip, targets, mask, *weights)
        return num

    @staticmethod
    def backward(ctx, gbar):
        window_size, dt = ctx.cfg
        skip, targets, mask, *weights = ctx.saved_tensors
        head = dict(zip(HEAD_KEYS, weights))
        bwd = post_mol_bwd if skip.device.type == "cuda" else post_mol_bwd_plain
        dskip, grads = bwd(head, skip, targets, mask, window_size, dt, gbar)
        return (None, None, dskip, None, None, *(grads[k] for k in HEAD_KEYS))


def mol_head_loss(head: dict, skip: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                  window_size: int, compute_dtype: str = "bfloat16") -> torch.Tensor:
    """sum(NLL * mask) over the last `window_size` positions of skip
    (B, T, S) fp32 with target samples and mask (B, W): the masked MoL NLL
    numerator with the head fused in. Differentiable in (head, skip);
    targets and mask are structural."""
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(compute_dtype)]
    return _MolHead.apply(int(window_size), dt, skip, targets, mask,
                          *(head[k] for k in HEAD_KEYS))
