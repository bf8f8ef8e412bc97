"""tp_fused_stack: one sample step of the model-sharded stack, all L layers
through this rank's skip slice (CUDA kernel `csrc/ar_tp.cu`).

Replaces `lb_wavenet_tpu/ops/pallas/ar_tp.py` (`tp_fused_stack`, body
`_tp_kernel`). The TPU kernel walks a sequential grid over the layers with
h, the local skip sum and the [h ; tap] pair in VMEM scratch; the CUDA
kernel gives one block a tile of lanes for all layers and keeps them in
shared memory (design and bound: the note at the top of `csrc/ar_tp.cu`).

Arithmetic follows the TPU kernel, which keeps mega's accumulation
contract: ONE merged [h ; tap] 2C-deep product against wcat, ONE merged
z @ [w_res | w_skip_local] product, mega's bias order, operands in the
compute dtype and fp32 sums. So greedy output of the model-sharded path
tracks single-device mega.

Two routes, picked before the launch from the compute dtype and (C, G, S_l)
(`ar_tc.stack_route`): bf16 with every width a multiple of 16 and C+S_l <=
768 runs `tc::stack_tc_kernel` (mega's layer loop on tensor cores, fed the
stream `ar_tc.fm_layer_stream` packed once per weight set; any batch);
fp32 and other widths (an S_l split 3 ways) the first version's CUDA-core
kernel.

`fm` holds the weights in the JAX kernel's FEATURE-major views
(`generate._tp_weights`): wcat (L, 2G, 2C), b (L, 2G, 1), wrs (L, C+S_l, G),
brs (L, C+S_l, 1), where S_l is this rank's skip slice; the wrapper makes
the kernel's k-major compute-dtype copies once per weight set
(`build.prepared`). The step takes the absolute time t and the kernel
computes each layer's ring slot offset_l + t mod d_l, as the port's
fused_stack does (the JAX kernel takes the slots). The ring (sum_d, C, B) is
updated IN PLACE (the JAX kernel aliases it onto its output). A CPU tensor
takes `tp_fused_stack_plain`; a CUDA tensor launches the kernel or raises.

Conditioning: with fm["wcond"] (L, 2G, Cc'), the folded w_cond's
feature-major view, the step takes cond_t (Cc', B), mel and/or speaker
folded into one row a lane (generate._fold_gcond); the gate is not split
across ranks, so every rank adds the whole cond term.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...config import ArchConfig
from ..numerics import compute_dtype, rnd
from . import ar_tc, build
from .ar_step import buffer_offsets


def _widths(fm: dict) -> tuple:
    """(L, C, G, S_l) of B7's feature-major weights."""
    n_layers, two_g, two_c = fm["wcat"].shape
    return n_layers, two_c // 2, two_g // 2, fm["wrs"].shape[1] - two_c // 2


def tp_fused_stack_plain(fm: dict, arch: ArchConfig, h0, bufs, t: int,
                         tensor_cores: Optional[bool] = None, cond_t=None):
    """PyTorch version of the kernel on any device, op for op as the JAX
    kernel: (bufs, skip_local (S_l, B) fp32). With tensor_cores (the
    default on a CUDA tensor on the tensor-core route,
    ar_tc.stack_default_order) both products are summed as the kernel sums
    them (ar_tc.tc_product), cond_t's k-steps continuing the gate's chain
    before the bias, so the two agree bit for bit; otherwise in the
    CUDA-core route's order (ar_tc.core_product: the kernel's in-order FMA
    chains on the card, one fp32 product on the CPU), cond's after the bias
    (the JAX order)."""
    dt = compute_dtype(arch)
    n_layers, c, g, s_l = _widths(fm)
    cc = 0 if cond_t is None else cond_t.shape[0]
    if tensor_cores is None:
        tensor_cores = ar_tc.stack_default_order(c, g, s_l, n_layers, dt, h0.device, cc)
    product = ar_tc.plain_product(
        tensor_cores, ar_tc.stack_route(c, g, s_l, n_layers, dt, cc) == "cuda_cores")

    def mm(w, x):   # (M, K) @ (K, B), both rounded to the compute dtype
        return product(rnd(w, dt), rnd(x, dt))

    h = h0.to(torch.float32)
    skip = torch.zeros((s_l, h0.shape[1]), device=h0.device)
    for l, (off, d) in enumerate(zip(buffer_offsets(arch), arch.dilations)):
        slot = off + t % d
        tap = bufs[slot].clone()
        bufs[slot] = h
        if cc and tensor_cores:
            pre = mm(torch.cat([fm["wcat"][l], fm["wcond"][l]], 1),
                     torch.cat([h, tap, cond_t], 0)) + fm["b"][l]
        else:
            pre = mm(fm["wcat"][l], torch.cat([h, tap], 0)) + fm["b"][l]
            if cc:
                pre = pre + mm(fm["wcond"][l], cond_t)
        z = torch.tanh(pre[:g]) * torch.sigmoid(pre[g:])
        rs = mm(fm["wrs"][l], z)
        brs = fm["brs"][l]
        h = h + rs[:c] + brs[:c]
        skip = skip + (rs[c:] + brs[c:])
    return bufs, skip


class _TpArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "h0", "bufs", "dils", "wcat", "b", "wrs", "brs", "skip",
    )] + [(n, ctypes.c_int) for n in ("B", "L", "C", "G", "S", "t", "bf16")] + [
        (n, ctypes.c_void_p) for n in ("cond", "wcond")] + [("Cc", ctypes.c_int)]


def _check(name, x, shape, dtype, device):
    if x.shape != shape or x.dtype != dtype or x.device != device or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {tuple(shape)} {dtype} on {device}, "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")


def tp_fused_stack(
    fm: dict,
    arch: ArchConfig,
    h0: torch.Tensor,          # (C, B) fp32 feature-major residual input
    bufs: torch.Tensor,        # (sum_d, C, B) fp32 packed rings, in place
    t: int,                    # absolute step: ring slot offset_l + t mod d_l
    cond_t: Optional[torch.Tensor] = None,   # (Cc', B) the step's folded cond
):
    """Run all gated layers; returns (bufs, skip_local (S_l, B) fp32).
    cond_t is given exactly when fm holds "wcond"."""
    if (cond_t is None) != ("wcond" not in fm):
        raise ValueError("pass cond_t exactly when the weights hold wcond")
    if torch.compiler.is_exporting():  # a traced program calls the op (ops/library.py)
        from .. import library

        return library.tp_fused_stack(fm, arch, h0, bufs, t, cond_t)
    if not build.on_card(h0.device, "tp_fused_stack"):
        return tp_fused_stack_plain(fm, arch, h0, bufs, t, cond_t=cond_t)
    dev = h0.device
    dt = compute_dtype(arch)
    c, b = h0.shape
    L = len(arch.dilations)
    _, _, g, s_l = _widths(fm)
    two_g = 2 * g
    cc = 0 if cond_t is None else cond_t.shape[0]
    _check("h0", h0, (c, b), torch.float32, dev)
    _check("bufs", bufs, (sum(arch.dilations), c, b), torch.float32, dev)
    if fm["wcat"].shape != (L, two_g, 2 * c):
        raise ValueError(f"wcat {tuple(fm['wcat'].shape)} does not match the arch and h0")
    names = ("wcat", "b", "wrs", "brs")
    if cc:
        names += ("wcond",)
        if fm["wcond"].shape != (L, two_g, cc):
            raise ValueError(f"wcond {tuple(fm['wcond'].shape)} does not match cond_t "
                             f"{tuple(cond_t.shape)}")
        cond_t = cond_t.to(dev, dt).contiguous()
        _check("cond_t", cond_t, (cc, b), dt, dev)
    skip = torch.empty((s_l, b), dtype=torch.float32, device=dev)
    dils = build.int32_table(tuple(arch.dilations), str(dev))
    if ar_tc.stack_route(c, g, s_l, L, dt, cc) == "tensor_cores":
        ops = build.prepared(
            f"tp_fused_stack tc {dev}", tuple(fm[k] for k in names),
            lambda: ar_tc.pack_layers(ar_tc.fm_layer_stream(fm), fm["b"][..., 0],
                                      fm["brs"][..., 0], dev))
        tp_fused_stack.launches += ar_tc.launch_stack("tp_fused_stack", ops, h0, bufs, dils,
                                                      skip, (b, L, c, g, s_l), t, dev, cond_t)
        return bufs, skip

    def kmajor():  # k-major weights in the compute dtype, biases fp32 (L, M)
        out = {
            "wcat": fm["wcat"].transpose(1, 2).to(dev, dt).contiguous(),
            "b": fm["b"][..., 0].to(dev, torch.float32).contiguous(),
            "wrs": fm["wrs"].transpose(1, 2).to(dev, dt).contiguous(),
            "brs": fm["brs"][..., 0].to(dev, torch.float32).contiguous(),
        }
        if cc:
            out["wcond"] = fm["wcond"].transpose(1, 2).to(dev, dt).contiguous()
        return out

    ops = build.prepared(f"tp_fused_stack {dev} {dt}", tuple(fm[k] for k in names), kmajor)
    _check("wcat", ops["wcat"], (L, 2 * c, two_g), dt, dev)
    _check("wrs", ops["wrs"], (L, g, c + s_l), dt, dev)
    args = _TpArgs(
        h0.data_ptr(), bufs.data_ptr(), dils.data_ptr(),
        *(ops[k].data_ptr() for k in names[:4]), skip.data_ptr(),
        b, L, c, g, s_l, int(t), int(dt == torch.bfloat16),
        build.ptr(cond_t), build.ptr(ops.get("wcond")), cc,
    )
    tp_fused_stack.launches += build.launch(build.load("ar_tp"), "wn_tp_fused_stack",
                                            args, dev)
    return bufs, skip


tp_fused_stack.launches = 0
