"""fused_stack: one sample step through all L layers (CUDA kernel
`csrc/ar_step.cu`), and `pallas_stack_step`, the `pallas` engine's step
built on it.

Replaces `lb_wavenet_tpu/ops/pallas/ar_step.py` (`fused_stack`, body
`_stack_kernel`). The TPU kernel walks a sequential grid over layers with h
and the skip sum in VMEM scratch and scalar-prefetched ring slots; the CUDA
kernel gives each block a tile of lanes that loops over the layers itself,
keeps h, the skip sum and the pre-activations in shared memory, and computes
its own slot offset_l + t mod d_l (design and bound: the note at the top of
`csrc/ar_step.cu`).

The ring (sum_d, B, C) is updated IN PLACE (the JAX kernel aliased it onto
its output): each layer's tap row is read, then overwritten with h.
A CPU tensor takes `fused_stack_plain`; a CUDA tensor launches the kernel or
raises. The post network stays outside the kernel, as in JAX.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...config import ArchConfig
from ...models.wavenet import _mm, compute_dtype, input_step, post_network
from . import build


def buffer_offsets(arch: ArchConfig) -> tuple:
    """Row offset of each layer's ring inside the packed (sum_d, B, C)
    buffer: layer l owns rows [offset_l, offset_l + d_l) and reads row
    offset_l + t mod d_l at step t. The layout every engine shares."""
    offs, acc = [], 0
    for d in arch.dilations:
        offs.append(acc)
        acc += d
    return tuple(offs)


def fused_stack_plain(lp: dict, arch: ArchConfig, h0, bufs, t: int):
    """PyTorch version of the kernel, on any device: (bufs, skip (B, S))."""
    dt = compute_dtype(arch)
    g = lp["w_cur"].shape[-1] // 2
    h = h0
    skip = torch.zeros(h0.shape[0], lp["w_skip"].shape[-1], device=h0.device)
    for i, (off, d) in enumerate(zip(buffer_offsets(arch), arch.dilations)):
        slot = off + t % d
        tap = bufs[slot].clone()
        bufs[slot] = h
        pre = _mm(h, lp["w_cur"][i], dt) + _mm(tap, lp["w_prev"][i], dt) + lp["b"][i]
        z = torch.tanh(pre[:, :g]) * torch.sigmoid(pre[:, g:])
        h = h + _mm(z, lp["w_res"][i], dt) + lp["b_res"][i]
        skip = skip + _mm(z, lp["w_skip"][i], dt) + lp["b_skip"][i]
    return bufs, skip


class _StackArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "h0", "bufs", "dils", "w_cur", "w_prev", "b", "w_res", "b_res",
        "w_skip", "b_skip", "skip",
    )] + [(n, ctypes.c_int) for n in ("B", "L", "C", "G", "S", "t", "bf16")]


def _check(name, t, shape, dtype, device):
    if t.shape != shape or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"{name}: expected {tuple(shape)} {dtype} on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_stack(
    lp: dict,
    arch: ArchConfig,
    h0: torch.Tensor,          # (B, C) fp32 residual stream after input conv
    bufs: torch.Tensor,        # (sum_d, B, C) fp32 packed rings, in place
    t: int,                    # absolute step: ring slot offset_l + t mod d_l
    cond_t: Optional[torch.Tensor] = None,
):
    """Run all gated layers; returns (bufs, skip_sum (B, S) fp32)."""
    if cond_t is not None:
        raise NotImplementedError(
            "conditioned fused_stack waits for the mel slice (ROADMAP.md A queue item 4)"
        )
    if h0.device.type == "cpu":
        return fused_stack_plain(lp, arch, h0, bufs, t)
    if h0.device.type != "cuda":
        raise ValueError(f"fused_stack runs on cpu or cuda, not {h0.device}")
    dev = h0.device
    dt = compute_dtype(arch)
    b, c = h0.shape
    L = len(arch.dilations)
    two_g = lp["w_cur"].shape[-1]
    s = lp["w_skip"].shape[-1]
    _check("h0", h0, (b, c), torch.float32, dev)
    _check("bufs", bufs, (sum(arch.dilations), b, c), torch.float32, dev)
    names = ("w_cur", "w_prev", "w_res", "w_skip", "b", "b_res", "b_skip")

    def cast():  # weights in the compute dtype, biases in fp32
        return {k: lp[k].to(dev, dt if k.startswith("w") else torch.float32)
                .contiguous() for k in names}

    ops = build.prepared(f"fused_stack {dev} {dt}",
                         tuple(lp[k] for k in names), cast)
    _check("w_cur", ops["w_cur"], (L, c, two_g), dt, dev)
    _check("w_res", ops["w_res"], (L, two_g // 2, c), dt, dev)
    skip = torch.empty((b, s), dtype=torch.float32, device=dev)
    dils = build.int32_table(tuple(arch.dilations), str(dev))
    args = _StackArgs(
        h0.data_ptr(), bufs.data_ptr(), dils.data_ptr(),
        *(ops[k].data_ptr() for k in (
            "w_cur", "w_prev", "b", "w_res", "b_res", "w_skip", "b_skip")),
        skip.data_ptr(),
        b, L, c, two_g // 2, s, int(t), int(dt == torch.bfloat16),
    )
    fused_stack.launches += build.launch(build.load("ar_step"), "wn_fused_stack",
                                         args, dev)
    return bufs, skip


fused_stack.launches = 0


def pallas_stack_step(
    params: dict,
    arch: ArchConfig,
    state,
    t: int,
    x_class: torch.Tensor,
    cond_t: Optional[torch.Tensor] = None,
    gcond: Optional[torch.Tensor] = None,
    model_axis: Optional[str] = None,
):
    """Drop-in replacement for generate.stack_step using fused_stack."""
    if cond_t is not None or gcond is not None:
        raise NotImplementedError(
            "conditioning waits for the mel/speaker slice (ROADMAP.md A queue item 4)"
        )
    if model_axis is not None:
        raise NotImplementedError("model_axis waits for ROADMAP.md A queue item 7")
    h, new_embed_buf = input_step(params, arch, state.embed_buf, x_class)
    bufs, skip = fused_stack(params["layers"], arch, h, state.bufs, t)
    return new_embed_buf, bufs, post_network(params, skip, compute_dtype(arch))
