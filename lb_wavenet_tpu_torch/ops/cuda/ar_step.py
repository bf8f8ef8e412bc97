"""fused_stack: one sample step through all L layers (CUDA kernel
`csrc/ar_step.cu`), and `pallas_stack_step`, the `pallas` engine's step
built on it.

Replaces `lb_wavenet_tpu/ops/pallas/ar_step.py` (`fused_stack`, body
`_stack_kernel`). The TPU kernel walks a sequential grid over layers with h
and the skip sum in VMEM scratch and scalar-prefetched ring slots; the CUDA
kernel gives each block a tile of lanes that loops over the layers itself,
keeps h, the skip sum and the pre-activations in shared memory, and computes
its own slot offset_l + t mod d_l (design and bound: the note at the top of
`csrc/ar_step.cu`). Two routes, picked before the launch from the compute
dtype and the widths (`ar_tc.stack_route`, with S from the w_skip given, a
rank's slice under a model axis): bf16 at widths the tensor-core tiles
take runs `tc::stack_tc_kernel` (turbo's layer loop on tensor cores, the
weights packed once per weight set); fp32 and other widths the first
version's CUDA-core kernel.

The ring (sum_d, B, C) is updated IN PLACE (the JAX kernel aliased it onto
its output): each layer's tap row is read, then overwritten with h.
A CPU tensor takes `fused_stack_plain`; a CUDA tensor launches the kernel or
raises. The post network stays outside the kernel, as in JAX.

Conditioning: `cond_t` (B, Cc') is the step's conditioning row, mel and/or
speaker folded into one (generate._fold_gcond), and lp["w_cond"] (L, Cc',
2G) the matching folded weight; every layer adds cond_t @ w_cond[l] to its
gate pre-activation (the order of each route: ar_tc.py's note).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...config import ArchConfig
from ...models.wavenet import _mm, compute_dtype, input_step, post_network, rnd
from . import ar_tc, build


def buffer_offsets(arch: ArchConfig) -> tuple:
    """Row offset of each layer's ring inside the packed (sum_d, B, C)
    buffer: layer l owns rows [offset_l, offset_l + d_l) and reads row
    offset_l + t mod d_l at step t. The layout every engine shares."""
    offs, acc = [], 0
    for d in arch.dilations:
        offs.append(acc)
        acc += d
    return tuple(offs)


def fused_stack_plain(lp: dict, arch: ArchConfig, h0, bufs, t: int, mm=None,
                      cond_t=None, tensor_cores: Optional[bool] = None):
    """PyTorch version of the kernel, on any device: (bufs, skip (B, S)).
    `mm(x, w)` takes each product. By default, on a CUDA tensor on the
    tensor-core route, each product is summed as the kernel sums it
    (ar_tc.tc_mm), so the two agree bit for bit; otherwise (the CPU, fp32,
    other widths) with bf16 operands and one fp32 sum. turbo's plain
    version passes its own, with `tensor_cores` saying which it is. With
    `cond_t` (B, Cc') and lp["w_cond"] (L, Cc', 2G): on the tensor-core
    route cond's k-steps continue the tap's sum, (h @ w_cur + [tap | cond]
    @ [w_prev ; w_cond]) + b; otherwise the JAX order, ((h @ w_cur + tap @
    w_prev) + b) + cond @ w_cond."""
    dt = compute_dtype(arch)
    if tensor_cores is None:
        n_layers, c, two_g = lp["w_cur"].shape
        cc = 0 if cond_t is None else cond_t.shape[-1]
        tensor_cores = mm is None and ar_tc.stack_default_order(
            c, two_g // 2, lp["w_skip"].shape[-1], n_layers, dt, h0.device, cc)
    if mm is None:
        def mm(x, w):
            return ar_tc.tc_mm(rnd(x, dt), rnd(w, dt)) if tensor_cores else _mm(x, w, dt)
    g = lp["w_cur"].shape[-1] // 2
    h = h0
    skip = torch.zeros(h0.shape[0], lp["w_skip"].shape[-1], device=h0.device)
    for i, (off, d) in enumerate(zip(buffer_offsets(arch), arch.dilations)):
        slot = off + t % d
        tap = bufs[slot].clone()
        bufs[slot] = h
        if cond_t is None:
            pre = mm(h, lp["w_cur"][i]) + mm(tap, lp["w_prev"][i]) + lp["b"][i]
        elif tensor_cores:
            pre = mm(h, lp["w_cur"][i]) + mm(torch.cat([tap, cond_t], 1), torch.cat(
                [lp["w_prev"][i], lp["w_cond"][i]], 0)) + lp["b"][i]
        else:
            pre = (mm(h, lp["w_cur"][i]) + mm(tap, lp["w_prev"][i]) + lp["b"][i]
                   + mm(cond_t, lp["w_cond"][i]))
        z = torch.tanh(pre[:, :g]) * torch.sigmoid(pre[:, g:])
        h = h + mm(z, lp["w_res"][i]) + lp["b_res"][i]
        skip = skip + mm(z, lp["w_skip"][i]) + lp["b_skip"][i]
    return bufs, skip


class _StackArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "h0", "bufs", "dils", "w_cur", "w_prev", "b", "w_res", "b_res",
        "w_skip", "b_skip", "skip",
    )] + [(n, ctypes.c_int) for n in ("B", "L", "C", "G", "S", "t", "bf16")] + [
        (n, ctypes.c_void_p) for n in ("cond", "w_cond")] + [("Cc", ctypes.c_int)]


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
    cond_t: Optional[torch.Tensor] = None,   # (B, Cc') the step's folded cond
):
    """Run all gated layers; returns (bufs, skip_sum (B, S) fp32). With
    cond_t, lp["w_cond"] is the matching folded (L, Cc', 2G) weight."""
    if h0.device.type == "cpu":
        return fused_stack_plain(lp, arch, h0, bufs, t, cond_t=cond_t)
    if h0.device.type != "cuda":
        raise ValueError(f"fused_stack runs on cpu or cuda, not {h0.device}")
    dev = h0.device
    dt = compute_dtype(arch)
    b, c = h0.shape
    L = len(arch.dilations)
    two_g = lp["w_cur"].shape[-1]
    s = lp["w_skip"].shape[-1]
    cc = 0 if cond_t is None else cond_t.shape[-1]
    _check("h0", h0, (b, c), torch.float32, dev)
    _check("bufs", bufs, (sum(arch.dilations), b, c), torch.float32, dev)
    names = ("w_cur", "w_prev", "w_res", "w_skip", "b", "b_res", "b_skip")
    if cc:
        names += ("w_cond",)
        if lp["w_cond"].shape != (L, cc, two_g):
            raise ValueError(f"w_cond {tuple(lp['w_cond'].shape)} does not match cond_t "
                             f"{tuple(cond_t.shape)}")
        cond_t = cond_t.to(dev, dt).contiguous()
        _check("cond_t", cond_t, (b, cc), dt, dev)
    if lp["w_cur"].shape != (L, c, two_g):
        raise ValueError(f"w_cur {tuple(lp['w_cur'].shape)} does not match the arch and h0")
    skip = torch.empty((b, s), dtype=torch.float32, device=dev)
    dils = build.int32_table(tuple(arch.dilations), str(dev))
    if ar_tc.stack_route(c, two_g // 2, s, L, dt, cc) == "tensor_cores":
        ops = build.prepared(
            f"fused_stack tc {dev}", tuple(lp[k] for k in names),
            lambda: ar_tc.pack_layers(ar_tc.layer_stream(lp, lp["w_cond"] if cc else None),
                                      lp["b"], torch.cat([lp["b_res"], lp["b_skip"]], 1), dev))
        fused_stack.launches += ar_tc.launch_stack("fused_stack", ops, h0, bufs, dils, skip,
                                                   (b, L, c, two_g // 2, s), t, dev, cond_t)
        return bufs, skip

    def cast():  # weights in the compute dtype, biases in fp32
        return {k: lp[k].to(dev, dt if k.startswith("w") else torch.float32)
                .contiguous() for k in names}

    ops = build.prepared(f"fused_stack {dev} {dt}",
                         tuple(lp[k] for k in names), cast)
    _check("w_cur", ops["w_cur"], (L, c, two_g), dt, dev)
    _check("w_res", ops["w_res"], (L, two_g // 2, c), dt, dev)
    args = _StackArgs(
        h0.data_ptr(), bufs.data_ptr(), dils.data_ptr(),
        *(ops[k].data_ptr() for k in (
            "w_cur", "w_prev", "b", "w_res", "b_res", "w_skip", "b_skip")),
        skip.data_ptr(),
        b, L, c, two_g // 2, s, int(t), int(dt == torch.bfloat16),
        build.ptr(cond_t), build.ptr(ops.get("w_cond")), cc,
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
    model_axis=None,
):
    """Drop-in replacement for generate.stack_step using fused_stack. With
    `model_axis` the params hold this rank's skip slice: the kernel takes S
    from w_skip's shape and the post network is
    generate.post_network_sharded (one all-reduce). The speaker row `gcond`
    (B, E) is folded into the step's cond as in the JAX step: one cond_t
    [cond_t | gcond] against [w_cond ; w_gcond] (generate._fold_gcond)."""
    from ...generate import _fold_gcond

    lp, cond_t = _fold_gcond(params["layers"], cond_t, gcond)
    h, new_embed_buf = input_step(params, arch, state.embed_buf, x_class)
    bufs, skip = fused_stack(lp, arch, h, state.bufs, t, cond_t)
    dt = compute_dtype(arch)
    if model_axis is not None:
        from ...generate import post_network_sharded

        return new_embed_buf, bufs, post_network_sharded(params, skip, dt, model_axis)
    return new_embed_buf, bufs, post_network(params, skip, dt)
