"""mega_generate: the whole batched sampling loop in one launch (CUDA kernel
`csrc/ar_mega.cu`), with the per-lane counter hash it samples from.

Replaces `lb_wavenet_tpu/ops/pallas/ar_mega.py` (`mega_generate`, body
`_make_mega_kernel`, plus `_perlane_bits`, `_gumbel_bits`, `_mix32`,
`estack_feature_major` and `mega_zero_carry`). The TPU kernel runs a
sequential grid over the T steps with every weight resident in VMEM; the
CUDA kernel gives one block a tile of LANE_TILE lanes for all T steps (design
and bound: the note at the top of `csrc/ar_mega.cu`).

Arithmetic follows the TPU kernel, not the split `xla` engine: the merged
[h | tap] 2C -> 2G contraction, the merged res+skip output and its bias
order, so mega drifts from `xla` by design (the precision note of the JAX
module). Everything is FEATURE-major (channels, lanes), like the JAX carry.

The streaming carry {bufs, hstate, h_s, e_s} is updated IN PLACE (the JAX
kernel aliased it onto its outputs) and returned. A CPU tensor takes
`mega_generate_plain`; a CUDA tensor launches the kernel or raises.

Conditioning (has_cond): cond_ts (T, B, Cc') holds each step's
conditioning row, mel and/or speaker folded into one
(generate._fold_gcond), and lp["w_cond"] (L, Cc', 2G) the matching folded
weight; step t of the chunk reads row t (chunk-local), while the ring
slots and the sampling counters use the absolute time t0 + t.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ...config import ArchConfig
from ...models.wavenet import compute_dtype, rnd
from . import ar_tc, build
from .ar_step import buffer_offsets

LANE_TILE = 8  # lanes per block: the batch must be a multiple (wn::TB)

_M32 = 0xFFFFFFFF
_PL_T = 0x9E3779B9   # mixing constants (uint32, golden-ratio / murmur3)
_PL_Q = 0x7FEB352D


# ---------------------------------------------------------------------------
# Counter hash. torch has no uint32 + or >> on the CPU, so uint32 values are
# held in int64 and every product is split into 16-bit halves, which keeps
# it below 2^63 and exact: the bits equal the JAX uint32 bits.

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    hi = ((x >> 16) * c) & 0xFFFF
    return ((hi << 16) + (x & 0xFFFF) * c) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & _M32


def _perlane_bits(q: int, lane: torch.Tensor, t_abs: int) -> torch.Tensor:
    """(Q, B) hash bits (uint32 values in int64), feature-major: lane row 0
    the per-lane seeds, row 1 the lease times (absolute sample index)."""
    s = _u32(lane[0])[None, :]
    tl = _u32(t_abs - lane[1].to(torch.int64))[None, :]
    qi = torch.arange(q, dtype=torch.int64, device=lane.device)[:, None]
    return _mix32((s + _mul32(tl, _PL_T) + _mul32(qi, _PL_Q)) & _M32)


def _gumbel_bits(q: int, bsz: int, seed: int, device) -> torch.Tensor:
    """(Q, B) counter-hash bits over the whole batch (global_rng): the JAX
    kernel's CPU branch; the TPU hardware PRNG has no counterpart."""
    ctr = (
        torch.arange(q, dtype=torch.int64, device=device)[:, None] * bsz
        + torch.arange(bsz, dtype=torch.int64, device=device)[None, :]
    ) & _M32
    return _mix32((int(seed) + _mul32(ctr, _PL_T)) & _M32)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """-log(-log(u)), u = ((bits >> 8) + 0.5) * 2^-24, float32. Each log is
    taken in float64 and rounded to float32, so the CPU, the card and the
    CUDA kernel (`gumbel` in csrc/common.cuh) give the same noise; against
    XLA's float32 log the result is within an ulp."""
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    l1 = torch.log(u.double()).float()
    return -(torch.log((-l1).double()).float())


def _inv_temp(temperature: float) -> float:
    """f32(1/tau): JAX folds the weak-typed double constant to float32."""
    return float(np.float32(1.0 / temperature))


def sample_fm(logits, temperature, lane, t_abs, seed_base, forced_t):
    """Gumbel-max sampling of feature-major logits (Q, B), as the kernel:
    first-max argmax, then the forced override."""
    q, b = logits.shape
    if temperature > 0.0:
        if lane is not None:
            gum = gumbel_from_bits(_perlane_bits(q, lane, t_abs))
        else:
            gum = gumbel_from_bits(
                _gumbel_bits(q, b, seed_base + t_abs, logits.device)
            )
        if lane is not None and lane.shape[0] == 3:
            inv = lane[2].contiguous().view(torch.float32)[None, :]
            scores = torch.where(inv > 0.0, logits * inv + gum, logits)
        else:
            inv = torch.tensor(_inv_temp(temperature), device=logits.device)
            scores = logits * inv + gum
    else:
        scores = logits
    m = scores.max(dim=0, keepdim=True).values
    row = torch.arange(q, dtype=torch.int32, device=logits.device)[:, None]
    cls = torch.where(scores >= m, row, q).min(dim=0).values.to(torch.int32)
    return torch.where(forced_t >= 0, forced_t, cls)


# ---------------------------------------------------------------------------
# Carry layout.

def estack_feature_major(estack: torch.Tensor) -> torch.Tensor:
    """(K-1, B, C) embedding stack -> ((K-1)*C, B): C-row block j holds
    estack[j]^T (oldest tap first)."""
    k1, b, c = estack.shape
    return estack.transpose(1, 2).reshape(k1 * c, b).to(torch.float32)


def mega_zero_carry(arch: ArchConfig, h0: torch.Tensor, estack0: torch.Tensor):
    """Initial streaming carry (feature-major): empty rings, zero staged
    pairs, frontend from the zero class (generate._fused_frontend_zero)."""
    b, c = h0.shape
    L = len(arch.dilations)
    dev = h0.device
    return {
        "bufs": torch.zeros((sum(arch.dilations) * c, b), device=dev),
        "hstate": torch.zeros((L * 2 * c, b), device=dev),
        "h_s": h0.t().to(torch.float32).contiguous(),
        "e_s": estack_feature_major(estack0).contiguous(),
    }


# ---------------------------------------------------------------------------
# Plain version.

def mega_generate_plain(params, lp, arch: ArchConfig, carry: dict, t0: int,
                        forced: torch.Tensor, temperature: float,
                        emit_logits: bool, lane, seed_base: int,
                        tensor_cores: Optional[bool] = None, cond=None):
    """PyTorch version of the kernel on any device, op for op as the JAX
    kernel. forced (T, B) int32; cond (T, B, Cc') or None, against the
    folded lp["w_cond"]. Updates `carry` in place; returns (classes (T, B)
    int32, logits (T, Q, B) or None). With tensor_cores (the default on a
    CUDA carry in bf16 at widths the kernel takes, ar_tc.default_order)
    each product is summed as the bf16 kernel sums it on the tensor cores
    (ar_tc.tc_product), the cond k-steps continuing the gate's chain before
    the bias, so the two agree bit for bit; otherwise in one fp32 product,
    as the fp32 kernel's in-order sums (and kernel B7's) come out, cond's
    after the bias (the JAX order)."""
    dt = compute_dtype(arch)
    dils = arch.dilations
    c = arch.residual_channels
    k_taps = arch.input_kernel
    pp = params["post"]
    w_in = params["input_conv"]["w"]
    cc = 0 if cond is None else cond.shape[-1]
    if tensor_cores is None:
        tensor_cores = ar_tc.default_order(arch, dt, carry["h_s"].device, cc)

    def mm(w, a):  # (M, K) @ (K, B), weights pre-rounded
        return ar_tc.tc_product(w, rnd(a, dt)) if tensor_cores else w @ rnd(a, dt)

    wcat = rnd(torch.cat([lp["w_cur"], lp["w_prev"]], 1).transpose(1, 2), dt)
    if cc:
        wcond = rnd(lp["w_cond"].transpose(1, 2), dt)          # (L, 2G, Cc')
        if tensor_cores:  # one chain over [h ; tap ; cond]
            wcat = torch.cat([wcat, wcond], 2)
    wrs = rnd(torch.cat([lp["w_res"], lp["w_skip"]], 2).transpose(1, 2), dt)
    bcat = lp["b"][:, :, None]
    brs = torch.cat([lp["b_res"], lp["b_skip"]], 1)[:, :, None]
    w1t, w2t = rnd(pp["w1"].t(), dt), rnd(pp["w2"].t(), dt)
    b1, b2 = pp["b1"][:, None], pp["b2"][:, None]
    embr = rnd(params["embed"], dt)                        # (Q, C)
    wicur = rnd(w_in[k_taps - 1].t(), dt)
    wipast = rnd(w_in[: k_taps - 1].transpose(1, 2), dt)
    bi = params["input_conv"]["b"][:, None]

    bufs, hst, e_s = carry["bufs"], carry["hstate"], carry["e_s"]
    h = carry["h_s"].clone()
    n_steps = forced.shape[0]
    classes, logits_all = [], []
    offs = buffer_offsets(arch)
    for t in range(n_steps):
        t_abs = t0 + t
        skip = None
        for l, d in enumerate(dils):
            r0 = l * 2 * c
            if d > 1:
                slot = (offs[l] + t_abs % d) * c
                hst[r0 + c: r0 + 2 * c] = bufs[slot: slot + c]
                bufs[slot: slot + c] = h
            else:
                hst[r0 + c: r0 + 2 * c] = hst[r0: r0 + c]
            hst[r0: r0 + c] = h
            if cc and tensor_cores:
                pre = mm(wcat[l], torch.cat([hst[r0: r0 + 2 * c], cond[t].t()], 0)) + bcat[l]
            else:
                pre = mm(wcat[l], hst[r0: r0 + 2 * c]) + bcat[l]
                if cc:
                    pre = pre + mm(wcond[l], cond[t].t())
            g = pre.shape[0] // 2
            z = torch.tanh(pre[:g]) * torch.sigmoid(pre[g:])
            rs = mm(wrs[l], z)
            h = h + rs[:c] + brs[l][:c]
            contrib = rs[c:] + brs[l][c:]
            skip = contrib if skip is None else skip + contrib
        hidden = torch.relu(mm(w1t, torch.relu(skip)) + b1)
        logits = mm(w2t, hidden) + b2                     # (Q, B)
        if emit_logits:
            logits_all.append(logits)
        cls = sample_fm(logits, temperature, lane, t_abs, seed_base, forced[t])
        classes.append(cls)
        e_next = embr[cls.long()].t()                     # (C, B)
        h = bi + mm(wicur, e_next)
        for j in range(k_taps - 1):
            h = h + mm(wipast[j], e_s[j * c: (j + 1) * c])
        if k_taps > 1:
            e_s[: (k_taps - 2) * c] = e_s[c:].clone()
            e_s[(k_taps - 2) * c:] = e_next
    carry["h_s"].copy_(h)
    return (
        torch.stack(classes),
        torch.stack(logits_all) if emit_logits else None,
    )


# ---------------------------------------------------------------------------
# Kernel.

class _MegaArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "bufs", "hstate", "h_s", "e_s", "dils", "wcat", "bcat", "wrs", "brs",
        "w1", "b1", "w2", "b2", "emb", "w_in", "b_in", "forced", "lane",
        "classes", "logits",
    )] + [(n, ctypes.c_int) for n in (
        "B", "T", "t0", "L", "C", "G", "S", "Q", "K", "lane_rows",
        "seed_base", "mode",
    )] + [("inv_temp", ctypes.c_float)] + [
        (n, ctypes.c_int) for n in ("bf16", "n_d1")
    ] + [(n, ctypes.c_void_p) for n in ("wpk", "prods")] + [
        (n, ctypes.c_int) for n in ("n_prod", "grid", "tc")
    ] + [(n, ctypes.c_void_p) for n in ("cond", "wcond")] + [("Cc", ctypes.c_int)]


def _library() -> ctypes.CDLL:
    lib = build.load("ar_mega")
    tile = lib.wn_mega_lane_tile()
    if tile != LANE_TILE:
        raise RuntimeError(f"ar_mega.cu lane tile {tile} != LANE_TILE {LANE_TILE}")
    return lib


def mega_generate_cuda(params, lp, arch: ArchConfig, carry: dict, t0: int,
                       forced: torch.Tensor, temperature: float,
                       emit_logits: bool, lane, seed_base: int, cond=None):
    """The kernel: same contract as mega_generate_plain."""
    dev = carry["h_s"].device
    dt = compute_dtype(arch)
    c, b = carry["h_s"].shape
    L = len(arch.dilations)
    s, q, k = arch.skip_channels, arch.quant_channels, arch.input_kernel
    n_steps = forced.shape[0]
    if b % LANE_TILE:
        raise ValueError(
            f"mega kernel needs batch % {LANE_TILE} == 0, got {b}; pad the "
            "batch (generate.padded_stream_batch)"
        )
    shapes = {
        "bufs": (sum(arch.dilations) * c, b), "hstate": (L * 2 * c, b),
        "h_s": (c, b), "e_s": ((k - 1) * c, b),
    }
    for name, shape in shapes.items():
        t = carry[name]
        if t.shape != shape or t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"carry[{name!r}] must be a contiguous float32 {shape} on "
                f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    pp = params["post"]

    def w(x):
        return x.to(dev, dt).contiguous()

    def f(x):
        return x.to(dev, torch.float32).contiguous()

    bf16 = dt == torch.bfloat16
    cc = 0 if cond is None else cond.shape[-1]
    tc = ar_tc.route(arch, dt, cc) == "tensor_cores"
    w_cond = lp["w_cond"] if cc else None

    def merge():  # the kernel's weight layout, made once per weight set
        out = {
            "bcat": f(lp["b"]),
            "brs": f(torch.cat([lp["b_res"], lp["b_skip"]], 1)),
            "b1": f(pp["b1"]), "b2": f(pp["b2"]),
            "emb": w(params["embed"]),
            "b_in": f(params["input_conv"]["b"]),
        }
        if tc:     # the tensor-core kernel streams every product's weights from wpk
            return {**out, **ar_tc.pack_stream(ar_tc.step_stream(params, lp, arch, w_cond),
                                               dev),
                    **dict.fromkeys(("wcat", "wrs", "w1", "w2", "w_in", "wcond"))}
        return {**out, "wpk": None, "prods": None,
                "wcond": None if w_cond is None else w(w_cond),
                "wcat": w(torch.cat([lp["w_cur"], lp["w_prev"]], 1)),
                "wrs": w(torch.cat([lp["w_res"], lp["w_skip"]], 2)),
                "w1": w(pp["w1"]), "w2": w(pp["w2"]),
                "w_in": w(params["input_conv"]["w"])}

    sources = (
        *(lp[k] for k in ("w_cur", "w_prev", "b", "w_res", "w_skip",
                          "b_res", "b_skip")),
        *(pp[k] for k in ("w1", "b1", "w2", "b2")), params["embed"],
        params["input_conv"]["w"], params["input_conv"]["b"],
    ) + (() if w_cond is None else (w_cond,))
    if lp["w_cur"].shape != (L, c, 2 * arch.gate_channels) \
            or lp["w_prev"].shape != lp["w_cur"].shape:
        raise ValueError(f"w_cur/w_prev do not match the arch: {lp['w_cur'].shape}")
    if cc:
        if w_cond.shape != (L, cc, 2 * arch.gate_channels):
            raise ValueError(f"w_cond {tuple(w_cond.shape)} does not match cond "
                             f"{tuple(cond.shape)}")
        cond = cond.to(dev, dt).contiguous()
        if cond.shape != (n_steps, b, cc):
            raise ValueError(f"cond must be (T, B, Cc) = {(n_steps, b, cc)}, got "
                             f"{tuple(cond.shape)}")
    ops = dict(build.prepared(f"mega_generate {dev} {dt} tc={tc}", sources, merge))
    ops["forced"] = forced.to(dev, torch.int32).contiguous()
    ops["lane"] = None if lane is None else lane.to(dev, torch.int32).contiguous()
    if ops["forced"].shape != (n_steps, b):
        raise ValueError(f"forced must be (T, {b}), got {tuple(forced.shape)}")
    classes = torch.empty((n_steps, b), dtype=torch.int32, device=dev)
    logits = (
        torch.empty((n_steps, q, b), dtype=torch.float32, device=dev)
        if emit_logits else None
    )
    mode = 0 if temperature <= 0.0 else (1 if lane is not None else 2)
    ptr = build.ptr
    args = _MegaArgs(
        ptr(carry["bufs"]), ptr(carry["hstate"]), ptr(carry["h_s"]),
        ptr(carry["e_s"]), ptr(build.int32_table(tuple(arch.dilations), str(dev))),
        *(ptr(ops[n]) for n in (
            "wcat", "bcat", "wrs", "brs", "w1", "b1", "w2", "b2", "emb",
            "w_in", "b_in", "forced", "lane",
        )),
        ptr(classes), ptr(logits),
        b, n_steps, int(t0), L, c, arch.gate_channels, s, q, k,
        0 if lane is None else lane.shape[0], int(seed_base), mode,
        _inv_temp(temperature) if temperature > 0.0 else 0.0,
        int(bf16), sum(1 for d in arch.dilations if d == 1),
        ptr(ops["wpk"]), ptr(ops["prods"]), 0 if ops["prods"] is None else len(ops["prods"]),
        ar_tc.launch_shape(b)[0], int(tc),
        ptr(cond), ptr(ops["wcond"]), cc,
    )
    mega_generate.launches += build.launch(_library(), "wn_mega_generate", args, dev)
    return classes, logits


def mega_generate(
    params: dict,
    lp: dict,                       # layer params
    arch: ArchConfig,
    h0: Optional[torch.Tensor],     # (B, C) first-step residual input
    e0: Optional[torch.Tensor],     # (K-1, B, C) carried embedding stack
    seed_base,                      # int (or 0-d tensor)
    forced_ts: torch.Tensor,        # (T, 1, B) int32
    cond_ts: Optional[torch.Tensor],
    n_samples: int,
    temperature: float,
    has_cond: bool,
    emit_logits: bool = False,
    streaming: bool = False,
    carry: Optional[dict] = None,   # mega_zero_carry-shaped (streaming only)
    t0: int = 0,                    # absolute chunk start
    lane: Optional[torch.Tensor] = None,  # (2|3, B) int32 lane block
):
    """Run the whole generation loop; returns classes (T, 1, B) int32 (plus
    logits (T, Q, B) when emit_logits). With streaming=True also returns
    the carry, updated in place: ring slots and the sampling counters use
    the ABSOLUTE time t0 + t, so chunked output continues the one-shot
    sequence exactly. One-shot calls run from mega_zero_carry(h0, e0).
    has_cond: cond_ts (T, B, Cc') against the folded lp["w_cond"], row t
    at the chunk's step t."""
    if has_cond != (cond_ts is not None):
        raise ValueError("pass cond_ts exactly when has_cond")
    if not streaming:
        carry = mega_zero_carry(arch, h0, e0)
        t0 = 0
    forced = forced_ts[:n_samples, 0, :]
    dev = carry["h_s"].device
    if dev.type == "cpu":
        run = mega_generate_plain
    elif dev.type == "cuda":
        run = mega_generate_cuda
    else:
        raise ValueError(f"mega_generate runs on cpu or cuda, not {dev}")
    classes, logits = run(
        params, lp, arch, carry, int(t0), forced, temperature, emit_logits,
        lane, int(seed_base), cond=None if cond_ts is None else cond_ts[:n_samples],
    )
    classes = classes[:, None, :]
    out = (classes, logits) if emit_logits else (classes,)
    if streaming:
        out = out + (carry,)
    return out if len(out) > 1 else out[0]


mega_generate.launches = 0
