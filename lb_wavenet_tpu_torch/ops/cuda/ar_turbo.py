"""turbo_step: one whole sample step per launch (CUDA kernel
`csrc/ar_turbo.cu`): all L layers, the post network, Gumbel-max sampling,
the forced override and the next step's embedding and input conv.

Replaces `lb_wavenet_tpu/ops/pallas/ar_turbo.py` (`turbo_step`, body
`_turbo_kernel`). Arithmetic follows the TPU kernel: the split layer order
of the `pallas` engine, pre = (h @ w_cur + tap @ w_prev) + b (not mega's
merged [h | tap] contraction), operands in the compute dtype, fp32 sums;
the finale as in mega. Everything is batch-major, as in the JAX kernel.

Sampling: greedy at temperature 0; by default the per-lane counter hash
(the lane block (2|3, B): seeds, lease times, optional f32(1/tau) bits with
inv == 0 a greedy lane). With `global_rng` (no lane block) the TPU kernel
draws from the TPU's hardware PRNG, which has no counterpart on the card;
the port takes the JAX kernel's interpret-mode branch instead, the counter
hash mix(seed_base + t + (b * Q + q) * 0x9E3779B9), so the port's turbo
stream equals the JAX kernel's stream in interpret mode.

The ring (sum_d, B, C) is updated IN PLACE (the JAX kernel aliases it onto
its output). `turbo_generate` runs the steps t0 .. t0 + T - 1 of a chunk,
one launch each, with h and the embedding stack carried in place; the
kernel computes each step's ring slots and seed from t, so the chunk is
queued without a host round trip. A CPU tensor takes the plain version
(`turbo_generate_plain`); a CUDA tensor launches the kernel or raises.

Conditioning: `cond` (T, B, Cc') holds each step's conditioning row, mel
and/or speaker folded into one (generate._fold_gcond), against the folded
lp["w_cond"] (L, Cc', 2G); step i of a chunk reads row i.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...config import ArchConfig
from ...models.wavenet import _mm, compute_dtype, rnd
from . import ar_tc, build
from .ar_mega import _gumbel_bits, _inv_temp, _perlane_bits, gumbel_from_bits
from .ar_step import fused_stack_plain
from .train_stack import LAYER_KEYS


def sample_bm(logits, temperature: float, lane, t: int, seed_base: int, forced):
    """Gumbel-max sampling of batch-major logits (B, Q) at absolute step t,
    as the kernel: first-max argmax, then the forced override."""
    b, q = logits.shape
    if temperature > 0.0:
        if lane is not None:
            gum = gumbel_from_bits(_perlane_bits(q, lane, t)).t()
        else:   # the counter of (b, q) is b * Q + q: mega's hash with B and Q swapped
            gum = gumbel_from_bits(_gumbel_bits(b, q, seed_base + t, logits.device))
        if lane is not None and lane.shape[0] == 3:
            inv = lane[2].contiguous().view(torch.float32)[:, None]
            scores = torch.where(inv > 0.0, logits * inv + gum, logits)
        else:
            inv = torch.tensor(_inv_temp(temperature), device=logits.device)
            scores = logits * inv + gum
    else:
        scores = logits
    m = scores.max(dim=-1, keepdim=True).values
    col = torch.arange(q, dtype=torch.int32, device=logits.device)[None, :]
    cls = torch.where(scores >= m, col, q).min(dim=-1).values.to(torch.int32)
    return torch.where(forced >= 0, forced, cls)


def turbo_generate_plain(params, lp, arch: ArchConfig, state: dict, t0: int,
                         forced: torch.Tensor, temperature: float, emit_logits: bool,
                         lane, seed_base: int, tensor_cores: Optional[bool] = None,
                         cond=None):
    """PyTorch version of the kernel on any device, step for step as the JAX
    kernel. state {"bufs", "h", "e"} is updated in place; forced (T, B)
    int32. Returns (classes (T, B) int32, logits (T, B, Q) or None). With
    tensor_cores (the default on a CUDA state in bf16 at widths the kernel
    takes, ar_tc.default_order) each product is summed as the bf16 kernel
    sums it (ar_tc.tc_mm), so the two agree bit for bit; otherwise in one
    fp32 product, as the fp32 kernel's in-order sums come out. cond (T, B,
    Cc') or None: the layers' cond term (ar_step.fused_stack_plain)."""
    dt = compute_dtype(arch)
    if tensor_cores is None:
        tensor_cores = ar_tc.default_order(arch, dt, state["h"].device,
                                           0 if cond is None else cond.shape[-1])

    def mm(x, w):
        return ar_tc.tc_mm(rnd(x, dt), rnd(w, dt)) if tensor_cores else _mm(x, w, dt)

    k_taps = arch.input_kernel
    w_in, b_in = params["input_conv"]["w"], params["input_conv"]["b"]
    pp = params["post"]
    embr = rnd(params["embed"], dt)
    h, e = state["h"], state["e"]
    classes, logits_all = [], []
    for i in range(forced.shape[0]):
        t = t0 + i
        _, skip = fused_stack_plain(lp, arch, h, state["bufs"], t, mm,
                                    None if cond is None else cond[i], tensor_cores)
        hidden = torch.relu(mm(torch.relu(skip), pp["w1"]) + pp["b1"])
        logits = mm(hidden, pp["w2"]) + pp["b2"]
        if emit_logits:
            logits_all.append(logits)
        cls = sample_bm(logits, temperature, lane, t, seed_base, forced[i])
        classes.append(cls)
        e_next = embr[cls.long()]
        h = b_in + mm(e_next, w_in[k_taps - 1])
        for j in range(k_taps - 1):
            h = h + mm(e[j], w_in[j])
        if k_taps > 1:
            e = torch.cat([e[1:], e_next[None]], 0)
    state["h"].copy_(h)
    state["e"].copy_(e)
    return torch.stack(classes), torch.stack(logits_all) if emit_logits else None


class _TurboArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "bufs", "h", "e", "dils", *LAYER_KEYS,
        "w1", "b1", "w2", "b2", "emb", "w_in", "b_in", "forced", "lane", "classes",
        "logits",
    )] + [(n, ctypes.c_int) for n in (
        "B", "L", "C", "G", "S", "Q", "K", "lane_rows", "seed_base", "mode",
    )] + [("inv_temp", ctypes.c_float), ("bf16", ctypes.c_int)] + [
        (n, ctypes.c_void_p) for n in ("wpk", "prods")] + [
        (n, ctypes.c_int) for n in ("n_prod", "grid")] + [("brs", ctypes.c_void_p),
                                                              ("tc", ctypes.c_int)] + [
        (n, ctypes.c_void_p) for n in ("cond", "w_cond")] + [("Cc", ctypes.c_int)]


def turbo_generate_cuda(params, lp, arch: ArchConfig, state: dict, t0: int,
                        forced: torch.Tensor, temperature: float, emit_logits: bool,
                        lane, seed_base: int, cond=None):
    """The kernel, one launch per step: same contract as
    turbo_generate_plain."""
    dev = state["h"].device
    dt = compute_dtype(arch)
    b, c = state["h"].shape
    L, k = len(arch.dilations), arch.input_kernel
    q = arch.quant_channels
    n_steps = forced.shape[0]
    for name, shape in (("bufs", (sum(arch.dilations), b, c)), ("h", (b, c)),
                        ("e", (k - 1, b, c))):
        x = state[name]
        if x.shape != shape or x.dtype != torch.float32 or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"state[{name!r}] must be a contiguous float32 {shape} on "
                             f"{dev}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    pp = params["post"]
    names = ("w1", "b1", "w2", "b2")

    bf16 = dt == torch.bfloat16
    cc = 0 if cond is None else cond.shape[-1]
    tc = ar_tc.route(arch, dt, cc) == "tensor_cores"
    w_cond = lp["w_cond"] if cc else None

    def cast():  # weights in the compute dtype, biases fp32, once per weight set
        out = {n: lp[n] for n in LAYER_KEYS}
        out["w_cond"] = w_cond
        out.update({n: pp[n] for n in names}, emb=params["embed"],
                   w_in=params["input_conv"]["w"], b_in=params["input_conv"]["b"],
                   brs=torch.cat([lp["b_res"], lp["b_skip"]], 1) if tc else None)
        if tc:     # the tensor-core kernel reads every product's weights from wpk
            out = {n: v if n in ("b", "b1", "b2", "brs", "emb", "b_in") else None
                   for n, v in out.items()}
        out = {n: None if v is None else
               v.to(dev, torch.float32 if n.startswith("b") else dt).contiguous()
               for n, v in out.items()}
        out.update(ar_tc.pack_stream(ar_tc.step_stream(params, lp, arch, w_cond), dev) if tc
                   else {"wpk": None, "prods": None})
        return out

    if lp["w_cur"].shape != (L, c, 2 * arch.gate_channels):
        raise ValueError(f"w_cur does not match the arch: {tuple(lp['w_cur'].shape)}")
    sources = (*(lp[n] for n in LAYER_KEYS), *(pp[n] for n in names), params["embed"],
               params["input_conv"]["w"], params["input_conv"]["b"]) + (
        () if w_cond is None else (w_cond,))
    if cc:
        if w_cond.shape != (L, cc, 2 * arch.gate_channels):
            raise ValueError(f"w_cond {tuple(w_cond.shape)} does not match cond "
                             f"{tuple(cond.shape)}")
        cond = cond.to(dev, dt).contiguous()
        if cond.shape != (n_steps, b, cc):
            raise ValueError(f"cond must be (T, B, Cc) = {(n_steps, b, cc)}, got "
                             f"{tuple(cond.shape)}")
    ops = dict(build.prepared(f"turbo_step {dev} {dt} tc={tc}", sources, cast))
    ops["forced"] = forced.to(dev, torch.int32).contiguous()
    if ops["forced"].shape != (n_steps, b):
        raise ValueError(f"forced must be (T, {b}), got {tuple(forced.shape)}")
    ops["lane"] = None if lane is None else lane.to(dev, torch.int32).contiguous()
    classes = torch.empty((n_steps, b), dtype=torch.int32, device=dev)
    logits = (torch.empty((n_steps, b, q), dtype=torch.float32, device=dev)
              if emit_logits else None)
    ptr = build.ptr
    args = _TurboArgs(
        ptr(state["bufs"]), ptr(state["h"]), ptr(state["e"]),
        ptr(build.int32_table(tuple(arch.dilations), str(dev))),
        *(ptr(ops[n]) for n in (*LAYER_KEYS, *names, "emb", "w_in", "b_in", "forced",
                                "lane")),
        ptr(classes), ptr(logits),
        b, L, c, arch.gate_channels, arch.skip_channels, q, k,
        0 if lane is None else lane.shape[0], int(seed_base),
        0 if temperature <= 0.0 else (1 if lane is not None else 2),
        _inv_temp(temperature) if temperature > 0.0 else 0.0, int(bf16),
        ptr(ops["wpk"]), ptr(ops["prods"]), 0 if ops["prods"] is None else len(ops["prods"]),
        ar_tc.launch_shape(b)[0], ptr(ops["brs"]), int(tc),
        ptr(cond), ptr(ops["w_cond"]), cc,
    )
    lib = build.load("ar_turbo")
    fn = lib.wn_turbo_steps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    count = ctypes.c_int(0)
    err = fn(ctypes.addressof(args), int(t0), n_steps,
             torch.cuda.current_stream(dev).cuda_stream, ctypes.addressof(count))
    turbo_step.launches += count.value
    if err != 0:
        lib.wn_error_string.restype = ctypes.c_char_p
        lib.wn_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"wn_turbo_steps: CUDA error {err}: "
                           f"{lib.wn_error_string(err).decode()}")
    return classes, logits


def turbo_generate(params, lp, arch: ArchConfig, state: dict, t0: int,
                   forced: torch.Tensor, temperature: float, emit_logits: bool = False,
                   lane: Optional[torch.Tensor] = None, seed_base: int = 0, cond=None):
    """Steps t0 .. t0 + T - 1 from state {"bufs" (sum_d, B, C), "h" (B, C),
    "e" (K-1, B, C)}, updated in place; forced (T, B) int32, -1 free-runs;
    cond (T, B, Cc') or None, against the folded lp["w_cond"]. Returns
    (classes (T, B) int32, logits (T, B, Q) or None)."""
    run = (turbo_generate_cuda if build.on_card(state["h"].device, "turbo_step")
           else turbo_generate_plain)
    return run(params, lp, arch, state, int(t0), forced, temperature, emit_logits, lane,
               int(seed_base), cond=cond)


def turbo_step(
    params: dict,
    lp: dict,
    arch: ArchConfig,
    h0: torch.Tensor,             # (B, C) residual input of this step
    estack: torch.Tensor,         # (K-1, B, C) carried input-conv embeddings
    bufs: torch.Tensor,           # (sum_d, B, C) ring, updated in place
    t: int,                       # absolute step: ring slots and seed
    seed_base: int,               # global_rng: the step's seed is seed_base + t
    forced_t: torch.Tensor,       # (B,) or (B, 1) int32, -1 = sample freely
    cond_t: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    has_cond: bool = False,
    lane: Optional[torch.Tensor] = None,  # (2|3, B) int32 lane block
    emit_logits: bool = False,
):
    """One step; returns (bufs, cls (B,), new estack, h0_next[, logits
    (B, Q)]), as the JAX turbo_step (which takes the step's slots and seed
    instead of t and seed_base). has_cond: cond_t (B, Cc') against the
    folded lp["w_cond"]."""
    if has_cond != (cond_t is not None):
        raise ValueError("pass cond_t exactly when has_cond")
    state = {"bufs": bufs, "h": h0.to(torch.float32).clone(),
             "e": estack.to(torch.float32).clone()}
    classes, logits = turbo_generate(params, lp, arch, state, t, forced_t.reshape(1, -1),
                                     temperature, emit_logits, lane, seed_base,
                                     None if cond_t is None else cond_t[None])
    out = (bufs, classes[0], state["e"], state["h"])
    return out + (logits[0],) if emit_logits else out


turbo_step.launches = 0
