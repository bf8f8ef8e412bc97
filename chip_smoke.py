#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (`lb_wavenet_tpu_torch`, never JAX) at WaveNet-30 full width
(configs/wavenet30.json: 3x10 dilations, C=G=64, S=Q=256, bf16 compute) with
random weights seeded by numpy, in phases; any failure exits non-zero:

  1. environment: CUDA, the card and its power limit, triton, nvcc; build
     every kernel from lb_wavenet_tpu_torch/csrc with nvcc (sm_90a), one
     nvcc per source, all started together;
  2. each kernel against its plain PyTorch version on the card at B=512:
     fused_stack (one step at a mid-stream t: ring and skip), mega_generate
     (teacher-forced logits and carry over one 1024-step streaming chunk at
     a mid-stream t0 with a 3-row lane block, as the pool calls it; greedy,
     per-lane 2-row and 3-row lane blocks over 256 steps from the zero
     carry: first divergent step reported, and every class the kernel
     picked must be a near-argmax of the plain version's scores on the
     kernel's own history), turbo_step (one step at a mid-stream t, then
     teacher-forced logits and state over a 256-step chunk, then greedy and
     per-lane free runs of 128 steps under the same near-argmax check);
  3. serving: SessionPool(engine="mega", device="cuda"), pool batch 512,
     chunk 1024, pipelined, 12 requests of 8000-24000 samples with seeds and
     temperatures {0, 0.7, 1.0}, the last 4 on recycled lanes; a sampled
     request replayed on a dedicated session must match bit for bit; the
     same requests through `python -m lb_wavenet_tpu_torch.cli serve` from a
     save_params checkpoint must write the same audio;
  4. the pallas engine (fused_stack per step) at B=512;
  5. the turbo engine: SessionPool(engine="turbo") at pool batch 100 (not a
     multiple of the lane tile), 6 requests with seeds and temperatures, a
     sampled one replayed bit-identically on a dedicated session, and
     `cli serve --set gen.engine=turbo` writing the pool's audio;
  6. the training kernels against their plain versions at the training
     shapes (B=8, W=10240, T=13310): the frontend pair, the train stack
     (tapcat off and on) and the post-loss, values and every gradient leaf,
     through autograd;
  7. training: run_training on synthetic_corpus with the wavenet30.json
     train recipe as written (fused frontend + fused stack + tapcat + fused
     post), 20 steps with the loss of each, the frontend kernels launched
     every step and no plain frontend op; then at a fixed state the fused
     step against its plain versions, the unfused PyTorch step and a
     grad_accum=2 step against the one-shot step, a resume from the
     checkpoint, and `python -m lb_wavenet_tpu_torch.cli train` for 2 steps
     followed by `serve` and `eval` from its checkpoint directory;
  8. evaluation: `evaluate` of the trained params on a held-out
     synthetic_corpus (another seed), fused and plain forward, and a short
     run_training with in-training eval records;
  9. timings at the serving and training shapes and the `kernels` JSON
     line, the card's name and power limit, and last the {"ok": true, ...}
     line.

Launch counts are set to 0 right before each path is driven and read right
after; comparison launches are not counted.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 512             # lanes (the pool batch)
CHUNK = 1024        # samples per serving step
T_CHECK = 256       # steps of the kernel-vs-plain mega checks
T_TURBO = 128       # steps of the turbo free-run checks
TURBO_POOL = 100    # turbo pool batch: not a multiple of the lane tile
LOGIT_ATOL = 5e-2   # bf16 operands: a flipped rounding moves logits ~1e-2
TRAIN_B, TRAIN_W = 8, 10240   # wavenet30.json train batch and window
TRAIN_STEPS = 20
STEP_PARTS = 5      # steps timed part by part
# Kernel vs plain at the training shapes, as max abs error over the leaf's
# max abs value: the same bf16-rounded operands, fp32 sums in another order.
KERNEL_RTOL = 1e-2
# A whole step through the kernels vs through their plain versions: the
# post-loss backward's dskip differs by reordered fp32 sums (5e-4 of its
# largest value), which the stack carries into dh0, and the input conv's
# gradient sums it over 106k positions with cancellation. Read 5.4e-3
# (input_conv.w) on an H100 at this phase's fixed state; the limit is about
# twice that.
STEP_RTOL = 1e-2
# grad_accum=2 vs the one-shot step: dlogits are rounded to bf16 at another
# scale (the cotangent is 1 per micro instead of 1 / mask sum). Read 8.4e-3
# on an H100 at this phase's fixed state.
ACCUM_RTOL = 1.5e-2
# Fused step vs the unfused PyTorch step (frontend, stack and post-loss as
# autograd of the plain forward): autograd rounds every gradient that enters
# a bf16 product (the hand-written backwards round only the operands), so
# leaves built from cancelling sums differ by ~9% of their largest value
# (read 9.1e-2, layers.w_cur, on an H100 at this phase's fixed state); the
# limit is about twice that reading.
UNFUSED_RTOL = 0.18
# Eval through the fused stack vs the plain forward: the same bf16 operands,
# the skip sum in another order (read 1.3e-5 nats on an H100).
EVAL_NLL_ATOL = 1e-4
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak (H100 SXM data sheet)
H100_BYTES_S = 3.35e12    # HBM3 bandwidth (H100 SXM data sheet)


KERNEL_SOURCES = ("ar_step", "ar_mega", "ar_turbo", "frontend", "train_stack", "post_loss")


class SmokeFailure(Exception):
    pass


def log(*a):
    print(*a, flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def numpy_params(arch, seed: int) -> dict:
    """LeCun-normal weights and small random biases from a numpy seed, in
    the JAX package's layout."""
    import numpy as np

    rng = np.random.default_rng(seed)
    L, C, G = len(arch.dilations), arch.residual_channels, arch.gate_channels
    S, Q, K = arch.skip_channels, arch.quant_channels, arch.input_kernel

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    def b(*shape):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "embed": w(Q, C),
        "input_conv": {"w": w(K, C, C), "b": b(C)},
        "layers": {
            "w_prev": w(L, C, 2 * G), "w_cur": w(L, C, 2 * G), "b": b(L, 2 * G),
            "w_res": w(L, G, C), "b_res": b(L, C),
            "w_skip": w(L, G, S), "b_skip": b(L, S),
        },
        "post": {"w1": w(S, S), "b1": b(S), "w2": w(S, Q), "b2": b(Q)},
    }


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after a warm-up)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mega_cost(arch, b: int, t: int, lane_rows: int, wbytes: int):
    """(bytes, flops) one mega_generate call must move and do: weights,
    biases, the carry read and written once, forced/lane in, classes out."""
    L, C, G = len(arch.dilations), arch.residual_channels, arch.gate_channels
    S, Q, K = arch.skip_channels, arch.quant_channels, arch.input_kernel
    w = L * (2 * C * 2 * G + G * (C + S)) + S * S + S * Q + Q * C + K * C * C
    bias = L * (2 * G + C + S) + S + Q + C
    carry = (sum(arch.dilations) * C + L * 2 * C + C + (K - 1) * C) * b
    nbytes = w * wbytes + 4 * (bias + 2 * carry + t * b + lane_rows * b + t * b)
    flops = 2 * b * t * (L * (2 * C * 2 * G + G * (C + S)) + S * S + S * Q + K * C * C)
    return nbytes, flops


def stack_cost(arch, b: int, wbytes: int):
    """(bytes, flops) of one fused_stack step: weights, biases, h0, the L
    ring rows read and written, the skip sum out."""
    L, C, G, S = (len(arch.dilations), arch.residual_channels,
                  arch.gate_channels, arch.skip_channels)
    w = L * (2 * C * 2 * G + G * C + G * S)
    nbytes = w * wbytes + 4 * (L * (2 * G + C + S) + b * C + 2 * L * b * C + b * S)
    return nbytes, 2 * b * L * (2 * C * 2 * G + G * C + G * S)


def train_stack_cost(arch, b: int, t: int, wbytes: int, backward: bool):
    """(bytes, flops) of the training stack's forward or backward at
    (b, t), as the TPU kernels define the function: each input read once,
    each output written once. The layer inputs x_all that the port's
    forward also stores (so its backward need not reconstruct x) are not
    counted: the function does not need them."""
    L, C, G, S = (len(arch.dilations), arch.residual_channels,
                  arch.gate_channels, arch.skip_channels)
    w = L * (2 * C * 2 * G + G * C + G * S)
    bias = L * (2 * G + C + S)
    z_all = L * b * t * G * wbytes
    if backward:   # z_all, x_final, g_skip, weights in; dh0, grads out
        nbytes = z_all + 4 * b * t * (2 * C + S) + w * wbytes + 4 * (bias + w + bias)
        macs = L * b * t * (2 * C * 2 * G + G * (S + C) + 2 * (2 * G * C)
                            + 2 * C * 2 * G + G * C + G * S)
    else:          # h0, weights in; z_all, skip, x_final out
        nbytes = 4 * b * t * (2 * C + S) + z_all + w * wbytes + 4 * bias
        macs = L * b * t * (2 * C * 2 * G + G * C + G * S)
    return nbytes, 2 * macs


def post_loss_cost(arch, b: int, t: int, w: int, wbytes: int, backward: bool):
    """(bytes, flops) of the post-loss forward or backward over the scored
    window (the head rows need no work)."""
    S, Q = arch.skip_channels, arch.quant_channels
    weights = (S * S + S * Q) * wbytes + 4 * (S + Q)
    rows_in = 4 * b * w * S + 8 * b * w            # skip rows, targets, mask
    if backward:   # + dskip (all rows) and the gradients out
        return (rows_in + weights + 4 * b * t * S + 4 * (S * S + S * Q + S + Q),
                2 * b * w * 3 * (S * S + S * Q))
    return rows_in + weights + 4, 2 * b * w * (S * S + S * Q)


def turbo_cost(arch, b: int, lane_rows: int, wbytes: int):
    """(bytes, flops) of one turbo step: weights and biases, h and the
    embedding stack in and out, the L ring rows read and written, forced
    and the lane block in, the classes out."""
    L, C, G = len(arch.dilations), arch.residual_channels, arch.gate_channels
    S, Q, K = arch.skip_channels, arch.quant_channels, arch.input_kernel
    w = L * (2 * C * 2 * G + G * C + G * S) + S * S + S * Q + Q * C + K * C * C
    bias = L * (2 * G + C + S) + S + Q + C
    state = 2 * (C + (K - 1) * C + L * C) * b
    nbytes = w * wbytes + 4 * (bias + state + b + lane_rows * b + b)
    flops = 2 * b * (L * (2 * C * 2 * G + G * C + G * S) + S * S + S * Q + K * C * C)
    return nbytes, flops


def frontend_cost(arch, b: int, t: int, backward: bool):
    """(bytes, flops) of the frontend's forward or backward at (b, t): the
    classes, table, taps and bias in (fp32, as the TPU kernel reads them);
    h0 out, or dh in and d_embed, d_w, d_b out."""
    C, Q, K = arch.residual_channels, arch.quant_channels, arch.input_kernel
    params = Q * C + K * C * C + C
    taps = 2 * b * t * K * C * C
    if backward:   # d_w and d_e products, plus the scatter's adds
        return 4 * (b * t + params + b * t * C + params), 2 * taps + b * t * C
    return 4 * (b * t + params + b * t * C), taps


def bound_ms(nbytes: int, flops: int):
    by_bytes, by_ops = nbytes / H100_BYTES_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def phase_environment():
    import torch

    from lb_wavenet_tpu_torch.ops.cuda import build

    try:
        import triton  # noqa: F401
        has_triton = f"yes ({triton.__version__})"
    except ImportError:
        has_triton = "no"
    nvcc = build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[-1]
    log(json.dumps({
        "phase": "environment", "python": sys.version.split()[0],
        "torch": torch.__version__, "torch.version.cuda": torch.version.cuda,
        "gpu": gpu_line(), "triton": has_triton, "nvcc": nvcc,
        "nvcc_version": ver,
    }))
    t0 = time.perf_counter()
    build.build_all()
    for name in KERNEL_SOURCES:
        build.load(name)
    res = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
           for k, v in build.build_log.items()}
    log(json.dumps({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
                    "ptxas": res}))


def check_choices(plain_logits, cls_k, temperature, lane, forced):
    """Largest gap between the best score and the score of the class the
    kernel chose, recomputing the kernel's scores from the plain logits
    (T, Q, B) with the same noise; forced steps are skipped."""
    import torch

    from lb_wavenet_tpu_torch.ops.cuda import ar_mega

    worst = 0.0
    q = plain_logits.shape[1]
    for t in range(cls_k.shape[0]):
        lg = plain_logits[t]
        if temperature > 0.0:
            gum = ar_mega.gumbel_from_bits(ar_mega._perlane_bits(q, lane, t))
            if lane.shape[0] == 3:
                inv = lane[2].contiguous().view(torch.float32)[None, :]
                s = torch.where(inv > 0.0, lg * inv + gum, lg)
            else:
                s = lg * ar_mega._inv_temp(temperature) + gum
        else:
            s = lg
        chosen = s.gather(0, cls_k[t].long()[None, :])[0]
        gap = (s.max(dim=0).values - chosen)[forced[t] < 0]
        if gap.numel():
            worst = max(worst, float(gap.max()))
    return worst


def phase_kernels(params, arch, gpu):
    """Kernels against their plain versions on the card."""
    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.ops.cuda import ar_mega, ar_step

    report = {}
    g = torch.Generator(device="cuda").manual_seed(1)
    c = arch.residual_channels
    ring = torch.randn((sum(arch.dilations), B, c), device="cuda", generator=g)
    h0 = torch.randn((B, c), device="cuda", generator=g)
    r_k, r_p = ring.clone(), ring.clone()
    _, skip_k = ar_step.fused_stack(params["layers"], arch, h0, r_k, 1000)
    torch.cuda.synchronize()
    _, skip_p = ar_step.fused_stack_plain(params["layers"], arch, h0, r_p, 1000)
    err = max(float((r_k - r_p).abs().max()), float((skip_k - skip_p).abs().max()))
    log(json.dumps({"phase": "fused_stack_vs_plain", "gpu": gpu, "B": B, "t": 1000,
                    "max_abs_err": err, "atol": LOGIT_ATOL}))
    require(err <= LOGIT_ATOL, f"fused_stack differs from plain: {err}")
    report["fused_stack"] = err
    del ring, r_k, r_p

    h0, e0 = G._fused_frontend_zero(params, arch, B)
    lp = params["layers"]

    def run(fn, forced, temperature, emit, lane):
        carry = ar_mega.mega_zero_carry(arch, h0, e0)
        out = fn(params, lp, arch, carry, 0, forced, temperature, emit, lane, 12345)
        torch.cuda.synchronize()
        return out, carry

    # Teacher-forced at the serving shapes: one CHUNK-step streaming call
    # through the wrapper at a mid-stream t0, from a random carry, with a
    # 3-row lane block; the plain version runs on copies of the inputs.
    gen = torch.Generator(device="cuda").manual_seed(2)
    t0 = 5000
    forced = torch.randint(0, arch.quant_channels, (CHUNK, 1, B), device="cuda",
                           dtype=torch.int32, generator=gen)
    ck = ar_mega.mega_zero_carry(arch, h0, e0)
    for k in ("bufs", "hstate"):
        ck[k].normal_(generator=gen)
    cp = {k: v.clone() for k, v in ck.items()}
    inv = torch.tensor([0.0, 1 / 0.7, 1.0], dtype=torch.float32).repeat(B // 3 + 1)[:B]
    lane = torch.stack([
        torch.randint(0, 2**31 - 1, (B,), device="cuda", dtype=torch.int32,
                      generator=gen),
        torch.full((B,), t0 - 100, device="cuda", dtype=torch.int32),
        inv.cuda().view(torch.int32),
    ])
    _, lk, _ = ar_mega.mega_generate(
        params, lp, arch, None, None, 12345, forced, None, CHUNK, 1.0, False,
        emit_logits=True, streaming=True, carry=ck, t0=t0, lane=lane)
    torch.cuda.synchronize()
    _, lpl = ar_mega.mega_generate_plain(params, lp, arch, cp, t0, forced[:, 0],
                                         1.0, True, lane, 12345)
    err = float((lk - lpl).abs().max())
    carry_err = max(float((ck[k] - cp[k]).abs().max()) for k in ck)
    log(json.dumps({"phase": "mega_teacher_forced_vs_plain", "gpu": gpu,
                    "B": B, "T": CHUNK, "t0": t0, "lane_rows": 3,
                    "max_abs_err": err, "carry_max_abs_err": carry_err,
                    "atol": LOGIT_ATOL}))
    require(err <= LOGIT_ATOL and carry_err <= LOGIT_ATOL,
            f"mega teacher-forced logits/carry differ: {err}, {carry_err}")
    report["mega_generate"] = err
    del ck, cp, lk, lpl

    seeds = torch.randint(0, 2**31 - 1, (B,), device="cuda", dtype=torch.int32,
                          generator=gen)
    zeros = torch.zeros(B, device="cuda", dtype=torch.int32)
    inv = inv.cuda()
    free = torch.full((T_CHECK, B), -1, device="cuda", dtype=torch.int32)
    for name, temp, lane in (
        ("greedy", 0.0, None),
        ("per_lane_2row", 1.0, torch.stack([seeds, zeros])),
        ("per_lane_3row", 1.0, torch.stack([seeds, zeros, inv.view(torch.int32)])),
    ):
        (cls_k, _), _ = run(ar_mega.mega_generate_cuda, free, temp, False, lane)
        (cls_p, _), _ = run(ar_mega.mega_generate_plain, free, temp, False, lane)
        diff = (cls_k != cls_p).any(dim=1).nonzero()
        first = int(diff[0]) if len(diff) else None
        lanes_equal = float((cls_k == cls_p).all(dim=0).float().mean())
        # Hold every kernel choice against the plain scores on the kernel's
        # own history (teacher-forced plain run), so later drift of the
        # free-running pair is not mistaken for a fault.
        (_, lg_tf), _ = run(ar_mega.mega_generate_plain, cls_k, temp, True, lane)
        gap = check_choices(lg_tf, cls_k, temp, lane, free)
        log(json.dumps({
            "phase": f"mega_{name}_vs_plain", "gpu": gpu, "B": B, "T": T_CHECK,
            "first_divergent_step": first, "lanes_equal": lanes_equal,
            "max_choice_gap": gap, "gap_tol": 2 * LOGIT_ATOL,
        }))
        require(gap <= 2 * LOGIT_ATOL,
                f"mega {name}: kernel chose a class {gap} below the plain max")
    return report


def phase_turbo_kernels(params, arch, gpu):
    """turbo_step against its plain version at B=512: one step at a
    mid-stream t, a teacher-forced chunk, and free runs under the
    near-argmax check."""
    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.ops.cuda import ar_turbo

    lp, c = params["layers"], arch.residual_channels
    gen = torch.Generator(device="cuda").manual_seed(4)
    h0, e0 = G._fused_frontend_zero(params, arch, B)
    inv = torch.tensor([0.0, 1 / 0.7, 1.0], dtype=torch.float32).repeat(B // 3 + 1)[:B]
    seeds = torch.randint(0, 2**31 - 1, (B,), device="cuda", dtype=torch.int32, generator=gen)
    lane3 = torch.stack([seeds, torch.full((B,), 900, device="cuda", dtype=torch.int32),
                         inv.cuda().view(torch.int32)])

    def random_state():
        return {"bufs": torch.randn((sum(arch.dilations), B, c), device="cuda", generator=gen),
                "h": torch.randn((B, c), device="cuda", generator=gen),
                "e": torch.randn((arch.input_kernel - 1, B, c), device="cuda", generator=gen)}

    # One step at t = 1000 through the JAX-shaped wrapper, half the lanes
    # forced; the plain version is forced to the kernel's classes (a near-tie
    # may sample another class), and each choice is held to the near-argmax
    # check instead.
    st = random_state()
    forced = torch.where(torch.arange(B, device="cuda") % 2 == 0,
                         torch.randint(0, arch.quant_channels, (B,), device="cuda",
                                       dtype=torch.int32, generator=gen), -1).to(torch.int32)
    bk, bp = st["bufs"].clone(), st["bufs"].clone()
    _, ck, ek, hk, lk = ar_turbo.turbo_step(params, lp, arch, st["h"], st["e"], bk, 1000,
                                            12345, forced, temperature=1.0, lane=lane3,
                                            emit_logits=True)
    torch.cuda.synchronize()
    sp = {"bufs": bp, "h": st["h"].clone(), "e": st["e"].clone()}
    cp, lpl = ar_turbo.turbo_generate_plain(params, lp, arch, sp, 1000, ck[None], 1.0,
                                            True, lane3, 12345)
    cp, _ = ar_turbo.turbo_generate_plain(
        params, lp, arch, {"bufs": st["bufs"].clone(), "h": st["h"].clone(),
                           "e": st["e"].clone()}, 1000, forced[None], 1.0, False, lane3, 12345)
    step_err = max(abs_err(bk, bp), abs_err(hk, sp["h"]), abs_err(ek, sp["e"]),
                   abs_err(lk, lpl[0]))
    gap = check_choices(lpl.transpose(1, 2), ck[None], 1.0, _shift_lane(lane3, 1000),
                        forced[None])
    log(json.dumps({"phase": "turbo_step_vs_plain", "gpu": gpu, "B": B, "t": 1000,
                    "lane_rows": 3, "max_abs_err": step_err, "classes_equal":
                    bool(torch.equal(ck, cp[0])), "max_choice_gap": gap,
                    "atol": LOGIT_ATOL}))
    require(step_err <= LOGIT_ATOL and gap <= 2 * LOGIT_ATOL,
            f"turbo_step differs from plain: {step_err}, choice gap {gap}")

    # Teacher-forced over a T_CHECK-step chunk at a mid-stream t0.
    st = random_state()
    forced = torch.randint(0, arch.quant_channels, (T_CHECK, B), device="cuda",
                           dtype=torch.int32, generator=gen)
    sk = {k: v.clone() for k, v in st.items()}
    _, lk = ar_turbo.turbo_generate(params, lp, arch, sk, 5000, forced, 1.0, True, lane3, 7)
    torch.cuda.synchronize()
    _, lpl = ar_turbo.turbo_generate_plain(params, lp, arch, st, 5000, forced, 1.0, True,
                                           lane3, 7)
    err = abs_err(lk, lpl)
    state_err = max(abs_err(sk[k], st[k]) for k in st)
    log(json.dumps({"phase": "turbo_teacher_forced_vs_plain", "gpu": gpu, "B": B,
                    "T": T_CHECK, "t0": 5000, "max_abs_err": err,
                    "state_max_abs_err": state_err, "atol": LOGIT_ATOL}))
    require(err <= LOGIT_ATOL and state_err <= LOGIT_ATOL,
            f"turbo teacher-forced logits/state differ: {err}, {state_err}")
    report = {"turbo_step": max(step_err, err)}
    del st, sk, lk, lpl

    zeros = torch.zeros(B, device="cuda", dtype=torch.int32)
    free = torch.full((T_TURBO, B), -1, device="cuda", dtype=torch.int32)

    def run(fn, forced, temp, emit, lane):
        state = {"bufs": torch.zeros((sum(arch.dilations), B, c), device="cuda"),
                 "h": h0.clone(), "e": e0.clone()}
        out = fn(params, lp, arch, state, 0, forced, temp, emit, lane, 12345)
        torch.cuda.synchronize()
        return out

    for name, temp, lane in (
        ("greedy", 0.0, None),
        ("per_lane_2row", 1.0, torch.stack([seeds, zeros])),
        ("per_lane_3row", 1.0, torch.stack([seeds, zeros, inv.cuda().view(torch.int32)])),
    ):
        cls_k, _ = run(ar_turbo.turbo_generate_cuda, free, temp, False, lane)
        cls_p, _ = run(ar_turbo.turbo_generate_plain, free, temp, False, lane)
        diff = (cls_k != cls_p).any(dim=1).nonzero()
        _, lg_tf = run(ar_turbo.turbo_generate_plain, cls_k, temp, True, lane)
        gap = check_choices(lg_tf.transpose(1, 2), cls_k, temp, lane, free)
        log(json.dumps({
            "phase": f"turbo_{name}_vs_plain", "gpu": gpu, "B": B, "T": T_TURBO,
            "first_divergent_step": int(diff[0]) if len(diff) else None,
            "lanes_equal": float((cls_k == cls_p).all(dim=0).float().mean()),
            "max_choice_gap": gap, "gap_tol": 2 * LOGIT_ATOL,
        }))
        require(gap <= 2 * LOGIT_ATOL,
                f"turbo {name}: kernel chose a class {gap} below the plain max")
    return report


def _shift_lane(lane, t):
    """The lane block with lease times moved back by t, so that
    check_choices (which counts steps from 0) hashes step t."""
    out = lane.clone()
    out[1] -= t
    return out


def make_requests():
    """12 requests of 8000-24000 samples, temperatures {0, 0.7, 1.0}."""
    return [
        {"id": f"r{i:02d}", "n_samples": 8000 + (i * 1455) % 16001,
         "seed": 1000 + 17 * i, "temperature": (0.0, 0.7, 1.0)[i % 3]}
        for i in range(12)
    ]


def serve_pool(params, arch, requests, batch, first_wave, engine="mega"):
    """Serve `requests` through a pipelined SessionPool; the first
    `first_wave` go in at once, the rest as lanes free up (so they take
    recycled lanes). Returns ({id: classes}, {id: lane}, stats, wall)."""
    import numpy as np
    import torch

    from lb_wavenet_tpu_torch.serving import SessionPool

    pool = SessionPool(params, arch, batch, 0, engine=engine, chunk_size=CHUNK,
                       temperature=1.0, pipeline=True, device="cuda")
    out, lanes, parts = {}, {}, {}
    queue = list(requests)

    def submit(r):
        ok = pool.submit(r["id"], r["n_samples"], seed=r["seed"],
                         temperature=r["temperature"])
        require(ok, "pool refused a request")
        lanes[r["id"]] = next(i for i, ls in enumerate(pool._lanes)
                              if ls is not None and ls.request_id == r["id"])
        parts[r["id"]] = []

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in queue[:first_wave]:
        submit(r)
    queue = queue[first_wave:]
    while pool.active or queue:
        for rid, (cls, done) in pool.step().items():
            parts[rid].append(cls)
            if done:
                out[rid] = np.concatenate(parts.pop(rid))
                if queue:
                    submit(queue.pop(0))
    wall = time.perf_counter() - t0
    return out, lanes, dict(pool.stats), wall


def phase_serving(params, arch, gpu):
    import numpy as np

    from lb_wavenet_tpu_torch.ops.cuda.ar_mega import mega_generate

    requests = make_requests()
    mega_generate.launches = 0
    out, lanes, stats, wall = serve_pool(params, arch, requests, B, first_wave=8)
    launches = mega_generate.launches
    require(len(out) == len(requests), "not every request completed")
    for r in requests:
        cls = out[r["id"]]
        require(cls.shape == (r["n_samples"],) and cls.min() >= 0
                and cls.max() < arch.quant_channels, f"bad classes for {r['id']}")
    recycled = [r["id"] for r in requests[8:] if lanes[r["id"]] < 8]
    require(len(recycled) == 4, f"late requests did not take recycled lanes: {lanes}")
    total = sum(r["n_samples"] for r in requests)
    nst = max(stats["steps"], 1)
    log(json.dumps({
        "phase": "serving", "gpu": gpu, "requests": len(requests),
        "pool_batch": B, "chunk": CHUNK, "pipeline": True,
        "audio_sec": total / arch.sample_rate, "wall_s": wall,
        "delivered_audio_sec_per_s": total / arch.sample_rate / wall,
        "steps": stats["steps"], "mega_launches": launches,
        "recycled_lanes": {rid: lanes[rid] for rid in recycled},
        "phase_ms_per_step": {k[:-2]: 1000.0 * v / nst
                              for k, v in stats.items() if k.endswith("_s")},
    }))
    require(launches > 0, "the serving path never launched the mega kernel")

    # Replay the shortest sampled request that ran on a recycled lane, alone.
    rep = min((r for r in requests[8:] if r["temperature"] > 0 and r["id"] in recycled),
              key=lambda r: r["n_samples"])
    rep_out, _, _, _ = serve_pool(params, arch, [rep], 1, first_wave=1)
    same = np.array_equal(rep_out[rep["id"]], out[rep["id"]])
    log(json.dumps({"phase": "replay", "request": rep["id"],
                    "temperature": rep["temperature"], "bit_identical": same}))
    require(same, f"replay of {rep['id']} on a dedicated session differs")

    cli_serve(params, arch, requests, out, "mega", B, gpu)
    return launches


def cli_serve(params, arch, requests, out, engine, batch, gpu):
    """The same requests through `python -m lb_wavenet_tpu_torch.cli serve`
    from a save_params checkpoint: the wavs must equal the pool's audio."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from lb_wavenet_tpu_torch.ops.cuda.build import BUILD
    from lb_wavenet_tpu_torch.ops.mulaw import mu_law_decode
    from lb_wavenet_tpu_torch.utils.checkpoint import save_params

    work = os.path.join(BUILD, "chip_smoke")   # gitignored, removed below
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        save_params(os.path.join(work, "ckpt"), params, 0)
        req_path = os.path.join(work, "requests.jsonl")
        with open(req_path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in requests)
        cmd = [
            sys.executable, "-m", "lb_wavenet_tpu_torch.cli", "serve",
            "--config", os.path.join(ROOT, "configs", "wavenet30.json"),
            "--requests", req_path, "--stream-chunk", str(CHUNK),
            "--set", f"gen.checkpoint_dir={os.path.join(work, 'ckpt')}",
            "--set", f"gen.out_dir={os.path.join(work, 'wav')}",
            "--set", f"gen.batch_size={batch}", "--set", "gen.temperature=1.0",
            "--set", f"gen.engine={engine}",
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                              timeout=600)
        require(proc.returncode == 0, f"CLI serve failed:\n{proc.stderr[-4000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        require(summary["served"] == len(requests) and summary["engine"] == engine,
                f"CLI served {summary['served']} on {summary['engine']}")
        for r in requests:
            _, wav = wavfile.read(os.path.join(work, "wav", f"{r['id']}.wav"))
            ref = mu_law_decode(torch.from_numpy(out[r["id"]])).numpy()
            ref = (np.clip(ref, -1, 1) * 32767.0).astype(np.int16)
            require(np.array_equal(wav, ref), f"CLI audio of {r['id']} differs")
        summary["gpu"] = gpu
        log(json.dumps({"phase": f"cli_serve_{engine}", "summary": summary,
                        "audio_equal_to_pool": True}))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_turbo_serving(params, arch, gpu):
    """The turbo engine behind SessionPool at a batch that is not a multiple
    of the lane tile, a bit-identical replay, and the CLI."""
    import numpy as np

    from lb_wavenet_tpu_torch.ops.cuda.ar_turbo import turbo_step

    requests = [{"id": f"u{i}", "n_samples": 3000 + 611 * i, "seed": 500 + 13 * i,
                 "temperature": (0.0, 0.7, 1.0)[i % 3]} for i in range(6)]
    turbo_step.launches = 0
    out, lanes, stats, wall = serve_pool(params, arch, requests, TURBO_POOL, first_wave=4,
                                         engine="turbo")
    launches = turbo_step.launches
    require(len(out) == len(requests), "not every turbo request completed")
    for r in requests:
        cls = out[r["id"]]
        require(cls.shape == (r["n_samples"],) and cls.min() >= 0
                and cls.max() < arch.quant_channels, f"bad classes for {r['id']}")
    recycled = [r["id"] for r in requests[4:] if lanes[r["id"]] < 4]
    nst = max(stats["steps"], 1)
    total = sum(r["n_samples"] for r in requests)
    log(json.dumps({
        "phase": "turbo_serving", "gpu": gpu, "requests": len(requests),
        "pool_batch": TURBO_POOL, "chunk": CHUNK, "audio_sec": total / arch.sample_rate,
        "wall_s": wall, "delivered_audio_sec_per_s": total / arch.sample_rate / wall,
        "steps": stats["steps"], "turbo_launches": launches,
        "recycled_lanes": {rid: lanes[rid] for rid in recycled},
        "phase_ms_per_step": {k[:-2]: 1000.0 * v / nst for k, v in stats.items()
                              if k.endswith("_s")},
    }))
    require(len(recycled) == 2, f"late turbo requests did not take recycled lanes: {lanes}")
    require(launches == stats["steps"] * CHUNK,
            f"turbo_step launched {launches} times in {stats['steps']} chunks")
    rep = min((r for r in requests if r["temperature"] > 0 and r["id"] in recycled),
              key=lambda r: r["n_samples"])
    rep_out, _, _, _ = serve_pool(params, arch, [rep], 1, first_wave=1, engine="turbo")
    same = np.array_equal(rep_out[rep["id"]], out[rep["id"]])
    log(json.dumps({"phase": "turbo_replay", "request": rep["id"],
                    "temperature": rep["temperature"], "bit_identical": same}))
    require(same, f"turbo replay of {rep['id']} on a dedicated session differs")
    cli_serve(params, arch, requests, out, "turbo", TURBO_POOL, gpu)
    return launches


def phase_pallas_engine(params, arch, gpu):
    """The pallas engine: fused_stack once per step at B=512."""
    import torch

    from lb_wavenet_tpu_torch.generate import generate_classes
    from lb_wavenet_tpu_torch.ops.cuda.ar_step import fused_stack

    steps = 64
    fused_stack.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cls = generate_classes(params, arch, 3, B, steps, temperature=1.0,
                           engine="pallas", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_stack.launches
    require(cls.shape == (B, steps) and int(cls.min()) >= 0, "bad pallas classes")
    require(launches == steps, f"pallas engine launched fused_stack {launches} times")
    log(json.dumps({"phase": "pallas_engine", "gpu": gpu, "B": B, "steps": steps,
                    "fused_stack_launches": launches,
                    "ms_per_step_end_to_end": 1000 * wall / steps}))
    return launches


def abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return abs_err(a, b) / max(float(b.float().abs().max()), 1e-30)


def train_inputs(arch, seed: int):
    """Numpy-seeded training-stack inputs on the card: h0 (B, T, C) and a
    skip cotangent (B, T, S)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = arch.receptive_field - 1 + TRAIN_W
    h0 = rng.standard_normal((TRAIN_B, t, arch.residual_channels), dtype=np.float32)
    g = rng.standard_normal((TRAIN_B, t, arch.skip_channels), dtype=np.float32)
    return torch.from_numpy(h0).cuda(), torch.from_numpy(g).cuda()


def frontend_inputs(arch, seed: int):
    """Numpy-seeded frontend inputs on the card: classes (B, T) and an h0
    cotangent (B, T, C)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = arch.receptive_field - 1 + TRAIN_W
    x = rng.integers(0, arch.quant_channels, (TRAIN_B, t)).astype(np.int32)
    dh = rng.standard_normal((TRAIN_B, t, arch.residual_channels), dtype=np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(dh).cuda()


def post_inputs(arch, seed: int):
    """Numpy-seeded post-loss inputs on the card: skip (B, T, S), targets
    and a mask with a file start inside the window."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = arch.receptive_field - 1 + TRAIN_W
    skip = rng.standard_normal((TRAIN_B, t, arch.skip_channels), dtype=np.float32)
    tgt = rng.integers(0, arch.quant_channels, (TRAIN_B, TRAIN_W)).astype(np.int32)
    mask = np.ones((TRAIN_B, TRAIN_W), np.float32)
    mask[0, :3000] = 0.0
    return (torch.from_numpy(skip).cuda(), torch.from_numpy(tgt).cuda(),
            torch.from_numpy(mask).cuda())


def phase_train_kernels(params, arch, gpu):
    """The training kernel pairs against their plain versions at the
    training shapes, values and every gradient leaf; returns each kernel's
    max abs error (forward: its outputs, backward: every gradient leaf)."""
    import torch

    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F
    from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    dt = compute_dtype(arch)
    report = dict.fromkeys(TRAIN_COUNTERS, 0.0)
    x, dh = frontend_inputs(arch, 10)
    leaves = {"embed": params["embed"].detach().clone().requires_grad_(True),
              "w": params["input_conv"]["w"].detach().clone().requires_grad_(True),
              "b": params["input_conv"]["b"].detach().clone().requires_grad_(True)}
    h = F.fused_frontend(leaves["embed"], {"w": leaves["w"], "b": leaves["b"]}, x,
                         compute_dtype=arch.compute_dtype)
    (h * dh).sum().backward()
    torch.cuda.synchronize()
    with torch.no_grad():
        plain = [leaves[k].detach() for k in ("embed", "w", "b")]
        hp = F.frontend_fwd_plain(*plain, x, dt)
        gp = dict(zip(("embed", "w", "b"), F.frontend_bwd_plain(plain[0], plain[1], x, dt, dh)))
    errs = {"h0": rel_err(h.detach(), hp), **{f"d_{k}": rel_err(leaves[k].grad, gp[k])
                                              for k in gp}}
    log(json.dumps({"phase": "frontend_vs_plain", "gpu": gpu, "B": TRAIN_B, "T": x.shape[1],
                    "rel_err": errs, "rtol": KERNEL_RTOL}))
    require(max(errs.values()) <= KERNEL_RTOL, f"frontend differs: {errs}")
    report["frontend_fwd"] = abs_err(h.detach(), hp)
    report["frontend_bwd"] = max(abs_err(leaves[k].grad, gp[k]) for k in gp)
    del h, hp, gp, leaves, x, dh

    h0, g = train_inputs(arch, 11)
    for tapcat in (False, True):
        lp = {k: v.detach().clone().requires_grad_(True) for k, v in params["layers"].items()}
        h = h0.clone().requires_grad_(True)
        skip = TS.make_fused_stack(arch, tapcat=tapcat)(lp, h)
        (skip * g).sum().backward()
        torch.cuda.synchronize()
        with torch.no_grad():
            plain = {k: v.detach() for k, v in params["layers"].items()}
            sp, zp, xp = TS.stack_fwd_plain(plain, h0, arch.dilations, dt, tapcat)
            dp, gp = TS.stack_bwd_plain(plain, arch.dilations, dt, tapcat, zp, xp, g)
        errs = {"skip": rel_err(skip.detach(), sp), "dh0": rel_err(h.grad, dp),
                **{f"layers.{k}": rel_err(lp[k].grad, gp[k]) for k in gp}}
        log(json.dumps({"phase": "train_stack_vs_plain", "gpu": gpu, "tapcat": tapcat,
                        "B": TRAIN_B, "T": h0.shape[1], "rel_err": errs,
                        "rtol": KERNEL_RTOL}))
        require(max(errs.values()) <= KERNEL_RTOL,
                f"train stack (tapcat={tapcat}) differs: {errs}")
        report["train_stack_fwd"] = max(report["train_stack_fwd"], abs_err(skip.detach(), sp))
        report["train_stack_bwd"] = max(report["train_stack_bwd"], abs_err(h.grad, dp),
                                        *(abs_err(lp[k].grad, gp[k]) for k in gp))
        del skip, sp, zp, xp, dp, gp, lp, h
    del h0, g

    skip, tgt, mask = post_inputs(arch, 12)
    post = {k: v.detach().clone().requires_grad_(True) for k, v in params["post"].items()}
    s = skip.clone().requires_grad_(True)
    num = PL.fused_post_loss(post, s, tgt, mask, TRAIN_W, arch.compute_dtype)
    (num * 0.37).backward()
    torch.cuda.synchronize()
    with torch.no_grad():
        plain = {k: v.detach() for k, v in params["post"].items()}
        num_p = PL.post_loss_plain(plain, skip, tgt, mask, TRAIN_W, dt)
        dsp, gp = PL.post_loss_bwd_plain(plain, skip, tgt, mask, TRAIN_W, dt,
                                         torch.tensor(0.37, device="cuda"))
    head = skip.shape[1] - TRAIN_W
    errs = {"num": rel_err(num.detach(), num_p), "dskip": rel_err(s.grad, dsp),
            **{f"post.{k}": rel_err(post[k].grad, gp[k]) for k in gp}}
    head_zero = not bool(s.grad[:, :head].any())
    log(json.dumps({"phase": "post_loss_vs_plain", "gpu": gpu, "B": TRAIN_B,
                    "T": skip.shape[1], "W": TRAIN_W, "rel_err": errs,
                    "head_dskip_exactly_zero": head_zero, "rtol": KERNEL_RTOL}))
    require(max(errs.values()) <= KERNEL_RTOL and head_zero, f"post-loss differs: {errs}")
    report["post_loss_fwd"] = abs_err(num.detach(), num_p)
    report["post_loss_bwd"] = max(abs_err(s.grad, dsp),
                                  *(abs_err(post[k].grad, gp[k]) for k in gp))
    return report


TRAIN_COUNTERS = ("frontend_fwd", "frontend_bwd", "train_stack_fwd", "train_stack_bwd",
                  "post_loss_fwd", "post_loss_bwd")


@contextlib.contextmanager
def plain_kernels():
    """Route the training kernels' wrappers to their plain versions (same
    signatures) for a reference run on the card."""
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F
    from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    swaps = [(F, "frontend_fwd", F.frontend_fwd_plain),
             (F, "frontend_bwd", F.frontend_bwd_plain),
             (TS, "train_stack_fwd", TS.stack_fwd_plain),
             (TS, "train_stack_bwd", TS.stack_bwd_plain),
             (PL, "post_loss_fwd", PL.post_loss_plain),
             (PL, "post_loss_bwd", PL.post_loss_bwd_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def leaf_errs(got: dict, want: dict, prefix: str = "") -> dict:
    """{path: rel_err} over two nested dicts of tensors."""
    out = {}
    for k in sorted(want):
        if isinstance(want[k], dict):
            out.update(leaf_errs(got[k], want[k], f"{prefix}{k}."))
        else:
            out[prefix + k] = rel_err(got[k], want[k])
    return out


def train_counters():
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F
    from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    return {"frontend_fwd": F.frontend_fwd, "frontend_bwd": F.frontend_bwd,
            "train_stack_fwd": TS.train_stack_fwd, "train_stack_bwd": TS.train_stack_bwd,
            "post_loss_fwd": PL.post_loss_fwd, "post_loss_bwd": PL.post_loss_bwd}


@contextlib.contextmanager
def no_plain_frontend():
    """Fail if the training step runs the frontend as plain PyTorch: the
    unfused input_frontend or the kernel pair's plain versions."""
    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F

    real = PT.input_frontend

    def fused_only(params, arch, x, dt, fused_frontend=False):
        require(fused_frontend, "the training step ran the unfused frontend")
        return real(params, arch, x, dt, fused_frontend)

    def refuse(*_):
        raise SmokeFailure("the training step ran the frontend's plain version")

    saved = (F.frontend_fwd_plain, F.frontend_bwd_plain)
    PT.input_frontend, F.frontend_fwd_plain, F.frontend_bwd_plain = fused_only, refuse, refuse
    try:
        yield
    finally:
        PT.input_frontend = real
        F.frontend_fwd_plain, F.frontend_bwd_plain = saved


def phase_training(arch, gpu):
    """run_training at WaveNet-30 with the recipe as written (the main
    training path), then the fixed state checks, a resume, evaluation and
    the CLI."""
    import dataclasses
    import io
    import statistics

    import torch

    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.data import make_batches, synthetic_corpus, write_wav
    from lb_wavenet_tpu_torch.ops.cuda.build import BUILD

    work = os.path.join(BUILD, "chip_smoke_train")   # gitignored, removed below
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = Config.load(os.path.join(ROOT, "configs", "wavenet30.json"))
    train = dataclasses.replace(cfg.train, n_steps=TRAIN_STEPS, log_every=1,
                                checkpoint_every=0, checkpoint_dir=os.path.join(work, "ckpt"))
    require(train.fused_frontend and train.fused_stack and train.tapcat and train.fused_post
            and (train.batch_size, train.window_size) == (TRAIN_B, TRAIN_W),
            "wavenet30.json no longer holds the training settings this phase drives")
    cfg = dataclasses.replace(cfg, train=train)
    corpus = synthetic_corpus(arch, TRAIN_W, n_files=8, file_len=160000, seed=0)
    counters = train_counters()
    try:
        for f in counters.values():
            f.launches = 0
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), no_plain_frontend():
            state = PT.run_training(cfg, corpus=corpus, device="cuda")
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        recs = [json.loads(ln) for ln in out.getvalue().splitlines()]
        losses = [r["loss"] for r in recs]
        step_ms = [r["step_time_ms"] for r in recs]
        ms = statistics.median(step_ms[1:])
        L = len(arch.dilations)
        per_step = {"frontend_fwd": 1, "frontend_bwd": 4, "train_stack_fwd": L + 1,
                    "train_stack_bwd": 3 * L + 1, "post_loss_fwd": 2, "post_loss_bwd": 3}
        log(json.dumps({
            "phase": "training", "gpu": gpu, "B": TRAIN_B, "W": TRAIN_W,
            "T": arch.receptive_field - 1 + TRAIN_W, "steps": state.step,
            "losses": losses, "step_ms": step_ms, "median_step_ms_after_first": ms,
            "samples_per_s": TRAIN_B * TRAIN_W / (ms / 1000.0), "wall_s": wall,
            "launches": launches, "launches_per_step": per_step,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }))
        require(state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS, "training stopped early")
        require(all(l == l and abs(l) < 1e3 for l in losses), f"non-finite loss: {losses}")
        require(losses[-1] < losses[0] - 0.1, f"the loss did not fall: {losses}")
        for k, n in per_step.items():
            require(launches[k] == n * TRAIN_STEPS,
                    f"{k}: {launches[k]} launches in {TRAIN_STEPS} steps, expected {n} per step")

        phase_step_breakdown(cfg, corpus, gpu)

        # The same step at a fixed state: through the kernels, through their
        # plain versions, and as the unfused PyTorch step (autograd of the
        # plain forward, frontend included); and grad_accum=2 against the
        # one-shot step.
        batch = PT.batch_to_device(next(make_batches(corpus, train, start_step=5)), "cuda")
        fixed = PT.init_state(1, arch, train, "cuda").params
        loss_k, g_k = PT.value_and_grads(fixed, batch, arch, train)
        with plain_kernels():
            loss_pk, g_pk = PT.value_and_grads(fixed, batch, arch, train)
        loss_u, g_u = PT.value_and_grads(
            fixed, batch, arch, dataclasses.replace(train, fused_stack=False, fused_post=False,
                                                    fused_frontend=False))
        loss_a, g_a = PT.value_and_grads(
            fixed, batch, arch, dataclasses.replace(train, grad_accum=2))
        torch.cuda.synchronize()

        def vs(loss, grads, ref_loss, ref_grads):
            errs = leaf_errs(grads, ref_grads)
            return {"loss": abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
                    "grads": max(errs.values()), "worst_leaf": max(errs, key=errs.get)}

        checks = {"kernels_vs_plain": vs(loss_k, g_k, loss_pk, g_pk),
                  "kernels_vs_unfused": vs(loss_k, g_k, loss_u, g_u),
                  "accum2_vs_one_shot": vs(loss_a, g_a, loss_k, g_k)}
        log(json.dumps({"phase": "training_fixed_state", "gpu": gpu,
                        "loss_kernels": float(loss_k), "loss_plain": float(loss_pk),
                        "loss_unfused": float(loss_u), "loss_accum2": float(loss_a),
                        **checks, "unfused_leaf_errs": leaf_errs(g_k, g_u),
                        "rtol": {"plain": STEP_RTOL, "unfused": UNFUSED_RTOL,
                                 "accum": ACCUM_RTOL}}))
        for name, (loss_tol, grad_tol) in (("kernels_vs_plain", (1e-5, STEP_RTOL)),
                                           ("kernels_vs_unfused", (1e-3, UNFUSED_RTOL)),
                                           ("accum2_vs_one_shot", (1e-5, ACCUM_RTOL))):
            c = checks[name]
            require(c["loss"] <= loss_tol and c["grads"] <= grad_tol, f"{name}: {c}")
        del batch, fixed, g_k, g_pk, g_u, g_a

        # Resume: a second run finds the final checkpoint and trains nothing.
        for f in counters.values():
            f.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            again = PT.run_training(cfg, corpus=corpus, device="cuda")
        same = all(torch.equal(a, b) for a, b in zip(PT.tree_leaves(again.params),
                                                     PT.tree_leaves(state.params)))
        relaunched = sum(f.launches for f in counters.values())
        log(json.dumps({"phase": "training_resume", "step": again.step,
                        "params_equal": same, "kernel_launches": relaunched}))
        require(again.step == TRAIN_STEPS and same and relaunched == 0,
                "the resumed run did not restore the final checkpoint as it was")

        held_out = synthetic_corpus(arch, TRAIN_W, n_files=2, file_len=40000, seed=1)
        phase_eval(cfg, state, held_out, work, gpu)

        # The CLI: train 2 steps from a directory of wavs, serve and evaluate
        # from it.
        wavs, eval_wavs = os.path.join(work, "wavs"), os.path.join(work, "eval_wavs")
        os.makedirs(wavs)
        os.makedirs(eval_wavs)
        for i in range(4):
            write_wav(os.path.join(wavs, f"{i}.wav"), corpus.waves[i], arch.sample_rate)
        for i, w in enumerate(held_out.waves):
            write_wav(os.path.join(eval_wavs, f"{i}.wav"), w, arch.sample_rate)
        ckpt = os.path.join(work, "cli_ckpt")
        base = [sys.executable, "-m", "lb_wavenet_tpu_torch.cli"]
        conf = ["--config", os.path.join(ROOT, "configs", "wavenet30.json")]
        proc = subprocess.run(
            base + ["train", *conf, "--set", f"train.data_dir={wavs}",
                    "--set", f"train.checkpoint_dir={ckpt}", "--set", "train.n_steps=2",
                    "--set", "train.log_every=1"],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        require(proc.returncode == 0, f"CLI train failed:\n{proc.stderr[-4000:]}")
        cli_losses = [json.loads(ln)["loss"] for ln in proc.stdout.splitlines()
                      if ln.startswith("{\"step\"")]
        req = os.path.join(work, "req.jsonl")
        with open(req, "w") as f:
            f.writelines(json.dumps({"id": f"t{i}", "n_samples": 3000, "seed": i}) + "\n"
                         for i in range(2))
        proc = subprocess.run(
            base + ["serve", *conf, "--requests", req, "--stream-chunk", "1024",
                    "--set", f"gen.checkpoint_dir={ckpt}",
                    "--set", f"gen.out_dir={os.path.join(work, 'wav_out')}",
                    "--set", "gen.batch_size=8"],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        require(proc.returncode == 0, f"CLI serve failed:\n{proc.stderr[-4000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        served = sorted(os.listdir(os.path.join(work, "wav_out")))
        proc = subprocess.run(
            base + ["eval", *conf, "--data-dir", eval_wavs, "--set", f"gen.checkpoint_dir={ckpt}"],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        require(proc.returncode == 0, f"CLI eval failed:\n{proc.stderr[-4000:]}")
        cli_eval = json.loads(proc.stdout.strip().splitlines()[-1])
        log(json.dumps({"phase": "cli_train_then_serve_and_eval", "train_losses": cli_losses,
                        "served": summary["served"], "wavs": served, "eval": cli_eval}))
        require(len(cli_losses) == 2 and summary["served"] == 2
                and served == ["t0.wav", "t1.wav"], "CLI train/serve did not complete")
        require(cli_eval["n_windows"] == len(held_out.index) and 0 < cli_eval["nll"] < 10,
                f"CLI eval: {cli_eval}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, {"step_ms": ms, "samples_per_s": TRAIN_B * TRAIN_W / (ms / 1000.0)}


def phase_step_breakdown(cfg, corpus, gpu):
    """Where a training step's time goes: after a warm-up, STEP_PARTS steps
    as run_training runs them (prefetched batches) with CUDA events around
    the batch copy, the forward, the backward and Adam + EMA, and the host
    clock around each whole step; then one torch.profiler trace (device
    activity only) of two steps: device time of the port's kernels
    (namespace wn) and of every other kernel, and the largest others. The
    idle share is 1 - device busy time / step wall time."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.data import make_batches, prefetch

    arch, train = cfg.arch, cfg.train
    batches = prefetch(make_batches(corpus, train))
    state = PT.init_state(2, arch, train, "cuda")

    def step(events=None):
        nonlocal state
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        batch = PT.batch_to_device(next(batches), "cuda")
        mark(1)
        params = PT.tree_map(lambda p: p.detach().requires_grad_(True), state.params)
        num, den = PT.loss_sums_fn(params, arch, train.window_size, batch, train)
        loss = num / torch.clamp(den, min=1.0)
        mark(2)
        grads = PT._grad(loss, params)
        mark(3)
        state = PT._apply_updates(state, grads, train)
        mark(4)

    try:
        for _ in range(2):
            step()
        parts = {"batch_copy": [], "forward": [], "backward": [], "adam_ema": []}
        wall = []
        for _ in range(STEP_PARTS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(ev)
            torch.cuda.synchronize()
            wall.append(1000.0 * (time.perf_counter() - t0))
            for i, k in enumerate(parts):
                parts[k].append(ev[i].elapsed_time(ev[i + 1]))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step()
            torch.cuda.synchronize()
    finally:
        batches.close()
    ms = {k: statistics.median(v) for k, v in parts.items()}
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 2000.0
    ours = sum(v for k, v in kernels.items() if "wn::" in k)
    other = {k: v for k, v in kernels.items() if "wn::" not in k}
    busy = ours + sum(other.values())
    step_ms = statistics.median(wall)
    top = sorted(other.items(), key=lambda kv: -kv[1])[:10]
    log(json.dumps({
        "phase": "training_step_breakdown", "gpu": gpu, "steps": STEP_PARTS,
        "device_ms_per_step": ms, "step_wall_ms": step_ms,
        "profile_device_ms_per_step": {"port_kernels": ours,
                                       "other_kernels": sum(other.values()),
                                       "busy": busy},
        "idle_share": (1.0 - busy / step_ms) if busy else "not measured",
        "top_other_kernels_ms_per_step": [[k[:90], v] for k, v in top],
    }))


def phase_eval(cfg, state, held_out, work, gpu):
    """evaluate() of the trained params on a held-out corpus, through the
    fused stack and the plain forward, then a short run_training with
    in-training eval records (params and EMA)."""
    import dataclasses
    import io

    import torch

    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.eval import evaluate

    arch, train = cfg.arch, cfg.train
    t0 = time.perf_counter()
    fused = evaluate(state.params, arch, held_out, train.batch_size, fused=True, tapcat=True)
    fused_s = time.perf_counter() - t0
    plain = evaluate(state.params, arch, held_out, train.batch_size)
    gap = abs(fused["nll"] - plain["nll"])
    ev_train = dataclasses.replace(train, n_steps=2, eval_every=1, eval_batches=1,
                                   ema_decay=0.999,
                                   checkpoint_dir=os.path.join(work, "eval_ckpt"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = PT.run_training(dataclasses.replace(cfg, train=ev_train), corpus=held_out,
                              eval_corpus=held_out, device="cuda")
    recs = [json.loads(ln) for ln in out.getvalue().splitlines()]
    evals = [r for r in recs if "eval_nll" in r]
    again = evaluate(run.params, arch, held_out, train.batch_size, max_batches=1, fused=True,
                     tapcat=True)
    log(json.dumps({"phase": "eval", "gpu": gpu, "windows": len(held_out.index),
                    "fused": fused, "plain": plain, "fused_vs_plain_nll": gap,
                    "fused_wall_s": fused_s, "in_training": evals,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    require(fused["n_windows"] == len(held_out.index) and 0 < fused["nll"] < 10,
            f"bad eval metrics: {fused}")
    require(gap <= EVAL_NLL_ATOL, f"fused and plain eval differ by {gap} nats")
    require([r["step"] for r in evals] == [1, 2]
            and all("eval_ema_nll" in r and "eval_accuracy" in r for r in evals)
            and evals[-1]["eval_nll"] == again["nll"],
            f"in-training eval records: {evals}")


def train_timings(params, arch):
    """{name: (ms, plain ms, (bytes, flops))} of the six training kernels
    at the training shapes (tapcat on, as wavenet30.json trains)."""
    import torch

    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F
    from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    dt = compute_dtype(arch)
    wbytes = torch.finfo(dt).bits // 8
    counts = {k: f.launches for k, f in train_counters().items()}
    lp, dils = params["layers"], arch.dilations
    out = {}
    x, dh = frontend_inputs(arch, 15)
    t = x.shape[1]
    front = (params["embed"], params["input_conv"]["w"], params["input_conv"]["b"])
    out["frontend_fwd"] = (
        cuda_ms(lambda: F.frontend_fwd(*front, x, dt), 20),
        cuda_ms(lambda: F.frontend_fwd_plain(*front, x, dt), 5),
        frontend_cost(arch, TRAIN_B, t, False))
    out["frontend_bwd"] = (
        cuda_ms(lambda: F.frontend_bwd(front[0], front[1], x, dt, dh), 20),
        cuda_ms(lambda: F.frontend_bwd_plain(front[0], front[1], x, dt, dh), 5),
        frontend_cost(arch, TRAIN_B, t, True))
    del x, dh
    h0, g = train_inputs(arch, 13)
    _, z, x = TS.train_stack_fwd(lp, h0, dils, dt, True)
    out["train_stack_fwd"] = (
        cuda_ms(lambda: TS.train_stack_fwd(lp, h0, dils, dt, True), 5),
        cuda_ms(lambda: TS.stack_fwd_plain(lp, h0, dils, dt, True), 1),
        train_stack_cost(arch, TRAIN_B, t, wbytes, False))
    out["train_stack_bwd"] = (
        cuda_ms(lambda: TS.train_stack_bwd(lp, dils, dt, True, z, x, g), 3),
        cuda_ms(lambda: TS.stack_bwd_plain(lp, dils, dt, True, z, x, g), 1),
        train_stack_cost(arch, TRAIN_B, t, wbytes, True))
    del z, x, h0, g
    skip, tgt, mask = post_inputs(arch, 14)
    post = params["post"]
    gbar = torch.tensor(1.0 / TRAIN_B / TRAIN_W, device="cuda")
    out["post_loss_fwd"] = (
        cuda_ms(lambda: PL.post_loss_fwd(post, skip, tgt, mask, TRAIN_W, dt), 10),
        cuda_ms(lambda: PL.post_loss_plain(post, skip, tgt, mask, TRAIN_W, dt), 3),
        post_loss_cost(arch, TRAIN_B, t, TRAIN_W, wbytes, False))
    out["post_loss_bwd"] = (
        cuda_ms(lambda: PL.post_loss_bwd(post, skip, tgt, mask, TRAIN_W, dt, gbar), 10),
        cuda_ms(lambda: PL.post_loss_bwd_plain(post, skip, tgt, mask, TRAIN_W, dt, gbar), 3),
        post_loss_cost(arch, TRAIN_B, t, TRAIN_W, wbytes, True))
    for k, f in train_counters().items():
        f.launches = counts[k]
    return out


def phase_timing(params, arch, errs, launches, gpu):
    import torch

    from lb_wavenet_tpu_torch.generate import _fused_frontend_zero
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import ar_mega, ar_step, ar_turbo

    wbytes = torch.finfo(compute_dtype(arch)).bits // 8
    lp = params["layers"]
    g = torch.Generator(device="cuda").manual_seed(3)
    ring = torch.randn((sum(arch.dilations), B, arch.residual_channels),
                       device="cuda", generator=g)
    h = torch.randn((B, arch.residual_channels), device="cuda", generator=g)
    counts = ar_step.fused_stack.launches
    stack_ms = cuda_ms(lambda: ar_step.fused_stack(lp, arch, h, ring, 700), 50)
    stack_plain = cuda_ms(lambda: ar_step.fused_stack_plain(lp, arch, h, ring, 700), 5)
    ar_step.fused_stack.launches = counts

    h0, e0 = _fused_frontend_zero(params, arch, B)
    carry = ar_mega.mega_zero_carry(arch, h0, e0)
    free = torch.full((CHUNK, B), -1, device="cuda", dtype=torch.int32)
    inv = torch.full((B,), 1 / 0.7, device="cuda")
    lane = torch.stack([torch.arange(B, device="cuda", dtype=torch.int32),
                        torch.zeros(B, device="cuda", dtype=torch.int32),
                        inv.view(torch.int32)])
    counts = ar_mega.mega_generate.launches
    mega_ms = cuda_ms(lambda: ar_mega.mega_generate_cuda(
        params, lp, arch, carry, 0, free, 1.0, False, lane, 0), 2)
    t0 = time.perf_counter()
    ar_mega.mega_generate_plain(params, lp, arch, carry, 0, free, 1.0, False, lane, 0)
    torch.cuda.synchronize()
    mega_plain = 1000 * (time.perf_counter() - t0)
    ar_mega.mega_generate.launches = counts

    # turbo: ms per step (one launch), from 64-step runs; lanes as the pool's.
    state = {"bufs": torch.zeros((sum(arch.dilations), B, arch.residual_channels),
                                 device="cuda"), "h": h0.clone(), "e": e0.clone()}
    counts = ar_turbo.turbo_step.launches
    n = 64
    turbo_ms = cuda_ms(lambda: ar_turbo.turbo_generate_cuda(
        params, lp, arch, state, 0, free[:n], 1.0, False, lane, 0), 3) / n
    t0 = time.perf_counter()
    ar_turbo.turbo_generate_plain(params, lp, arch, state, 0, free[:8], 1.0, False, lane, 0)
    torch.cuda.synchronize()
    turbo_plain = 1000 * (time.perf_counter() - t0) / 8
    ar_turbo.turbo_step.launches = counts
    del state

    trained = train_timings(params, arch)
    kernels = []
    for name, src, rep, ms, plain, cost in (
        ("mega_generate", "lb_wavenet_tpu_torch/csrc/ar_mega.cu",
         "lb_wavenet_tpu/ops/pallas/ar_mega.py:397", mega_ms, mega_plain,
         mega_cost(arch, B, CHUNK, 3, wbytes)),
        ("fused_stack", "lb_wavenet_tpu_torch/csrc/ar_step.cu",
         "lb_wavenet_tpu/ops/pallas/ar_step.py:105", stack_ms, stack_plain,
         stack_cost(arch, B, wbytes)),
        ("turbo_step", "lb_wavenet_tpu_torch/csrc/ar_turbo.cu",
         "lb_wavenet_tpu/ops/pallas/ar_turbo.py:35", turbo_ms, turbo_plain,
         turbo_cost(arch, B, 3, wbytes)),
        ("frontend_fwd", "lb_wavenet_tpu_torch/csrc/frontend.cu",
         "lb_wavenet_tpu/ops/pallas/frontend.py:71", *trained["frontend_fwd"]),
        ("frontend_bwd", "lb_wavenet_tpu_torch/csrc/frontend.cu",
         "lb_wavenet_tpu/ops/pallas/frontend.py:120", *trained["frontend_bwd"]),
        ("train_stack_fwd", "lb_wavenet_tpu_torch/csrc/train_stack.cu",
         "lb_wavenet_tpu/ops/pallas/train_stack.py:580", *trained["train_stack_fwd"]),
        ("train_stack_bwd", "lb_wavenet_tpu_torch/csrc/train_stack.cu",
         "lb_wavenet_tpu/ops/pallas/train_stack.py:681", *trained["train_stack_bwd"]),
        ("post_loss_fwd", "lb_wavenet_tpu_torch/csrc/post_loss.cu",
         "lb_wavenet_tpu/ops/pallas/post_loss.py:50", *trained["post_loss_fwd"]),
        ("post_loss_bwd", "lb_wavenet_tpu_torch/csrc/post_loss.cu",
         "lb_wavenet_tpu/ops/pallas/post_loss.py:100", *trained["post_loss_bwd"]),
    ):
        bms, by = bound_ms(*cost)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
        })
    train_shape = {"B": TRAIN_B, "W": TRAIN_W, "T": arch.receptive_field - 1 + TRAIN_W,
                   "tapcat": True}
    log(json.dumps({"phase": "shapes", "gpu": gpu, "mega_generate": {"B": B, "T": CHUNK, "lane_rows": 3},
                    "fused_stack": {"B": B, "steps": 1},
                    "turbo_step": {"B": B, "steps": 1, "lane_rows": 3, "ms": "per step"},
                    "frontend_fwd": train_shape, "frontend_bwd": train_shape,
                    "train_stack_fwd": train_shape,
                    "train_stack_bwd": train_shape, "post_loss_fwd": train_shape,
                    "post_loss_bwd": train_shape}))
    log(json.dumps({"kernels": kernels}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from lb_wavenet_tpu_torch.config import Config
        from lb_wavenet_tpu_torch.utils.convert import params_from_jax
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        gpu = gpu_line()
        phase_environment()
        arch = Config.load(os.path.join(ROOT, "configs", "wavenet30.json")).arch
        params = params_from_jax(numpy_params(arch, 0), device="cuda")
        errs = phase_kernels(params, arch, gpu)
        errs.update(phase_turbo_kernels(params, arch, gpu))
        errs.update(phase_train_kernels(params, arch, gpu))
        launches = {"mega_generate": phase_serving(params, arch, gpu),
                    "fused_stack": phase_pallas_engine(params, arch, gpu),
                    "turbo_step": phase_turbo_serving(params, arch, gpu)}
        train_launches, _ = phase_training(arch, gpu)
        launches.update(train_launches)
        phase_timing(params, arch, errs, launches, gpu)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log(json.dumps({"phase": "done", "seconds": time.perf_counter() - t_start}))
    log(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
