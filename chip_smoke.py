#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (`lb_wavenet_tpu_torch`, never JAX) at WaveNet-30 full width
(configs/wavenet30.json: 3x10 dilations, C=G=64, S=Q=256, bf16 compute) with
random weights seeded by numpy, in phases; any failure exits non-zero:

  1. environment: CUDA, the card and its power limit, triton, nvcc; build
     every kernel from lb_wavenet_tpu_torch/csrc with nvcc (sm_90a), one
     nvcc per source, all started together; the ptxas report (registers,
     stack, spills) of the tensor-core kernels (bf16 sampling, B1 and B7,
     train stack, post-loss, frontend), and the libraries' shared-memory counts
     against the ones the routes are decided on;
  2. each kernel against its plain PyTorch version on the card at B=512
     (the bf16 mega and turbo kernels sum on tensor cores and their plain
     versions reproduce those sums, so they are expected bit-identical;
     the mega check also reports how far the one-fp32-sum order moves):
     fused_stack (one step at a mid-stream t: ring and skip), mega_generate
     (teacher-forced logits and carry over one 1024-step streaming chunk at
     a mid-stream t0 with a 3-row lane block, as the pool calls it; greedy,
     per-lane 2-row and 3-row lane blocks over 256 steps from the zero
     carry: first divergent step reported, and every class the kernel
     picked must be a near-argmax of the plain version's scores on the
     kernel's own history), turbo_step (one step at a mid-stream t, then
     teacher-forced logits and state over a 256-step chunk, then greedy and
     per-lane free runs of 128 steps under the same near-argmax check);
     fused_stack at B=512 and B=100 is bit-identical to its plain version
     on its bf16 tensor-core route (tc::stack_tc_kernel); then the CUDA-core
     routes of fused_stack and tp_fused_stack (fp32, and bf16 at C=24)
     within their tolerances;
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
     then bf16 mega and turbo at C=24, a width the tensor-core kernels do
     not take, through their CUDA-core route (B=64, 128 teacher-forced
     steps, within LOGIT_ATOL);
  6. the training kernels against their plain versions at the training
     shapes (B=8, W=10240, T=13310): the frontend pair on both routes (bf16
     on tensor cores, h0 bit-identical to its plain version; fp32 on CUDA
     cores), with its launches per call, the train stack
     (tapcat off and on; on its bf16 tensor-core route the plain versions
     sum as the tensor cores do, and the drift of the one-fp32-sum order
     is reported) and the post-loss (on its bf16 tensor-core route, the
     same way), values and every gradient leaf, through autograd; then the
     train stack's CUDA-core route at the same shape and depth (fp32 at
     WaveNet-30's widths, bf16 at C=G=24), both tapcat settings, with its
     launches per call, and the post-loss's CUDA-core route at the same
     shape (fp32, and bf16 at S=Q=24);
  7. training: run_training on synthetic_corpus with the wavenet30.json
     train recipe as written (fused frontend + fused stack + tapcat + fused
     post), 20 steps with the loss of each, the frontend kernels launched
     every step and no plain frontend op; the step split into its parts,
     with the port's kernels by name (`training_step_breakdown`); then at
     a fixed state the fused
     step against its plain versions, the unfused PyTorch step and a
     grad_accum=2 step against the one-shot step, a resume from the
     checkpoint, and `python -m lb_wavenet_tpu_torch.cli train` for 2 steps
     followed by `serve` and `eval` from its checkpoint directory;
  8. evaluation: `evaluate` of the trained params on a held-out
     synthetic_corpus (another seed), fused and plain forward, and a short
     run_training with in-training eval records;
  9. model-sharded serving of configs/stress_gen.json (the 512-skip stress
     config: 3x10 dilations, C=G=64, S=512, Q=256, bf16) at full width,
     B=256, random weights from a numpy seed: `tp_kernel`, kernel B7
     (tp_fused_stack) against its plain version at S_l = 512 and on each
     256-wide half, bit-identical on the bf16 tensor-core route, whose skip
     sums must concatenate to the whole one;
     `tp_serving_1rank`, one NCCL rank (model axis 1) in this process:
     mesh_generate_classes(engine="mega") greedy against single-device mega
     (every B7 choice held to the plain scores on its own history), B7 once
     per step and never its plain version, a ShardedSession in chunks
     against the one-shot run, reset_lanes against a fresh session, the
     pallas engine on the model group, the TP step split into its parts and
     delivered audio-sec/s against single-device mega; `tp_serving_2rank`,
     two processes sharing the card over gloo (model axis 2, S_l = 256):
     greedy and explicit-lane-seed sampled runs equal across ranks and to
     the one-rank run, a mesh SessionPool serving 6 requests (two on
     recycled lanes), and `torchrun --nproc-per-node 2 -m
     lb_wavenet_tpu_torch.cli serve --mesh-model 2` writing that pool's
     audio;
 10. the mel-conditioned vocoder (configs/wavenet30_mel.json at full width:
     n_mels=80, Cc=64, upsample 4x8x8, gen batch 64; speakers as the
     override n_speakers=8, E=16, weights from the same numpy seed):
     `mel_kernels`, the conditioned B2 (B=512 and 64), B6, B1 (B=512 and
     100) and B7 (the skip halves, S_l=128, at B=64 and 4) against their
     plain versions, bit for bit on the tensor cores at Cc'=64 and 80;
     the CUDA-core route with cond (fp32 within FP32_ATOL; bf16 at C=24:
     one stack step within LOGIT_ATOL, mega and turbo free runs under the
     near-argmax check); the conditioned mega's logits against the plain
     forward; `mel_serving`, with the four counts set to 0 before it and
     read after: log-mel of 8 synthetic waveforms on the card, upsampled
     once per request, served through a mega pool of batch 64 (chunk
     1024, recycled lanes, a replay bit for bit), full pools of 64 and 512
     (delivered audio-sec/s, the cond slab's share), a turbo pool, a
     speaker pool (Cc'=80), the pallas engine, a chunked run against the
     one-shot run, `cli generate --mel --stream-chunk` from a checkpoint
     against the in-process audio, and one NCCL rank of model-sharded
     conditioned serving;
 11. timings at the serving and training shapes (mega and turbo at B=512
     and at wavenet30.json's gen batch 64), the conditioned kernels against
     the unconditioned ones (`mel_timing`) and the `kernels` JSON line,
     each row with its unit (rows B3-B5 time a whole call of several
     launches; the `*_cond` rows at the mel config's B=64), the card's
     name and power limit, and last the {"ok": true, ...} line.

Launch counts are set to 0 right before each path is driven and read right
after; comparison launches are not counted. Each phase logs its seconds.
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
GEN_B = 64          # configs/wavenet30.json gen.batch_size: timed beside B
CUDA_CORE_T = 128   # steps of the bf16 CUDA-core-route sampling check (C=24)
LOGIT_ATOL = 5e-2   # bf16 operands: a flipped rounding moves logits ~1e-2
FP32_ATOL = 1e-3    # fp32 over 128 teacher-forced steps: sums in another order
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
TP_CONFIG = os.path.join(ROOT, "configs", "stress_gen.json")
TP_B = 256          # stress_gen.json gen.batch_size
TP_STEPS = 256      # steps of the model-sharded greedy and sampled runs
TP_CHUNK = 64       # ShardedSession chunk of the chunked-equals-one-shot check
TP_T = 1000         # the step of the B7-vs-plain check
TP_SEED = 17        # session seed of the model-sharded runs
# B7 vs its plain version, max |difference| over the largest |skip|: the
# same bf16-rounded operands summed in another order (expected <= 1e-3); a
# flipped rounding of one activation can move a skip value by ~1e-2 of it.
TP_RTOL = 1e-2
TP_POOL, TP_POOL_CHUNK = 4, 256   # the mesh pool: 6 requests, two on recycled lanes


MEL_CONFIG = os.path.join(ROOT, "configs", "wavenet30_mel.json")
MEL_B = 64          # wavenet30_mel.json gen.batch_size
MEL_T = 128         # teacher-forced steps of the conditioned kernel-vs-plain checks
MEL_SPEAKERS = 8    # n_speakers of the speaker-conditioned override (E = 16: Cc' = 80)
MEL_REQUESTS = 8    # mel requests through the mel pool
MEL_FWD_T = 16      # steps of the mega-vs-forward check (the two sum orders drift apart)
MEL_TP_STEPS = 128  # steps of the conditioned model-sharded run

KERNEL_SOURCES = ("ar_step", "ar_mega", "ar_turbo", "frontend", "train_stack", "post_loss",
                  "ar_tp")


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

    out = {
        "embed": w(Q, C),
        "input_conv": {"w": w(K, C, C), "b": b(C)},
        "layers": {
            "w_prev": w(L, C, 2 * G), "w_cur": w(L, C, 2 * G), "b": b(L, 2 * G),
            "w_res": w(L, G, C), "b_res": b(L, C),
            "w_skip": w(L, G, S), "b_skip": b(L, S),
        },
        "post": {"w1": w(S, S), "b1": b(S), "w2": w(S, Q), "b2": b(Q)},
    }
    # The conditioned leaves are drawn after the others, whose values (and
    # so the unconditioned phases' numbers) stay as they were.
    if arch.use_local_cond:
        cc = arch.cond_channels
        out["layers"]["w_cond"] = w(L, cc, 2 * G)
        out["upsampler"] = {"proj_w": w(arch.n_mels, cc), "proj_b": b(cc), "stages": [
            {"w": (rng.standard_normal((2 * f + 1, cc, cc)) / np.sqrt((2 * f + 1) * cc)
                   ).astype(np.float32), "b": b(cc)} for f in arch.upsample_factors]}
    if arch.use_global_cond:
        out["speaker_embed"] = rng.standard_normal(
            (arch.n_speakers, arch.speaker_embed_dim)).astype(np.float32)
        out["layers"]["w_gcond"] = w(L, arch.speaker_embed_dim, 2 * G)
    return out


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


def mega_cost(arch, b: int, t: int, lane_rows: int, wbytes: int, cc: int = 0):
    """(bytes, flops) one mega_generate call must move and do: weights,
    biases, the carry read and written once, forced/lane in, classes out;
    with cc conditioning channels also w_cond, the (t, b, cc) cond rows and
    the cond product of every layer and step."""
    L, C, G = len(arch.dilations), arch.residual_channels, arch.gate_channels
    S, Q, K = arch.skip_channels, arch.quant_channels, arch.input_kernel
    w = L * ((2 * C + cc) * 2 * G + G * (C + S)) + S * S + S * Q + Q * C + K * C * C
    bias = L * (2 * G + C + S) + S + Q + C
    carry = (sum(arch.dilations) * C + L * 2 * C + C + (K - 1) * C) * b
    nbytes = (w * wbytes + 4 * (bias + 2 * carry + t * b + lane_rows * b + t * b)
              + t * b * cc * wbytes)
    flops = 2 * b * t * (L * ((2 * C + cc) * 2 * G + G * (C + S)) + S * S + S * Q
                         + K * C * C)
    return nbytes, flops


def stack_cost(arch, b: int, wbytes: int, cc: int = 0):
    """(bytes, flops) of one fused_stack step: weights, biases, h0, the L
    ring rows read and written, the skip sum out; with cc conditioning
    channels also w_cond, the (b, cc) cond row and its products."""
    L, C, G, S = (len(arch.dilations), arch.residual_channels,
                  arch.gate_channels, arch.skip_channels)
    w = L * ((2 * C + cc) * 2 * G + G * C + G * S)
    nbytes = (w * wbytes + 4 * (L * (2 * G + C + S) + b * C + 2 * L * b * C + b * S)
              + b * cc * wbytes)
    return nbytes, 2 * b * L * ((2 * C + cc) * 2 * G + G * C + G * S)


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


def turbo_cost(arch, b: int, lane_rows: int, wbytes: int, cc: int = 0):
    """(bytes, flops) of one turbo step: weights and biases, h and the
    embedding stack in and out, the L ring rows read and written, forced
    and the lane block in, the classes out; with cc conditioning channels
    also w_cond, the (b, cc) cond row and its products."""
    L, C, G = len(arch.dilations), arch.residual_channels, arch.gate_channels
    S, Q, K = arch.skip_channels, arch.quant_channels, arch.input_kernel
    w = L * ((2 * C + cc) * 2 * G + G * C + G * S) + S * S + S * Q + Q * C + K * C * C
    bias = L * (2 * G + C + S) + S + Q + C
    state = 2 * (C + (K - 1) * C + L * C) * b
    nbytes = w * wbytes + 4 * (bias + state + b + lane_rows * b + b) + b * cc * wbytes
    flops = 2 * b * (L * ((2 * C + cc) * 2 * G + G * C + G * S) + S * S + S * Q
                     + K * C * C)
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


def tp_cost(arch, b: int, s_l: int, wbytes: int, cc: int = 0):
    """(bytes, flops) of one tp_fused_stack step on a skip slice of width
    s_l: weights and biases, h0 in, the L ring rows read and written, the
    local skip sum out; with cc conditioning channels also w_cond, the
    (cc, b) cond tile and its products."""
    L, C, G = len(arch.dilations), arch.residual_channels, arch.gate_channels
    w = L * (2 * G * (2 * C + cc) + (C + s_l) * G)
    nbytes = (w * wbytes + 4 * (L * (2 * G + C + s_l) + C * b + 2 * L * C * b + s_l * b)
              + cc * b * wbytes)
    return nbytes, 2 * L * b * (2 * G * (2 * C + cc) + (C + s_l) * G)


def bound_ms(nbytes: int, flops: int):
    by_bytes, by_ops = nbytes / H100_BYTES_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def phase_environment():
    import torch

    from lb_wavenet_tpu_torch.ops.cuda import build
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F
    from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

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
    # The train stack's route rests on tc_smem: the library must carve the
    # same bytes (WaveNet-30's widths, the stress config's, S = 1024).
    lib = build.load("train_stack")
    smem = {f"C{c}_G{g}_S{s}": (TS.tc_smem(c, g, s), TS.lib_tc_smem(lib, c, g, s))
            for c, g, s in ((64, 64, 256), (64, 64, 512), (64, 64, 1024))}
    # So does the post-loss's (WaveNet-30, the stress config, SMALL's S).
    plib = build.load("post_loss")
    psmem = {f"S{s_}_Q{q}": (PL.tc_smem(s_, q), PL.lib_tc_smem(plib, s_, q))
             for s_, q in ((256, 256), (512, 256), (32, 256))}
    # And B1's and B7's (WaveNet-30's and the stress config's widths, a
    # rank's half of each skip).
    ssmem = stack_smem()
    # And the frontend backward's (WaveNet-30's widths, K = 3 beyond the
    # limit, the tests' C = 16).
    flib = build.load("frontend")
    fsmem = {f"Q{q}_C{c}_K{k}": (F.tc_smem(q, c, k), F.lib_tc_smem(flib, q, c, k))
             for q, c, k in ((256, 64, 2), (256, 64, 3), (256, 16, 3))}
    log(json.dumps({"phase": "ptxas_tensor_core_kernels", "report": tc_ptxas(),
                    "train_stack_tc_smem_bytes": smem, "post_loss_tc_smem_bytes": psmem,
                    "stack_tc_smem_bytes": ssmem, "frontend_tc_smem_bytes": fsmem}))
    require(all(a == b for a, b in fsmem.values()),
            f"csrc/frontend.cu and frontend.tc_smem disagree: {fsmem}")
    require(all(a == b for a, b in smem.values()),
            f"csrc/train_stack.cu and train_stack.tc_smem disagree: {smem}")
    require(all(a == b for a, b in psmem.values()),
            f"csrc/post_loss.cu and post_loss.tc_smem disagree: {psmem}")
    require(all(a == b for a, b in ssmem.values()),
            f"csrc/ar_step.cu or csrc/ar_tp.cu and ar_tc.stack_smem disagree: {ssmem}")


def stack_smem() -> dict:
    """{kernel and widths: (host's bytes, library's bytes)} of the
    tensor-core stack kernels' dynamic shared memory."""
    from lb_wavenet_tpu_torch.ops.cuda import ar_tc, build

    out = {}
    for name, src, s, cc in (("fused_stack", "ar_step", 256, 0),
                             ("fused_stack", "ar_step", 128, 0),
                             ("tp_fused_stack", "ar_tp", 512, 0),
                             ("tp_fused_stack", "ar_tp", 256, 0),
                             ("fused_stack", "ar_step", 256, 64),   # the mel vocoder
                             ("fused_stack", "ar_step", 256, 80),   # mel + speaker
                             ("tp_fused_stack", "ar_tp", 128, 64),
                             ("tp_fused_stack", "ar_tp", 128, 80)):
        out[f"{name} C64_G64_S{s}_L30_Cc{cc}"] = (
            ar_tc.stack_smem(64, 64, s, 30, cc)[0],
            ar_tc.lib_stack_smem(build.load(src), name, 64, 64, s, 30, cc))
    return out


def tc_ptxas() -> dict:
    """The ptxas report (registers, stack, spills) of the tensor-core
    kernels (bf16 mega and turbo, B1 and B7's `stack_tc_kernel`, the train
    stack's `tsc` route, the post-loss's `ptc` route, the frontend's tap
    table and `ftc` backward), from this process's build log."""
    from lb_wavenet_tpu_torch.ops.cuda import build

    out = {}
    for src in ("ar_mega", "ar_turbo", "ar_step", "ar_tp", "train_stack", "post_loss",
                "frontend"):
        lines = build.build_log.get(src, "").splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and any(
                    m in ln for m in ("tc_kernel", "3tsc", "3ptc", "3ftc", "table_tc")):
                out[f"{src}: {ln.split(chr(39))[1]}"] = [x.replace("ptxas info    :", "").strip()
                                          for x in lines[i + 1:i + 4]
                                          if "Compiling" not in x and "Compile time" not in x]
    return out


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
    route = step_route(arch, arch.skip_channels)
    # On the tensor-core route the plain version sums as the kernel does:
    # ring and skip must be bit-identical, at the pool batch and a ragged one.
    atol = 0.0 if route == "tensor_cores" else LOGIT_ATOL
    errs = {}
    for b in (B, TURBO_POOL):
        ring = torch.randn((sum(arch.dilations), b, c), device="cuda", generator=g)
        h0 = torch.randn((b, c), device="cuda", generator=g)
        r_k, r_p = ring.clone(), ring.clone()
        _, skip_k = ar_step.fused_stack(params["layers"], arch, h0, r_k, 1000)
        torch.cuda.synchronize()
        _, skip_p = ar_step.fused_stack_plain(params["layers"], arch, h0, r_p, 1000)
        errs[f"B={b}"] = {"ring": abs_err(r_k, r_p), "skip": abs_err(skip_k, skip_p)}
    err = max(max(v.values()) for v in errs.values())
    log(json.dumps({"phase": "fused_stack_vs_plain", "gpu": gpu, "t": 1000, "route": route,
                    "max_abs_err": errs, "bit_identical": err == 0.0, "atol": atol}))
    require(err <= atol, f"fused_stack differs from plain: {errs}")
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
    base = {k: v.clone() for k, v in ck.items()}
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
    atol = sampling_atol(arch)
    err = float((lk - lpl).abs().max())
    carry_err = max(float((ck[k] - cp[k]).abs().max()) for k in ck)
    # The same plain run with each product as one fp32 sum (the order of B7
    # and the fp32 kernels): how far another valid summation order moves
    # this chaotic network.
    co = {k: v.clone() for k, v in base.items()}
    _, lo = ar_mega.mega_generate_plain(params, lp, arch, co, t0, forced[:, 0], 1.0, True,
                                        lane, 12345, tensor_cores=False)
    log(json.dumps({"phase": "mega_teacher_forced_vs_plain", "gpu": gpu,
                    "B": B, "T": CHUNK, "t0": t0, "lane_rows": 3,
                    "max_abs_err": err, "carry_max_abs_err": carry_err,
                    "bit_identical": err == 0.0 and carry_err == 0.0, "atol": atol,
                    "one_fp32_sum_order_vs_tensor_core_order": {
                        "logits_max_abs_diff": abs_err(lo, lpl),
                        "carry_max_abs_diff": max(abs_err(co[k], cp[k]) for k in co)}}))
    require(err <= atol and carry_err <= atol,
            f"mega teacher-forced logits/carry differ: {err}, {carry_err}")
    report["mega_generate"] = err
    del ck, cp, co, base, lk, lpl, lo

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


def phase_cuda_core_sampling(arch, gpu):
    """bf16 mega and turbo at a width the tensor-core kernels do not take
    (WaveNet-30 with C = 24): the CUDA-core route, against the plain
    versions in their one-fp32-sum order, teacher-forced over CUDA_CORE_T
    steps at B = GEN_B (comparison launches: the counters are restored)."""
    import dataclasses

    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.models.wavenet import init_params
    from lb_wavenet_tpu_torch.ops.cuda import ar_mega, ar_tc, ar_turbo

    arch = dataclasses.replace(arch, residual_channels=24)
    require(ar_tc.route(arch, torch.bfloat16) == "cuda_cores", "C=24 left the CUDA-core route")
    p = init_params(21, arch, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    b, t = GEN_B, CUDA_CORE_T
    lane = torch.stack([torch.randint(0, 2**31 - 1, (b,), device="cuda", generator=gen),
                        torch.zeros(b, device="cuda", dtype=torch.int64)]).to(torch.int32)
    forced = torch.randint(0, arch.quant_channels, (t, b), device="cuda", dtype=torch.int32,
                           generator=gen)
    h0, e0 = G._fused_frontend_zero(p, arch, b)
    counts = ar_mega.mega_generate.launches, ar_turbo.turbo_step.launches
    errs = {}
    for name, kernel, plain, state in (
            ("mega", ar_mega.mega_generate_cuda, ar_mega.mega_generate_plain,
             lambda: ar_mega.mega_zero_carry(arch, h0, e0)),
            ("turbo", ar_turbo.turbo_generate_cuda, ar_turbo.turbo_generate_plain,
             lambda: {"bufs": torch.zeros((sum(arch.dilations), b, 24), device="cuda"),
                      "h": h0.clone(), "e": e0.clone()})):
        _, lk = kernel(p, p["layers"], arch, state(), 0, forced, 1.0, True, lane, 3)
        _, lp = plain(p, p["layers"], arch, state(), 0, forced, 1.0, True, lane, 3)
        torch.cuda.synchronize()
        errs[name] = abs_err(lk, lp)
    ar_mega.mega_generate.launches, ar_turbo.turbo_step.launches = counts
    log(json.dumps({"phase": "bf16_sampling_cuda_core_route", "gpu": gpu, "C": 24, "B": b,
                    "T": t, "max_abs_logit_err": errs, "atol": LOGIT_ATOL}))
    require(max(errs.values()) <= LOGIT_ATOL, f"bf16 sampling at C=24 differs: {errs}")


def phase_stack_cuda_core(arch, gpu):
    """B1 (WaveNet-30, B = TURBO_POOL) and B7 (the stress config, B = TP_B)
    on their CUDA-core route: fp32 at the configs' widths and bf16 with
    C = 24, against the plain versions in their one-fp32-sum order, B1
    within LOGIT_ATOL, B7's ring within LOGIT_ATOL and its skip within
    TP_RTOL of its largest value (comparison launches: the counters are
    restored)."""
    import dataclasses

    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype, init_params
    from lb_wavenet_tpu_torch.ops.cuda import ar_step, ar_tp

    tp_arch = tp_setup()[0]
    counts = ar_step.fused_stack.launches, ar_tp.tp_fused_stack.launches
    readings = {}
    for kernel, base, b in (("fused_stack", arch, TURBO_POOL), ("tp_fused_stack", tp_arch, TP_B)):
        for name, change in (("fp32", {"compute_dtype": "float32"}),
                             ("bf16_C24", {"residual_channels": 24})):
            a = dataclasses.replace(base, **change)
            require(step_route(a, a.skip_channels) == "cuda_cores",
                    f"{kernel} {name} left the CUDA-core route")
            p = init_params(22, a, "cuda")
            g = torch.Generator(device="cuda").manual_seed(22)
            c = a.residual_channels
            if kernel == "fused_stack":
                ring = torch.randn((sum(a.dilations), b, c), device="cuda", generator=g)
                h0 = torch.randn((b, c), device="cuda", generator=g)
                fn, plain, lp = ar_step.fused_stack, ar_step.fused_stack_plain, p["layers"]
            else:
                ring = torch.randn((sum(a.dilations), c, b), device="cuda", generator=g)
                h0 = torch.randn((c, b), device="cuda", generator=g)
                fn, plain = ar_tp.tp_fused_stack, ar_tp.tp_fused_stack_plain
                lp = G._tp_weights(p, p["layers"], compute_dtype(a))
            r_k, r_p = ring.clone(), ring.clone()
            _, s_k = fn(lp, a, h0, r_k, 700)
            torch.cuda.synchronize()
            _, s_p = plain(lp, a, h0, r_p, 700)
            readings[f"{kernel} {name}"] = {"ring": abs_err(r_k, r_p), "skip": abs_err(s_k, s_p),
                                            "skip_rel": rel_err(s_k, s_p)}
    ar_step.fused_stack.launches, ar_tp.tp_fused_stack.launches = counts
    log(json.dumps({"phase": "stack_cuda_core_routes", "gpu": gpu,
                    "B": {"fused_stack": TURBO_POOL, "tp_fused_stack": TP_B},
                    "readings": readings, "atol": LOGIT_ATOL, "tp_rtol": TP_RTOL}))
    for name, r in readings.items():
        ok = r["ring"] <= LOGIT_ATOL and (r["skip_rel"] <= TP_RTOL if name.startswith("tp")
                                          else r["skip"] <= LOGIT_ATOL)
        require(ok, f"{name} on the CUDA-core route differs: {r}")


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
    atol = sampling_atol(arch)
    step_err = max(abs_err(bk, bp), abs_err(hk, sp["h"]), abs_err(ek, sp["e"]),
                   abs_err(lk, lpl[0]))
    gap = check_choices(lpl.transpose(1, 2), ck[None], 1.0, _shift_lane(lane3, 1000),
                        forced[None])
    log(json.dumps({"phase": "turbo_step_vs_plain", "gpu": gpu, "B": B, "t": 1000,
                    "lane_rows": 3, "max_abs_err": step_err, "classes_equal":
                    bool(torch.equal(ck, cp[0])), "max_choice_gap": gap,
                    "atol": atol}))
    require(step_err <= atol and gap <= 2 * LOGIT_ATOL,
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
                    "state_max_abs_err": state_err,
                    "bit_identical": err == 0.0 and state_err == 0.0, "atol": atol}))
    require(err <= atol and state_err <= atol,
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


def serve_pool(params, arch, requests, batch, first_wave, engine="mega", mesh=None,
               chunk=CHUNK):
    """Serve `requests` through a pipelined SessionPool (on `mesh`, if
    given); the first `first_wave` go in at once, the rest as lanes free up
    (so they take recycled lanes). Returns ({id: classes}, {id: lane},
    stats, wall)."""
    import numpy as np
    import torch

    from lb_wavenet_tpu_torch.serving import SessionPool

    pool = SessionPool(params, arch, batch, 0, engine=engine, chunk_size=chunk,
                       temperature=1.0, pipeline=True, mesh=mesh, device="cuda")
    out, lanes, parts = {}, {}, {}
    queue = list(requests)

    def submit(r):
        ok = pool.submit(r["id"], r["n_samples"], seed=r["seed"],
                         temperature=r["temperature"], speaker=r.get("speaker"),
                         cond_fn=r.get("cond_fn"))
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


def tp_setup():
    """(arch, params on the card) of the stress config, weights from a
    numpy seed."""
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    arch = Config.load(TP_CONFIG).arch
    return arch, params_from_jax(numpy_params(arch, 5), device="cuda")


def skip_half(lp: dict, arch, rank: int) -> dict:
    """Layer params with w_skip/b_skip cut to model rank `rank` of two."""
    s = arch.skip_channels // 2
    sl = slice(rank * s, (rank + 1) * s)
    return {**lp, "w_skip": lp["w_skip"][..., sl], "b_skip": lp["b_skip"][..., sl]}


def tp_lanes():
    """An explicit (2, TP_B) int32 lane block (seeds, lease times 0)."""
    import numpy as np

    rng = np.random.default_rng(23)
    return np.stack([rng.integers(0, 2**31 - 1, TP_B), np.zeros(TP_B)]).astype(np.int32)


def tp_requests():
    """6 requests with seeds and temperatures; the last two take recycled
    lanes of the TP_POOL-lane mesh pool."""
    return [{"id": f"m{i}", "n_samples": 500 + 123 * i, "seed": 70 + 11 * i,
             "temperature": (0.0, 0.7, 1.0)[i % 3]} for i in range(6)]


def hold_tp_choices(params, arch, classes, temperature, lane=None, cond=None):
    """check_choices for a (B, T) run of the model-sharded path: the plain
    mega version teacher-forced on its classes (and its cond (B, T, Cc)),
    each product in one fp32 sum (the order of the sharded path's post
    network; B7 sums its layers in the tensor-core order on its bf16
    route), then the gap of every choice."""
    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.ops.cuda import ar_mega

    cls = torch.as_tensor(classes).cuda().t().contiguous()
    h0, e0 = G._fused_frontend_zero(params, arch, cls.shape[1])
    carry = ar_mega.mega_zero_carry(arch, h0, e0)
    lane = None if lane is None else torch.as_tensor(lane).cuda()
    _, lg = ar_mega.mega_generate_plain(
        params, params["layers"], arch, carry, 0, cls, temperature, True, lane, 0,
        tensor_cores=False, cond=None if cond is None else cond.transpose(0, 1))
    return check_choices(lg, cls, temperature, lane, torch.full_like(cls, -1))


def compare_runs(a, b):
    """(first divergent step or None, share of lanes equal) of two (B, T)
    class runs."""
    import torch

    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    diff = (a != b).any(dim=0).nonzero()
    return (int(diff[0]) if len(diff) else None), float((a == b).all(dim=1).float().mean())


@contextlib.contextmanager
def no_plain_tp():
    """Fail if the model-sharded path runs B7's plain version."""
    from lb_wavenet_tpu_torch.ops.cuda import ar_tp

    def refuse(*_):
        raise SmokeFailure("the model-sharded path ran tp_fused_stack's plain version")

    saved = ar_tp.tp_fused_stack_plain
    ar_tp.tp_fused_stack_plain = refuse
    try:
        yield
    finally:
        ar_tp.tp_fused_stack_plain = saved


def phase_tp_kernel(params, arch, gpu):
    """B7 against its plain version at B=256 on the whole skip width and on
    each half (the two ranks of a model axis of 2)."""
    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import ar_tp

    g = torch.Generator(device="cuda").manual_seed(5)
    c = arch.residual_channels
    ring = torch.randn((sum(arch.dilations), c, TP_B), device="cuda", generator=g)
    h0 = torch.randn((c, TP_B), device="cuda", generator=g)
    slots = [o + TP_T % d for o, d in zip(G.buffer_offsets(arch), arch.dilations)]
    untouched = torch.ones(len(ring), dtype=torch.bool, device="cuda")
    untouched[slots] = False
    lp = params["layers"]
    skips, readings = {}, {}
    for name, layers in (("S_l=512", lp), ("S_l=256 rank 0", skip_half(lp, arch, 0)),
                         ("S_l=256 rank 1", skip_half(lp, arch, 1))):
        fm = G._tp_weights(params, layers, compute_dtype(arch))
        r_k, r_p = ring.clone(), ring.clone()
        _, s_k = ar_tp.tp_fused_stack(fm, arch, h0, r_k, TP_T)
        torch.cuda.synchronize()
        _, s_p = ar_tp.tp_fused_stack_plain(fm, arch, h0, r_p, TP_T)
        skips[name] = s_k
        readings[name] = {
            "route": step_route(arch, layers["w_skip"].shape[-1]),
            "ring_exact_where_unwritten_and_layer0": bool(
                torch.equal(r_k[untouched], ring[untouched]) and torch.equal(r_k[slots[0]], h0)),
            "ring_max_abs_err": abs_err(r_k, r_p), "skip_max_abs_err": abs_err(s_k, s_p),
            "skip_rel_err": rel_err(s_k, s_p), "skip_max_abs": float(s_p.abs().max()),
        }
    halves_equal = bool(torch.equal(
        torch.cat([skips["S_l=256 rank 0"], skips["S_l=256 rank 1"]]), skips["S_l=512"]))
    log(json.dumps({"phase": "tp_kernel", "gpu": gpu, "config": "configs/stress_gen.json",
                    "B": TP_B, "t": TP_T, "readings": readings,
                    "halves_concatenate_to_whole": halves_equal,
                    "tensor_core_route_atol": 0.0, "cuda_core_route": {
                        "rtol": TP_RTOL, "ring_atol": LOGIT_ATOL}}))
    for name, r in readings.items():
        # The tensor-core route's plain version sums as the kernel does.
        exact = r["route"] == "tensor_cores"
        require(r["ring_exact_where_unwritten_and_layer0"]
                and r["ring_max_abs_err"] <= (0.0 if exact else LOGIT_ATOL)
                and (r["skip_max_abs_err"] == 0.0 if exact else r["skip_rel_err"] <= TP_RTOL),
                f"tp_fused_stack ({name}) differs: {r}")
    require(halves_equal, "the two halves' skip sums do not concatenate to the whole one")
    return {"tp_fused_stack": max(r["skip_max_abs_err"] for r in readings.values())}


def tp_step_split(fm, arch, mesh, params, steps: int):
    """Device time (CUDA events) of the TP step's parts over `steps` steps
    of a fresh greedy session: B7, the post network with its all-reduce,
    sampling with the next step's frontend; and the host wall per step."""
    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import ar_mega, ar_tp

    dt = compute_dtype(arch)
    state = G._tp_zero_state(params, arch, TP_B)
    free = torch.full((TP_B,), -1, dtype=torch.int32, device="cuda")
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(steps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        ev[i][0].record()
        _, skip = ar_tp.tp_fused_stack(fm, arch, state["h"], state["bufs"], i)
        ev[i][1].record()
        logits = G._tp_logits(fm, skip, mesh.model_group, dt)
        ev[i][2].record()
        cls = ar_mega.sample_fm(logits, 0.0, None, i, 0, free)
        G._tp_next_frontend(fm, state, cls, dt)
        ev[i][3].record()
    torch.cuda.synchronize()
    wall = 1000.0 * (time.perf_counter() - t0) / steps
    part = [sum(e[k].elapsed_time(e[k + 1]) for e in ev) / steps for k in range(3)]
    return {"kernel_ms": part[0], "post_network_and_all_reduce_ms": part[1],
            "sampling_and_frontend_ms": part[2], "host_wall_ms_per_step": wall}


def phase_tp_serving_1rank(params, arch, gpu):
    """The model-sharded path in this process: one NCCL rank, model axis 1,
    B7 on the whole skip width (S_l = 512), a real one-rank all-reduce.
    Returns (B7 launches of the main path, the readings phase 2 compares
    with, timings)."""
    import numpy as np
    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import ar_step, ar_tp
    from lb_wavenet_tpu_torch.ops.cuda.build import BUILD
    from lb_wavenet_tpu_torch.parallel import synthesis as S
    from lb_wavenet_tpu_torch.parallel.mesh import make_mesh
    from lb_wavenet_tpu_torch.utils.multihost import init_distributed, shutdown

    work = os.path.join(BUILD, "chip_smoke_tp1")   # gitignored, removed below
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        backend = init_distributed(device="cuda", init_method=f"file://{work}/store", rank=0,
                                   world_size=1)
        mesh = make_mesh(1, 1)
        require(backend == "nccl", f"one rank on its own card should run NCCL, not {backend}")
        ar_tp.tp_fused_stack.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_plain_tp():
            greedy = S.mesh_generate_classes(params, arch, TP_SEED, TP_B, TP_STEPS, mesh,
                                             engine="mega", temperature=0.0)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ar_tp.tp_fused_stack.launches
        ref = G.generate_classes(params, arch, TP_SEED, TP_B, TP_STEPS, engine="mega",
                                 temperature=0.0)
        first, lanes_equal = compare_runs(greedy, ref)
        gap = hold_tp_choices(params, arch, greedy, 0.0)
        lane = tp_lanes()
        sess = S.ShardedSession(params, arch, TP_B, TP_SEED, mesh, engine="mega")
        sampled = sess.chunk(TP_STEPS, temperature=1.0, lane_seed=lane[0], lane_t0=lane[1])
        sess = S.ShardedSession(params, arch, TP_B, TP_SEED, mesh, engine="mega")
        chunks = torch.cat([sess.chunk(TP_CHUNK, temperature=1.0)
                            for _ in range(TP_STEPS // TP_CHUNK)], 1)
        one_shot = S.mesh_generate_classes(params, arch, TP_SEED, TP_B, TP_STEPS, mesh,
                                           engine="mega", temperature=1.0)
        chunked_equal = bool(torch.equal(chunks, one_shot))
        # Reset half the lanes of a greedy session: they equal a fresh one's.
        sess = S.ShardedSession(params, arch, TP_B, TP_SEED, mesh, engine="mega")
        sess.chunk(TP_CHUNK, temperature=0.0)
        half = np.arange(TP_B) % 2 == 0
        sess.reset_lanes(half)
        recycled = sess.chunk(TP_CHUNK, temperature=0.0)
        fresh = S.ShardedSession(params, arch, TP_B, TP_SEED, mesh, engine="mega").chunk(
            TP_CHUNK, temperature=0.0)
        reset_equal = bool(torch.equal(recycled[half], fresh[half]))
        # The pallas engine on the model group: B1 once per step, the same
        # greedy classes as the single-device pallas engine.
        n_pallas = 64
        ar_step.fused_stack.launches = 0
        pallas = S.mesh_generate_classes(params, arch, TP_SEED, TP_B, n_pallas, mesh,
                                         engine="pallas", temperature=0.0)
        pallas_launches = ar_step.fused_stack.launches
        pallas_ref = G.generate_classes(params, arch, TP_SEED, TP_B, n_pallas,
                                        engine="pallas", temperature=0.0)
        pallas_equal = bool(torch.equal(pallas, pallas_ref))
        counts = (ar_tp.tp_fused_stack.launches, ar_step.fused_stack.launches)
        fm = G._tp_weights(params, params["layers"], compute_dtype(arch))
        split = tp_step_split(fm, arch, mesh, params, 64)
        # Delivered audio-sec/s at B=256: two 1024-step chunks after a
        # warm-up chunk, the TP session against a single-device mega stream.
        sess = S.ShardedSession(params, arch, TP_B, TP_SEED, mesh, engine="mega")
        stream = G.start_stream(arch, TP_B, TP_SEED, engine="mega", params=params)
        chunkers = {
            "tp_session": lambda: sess.chunk(CHUNK, temperature=1.0),
            "single_device_mega": lambda: G.stream_chunk(params, arch, stream, CHUNK,
                                                         temperature=1.0, engine="mega"),
        }
        rates = {}
        for name, chunk in chunkers.items():
            chunk()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                chunk()
            torch.cuda.synchronize()
            rates[name] = TP_B * 2 * CHUNK / arch.sample_rate / (time.perf_counter() - t0)
        ar_tp.tp_fused_stack.launches, ar_step.fused_stack.launches = counts
    finally:
        shutdown()
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({
        "phase": "tp_serving_1rank", "gpu": gpu, "mesh": mesh.describe(),
        "device": str(mesh.device), "config": "configs/stress_gen.json", "B": TP_B,
        "steps": TP_STEPS, "tp_launches": launches, "greedy_wall_s": wall,
        "greedy_vs_single_device_mega": {"first_divergent_step": first,
                                         "lanes_equal": lanes_equal,
                                         "max_choice_gap": gap, "gap_tol": 2 * LOGIT_ATOL},
        "chunked_equals_one_shot": chunked_equal, "reset_half_equals_fresh": reset_equal,
        "pallas_engine": {"steps": n_pallas, "fused_stack_launches": pallas_launches,
                          "classes_equal_single_device": pallas_equal},
        "step_split_64_steps": split,
        "delivered_audio_sec_per_s": rates,
    }))
    require(launches == TP_STEPS, f"B7 launched {launches} times in {TP_STEPS} steps")
    require(greedy.shape == (TP_B, TP_STEPS) and int(greedy.min()) >= 0
            and int(greedy.max()) < arch.quant_channels, "bad model-sharded classes")
    require(gap <= 2 * LOGIT_ATOL, f"B7 chose a class {gap} below the plain max")
    require(chunked_equal and reset_equal, "sharded streaming differs from one-shot/fresh")
    require(pallas_launches == n_pallas and pallas_equal,
            f"pallas engine on the model group: {pallas_launches} launches, "
            f"equal={pallas_equal}")
    return launches, {"greedy": greedy.cpu(), "sampled": sampled.cpu()}, \
        {"split": split, "rates": rates}


def tp_rank(rank, world, store, work):
    """One of two ranks sharing the card (spawned by phase_tp_serving_2rank):
    model axis 2 over gloo, B7 at S_l = 256; results saved under `work`."""
    import torch

    from lb_wavenet_tpu_torch.ops.cuda import ar_tp
    from lb_wavenet_tpu_torch.parallel import synthesis as S
    from lb_wavenet_tpu_torch.parallel.mesh import make_mesh
    from lb_wavenet_tpu_torch.utils.multihost import init_distributed, shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    backend = init_distributed(device="cuda", init_method=f"file://{store}", rank=rank,
                               world_size=world, local_world_size=world)
    mesh = make_mesh(1, world)
    arch, params = tp_setup()
    ar_tp.tp_fused_stack.launches = 0
    greedy = S.mesh_generate_classes(params, arch, TP_SEED, TP_B, TP_STEPS, mesh,
                                     engine="mega", temperature=0.0)
    torch.cuda.synchronize()
    launches = ar_tp.tp_fused_stack.launches
    lane = tp_lanes()
    sess = S.ShardedSession(params, arch, TP_B, TP_SEED, mesh, engine="mega")
    sampled = sess.chunk(TP_STEPS, temperature=1.0, lane_seed=lane[0], lane_t0=lane[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.chunk(TP_CHUNK, temperature=0.0)
    torch.cuda.synchronize()
    step_ms = 1000.0 * (time.perf_counter() - t0) / TP_CHUNK
    out, lanes, stats, wall = serve_pool(params, arch, tp_requests(), TP_POOL, 4,
                                         engine="mega", mesh=mesh, chunk=TP_POOL_CHUNK)
    torch.save({"backend": backend, "device": str(mesh.device), "mesh": mesh.describe(),
                "greedy": greedy.cpu(), "sampled": sampled.cpu(), "launches": launches,
                "step_ms": step_ms, "pool": out, "lanes": lanes, "pool_steps": stats["steps"],
                "pool_wall_s": wall}, os.path.join(work, f"rank{rank}.pt"))
    shutdown()


def phase_tp_serving_2rank(params, arch, one_rank, gpu):
    """Two processes on the one card over gloo (NCCL refuses two ranks on
    one device), model axis 2: each runs B7 on its 256-wide skip half and
    the post hidden is all-reduced through host memory every step."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from lb_wavenet_tpu_torch.ops.cuda.build import BUILD
    from lb_wavenet_tpu_torch.ops.mulaw import mu_law_decode
    from lb_wavenet_tpu_torch.utils.checkpoint import save_params

    work = os.path.join(BUILD, "chip_smoke_tp2")   # gitignored, removed below
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.perf_counter()
        # A failing rank raises here (torch.multiprocessing.spawn checks
        # every exit code and stops the other rank).
        torch.multiprocessing.spawn(tp_rank, args=(2, os.path.join(work, "store"), work),
                                    nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        readings = {}
        for name in ("greedy", "sampled"):
            require(torch.equal(ranks[0][name], ranks[1][name]),
                    f"the two ranks' {name} classes differ")
            first, lanes_equal = compare_runs(ranks[0][name], one_rank[name])
            readings[name] = {"first_divergent_step_vs_1rank": first,
                              "lanes_equal_vs_1rank": lanes_equal}
            if first is not None:
                # The skip split sums the post hidden in another order:
                # hold each choice to the plain scores on its own history.
                temp, lane = (0.0, None) if name == "greedy" else (1.0, tp_lanes())
                gap = hold_tp_choices(params, arch, ranks[0][name], temp, lane)
                readings[name]["max_choice_gap"] = gap
                require(gap <= 2 * LOGIT_ATOL, f"2-rank {name}: a choice {gap} below the max")
        pools = [r["pool"] for r in ranks]
        reqs = tp_requests()
        require(all(set(p) == {q["id"] for q in reqs} for p in pools), "a mesh request is missing")
        for q in reqs:
            require(np.array_equal(pools[0][q["id"]], pools[1][q["id"]])
                    and pools[0][q["id"]].shape == (q["n_samples"],),
                    f"mesh pool request {q['id']} differs between ranks")
        recycled = [q["id"] for q in reqs[4:] if ranks[0]["lanes"][q["id"]] < 4]
        # The same requests through the CLI under torchrun.
        save_params(os.path.join(work, "ckpt"), params, 0)
        req_path = os.path.join(work, "requests.jsonl")
        with open(req_path, "w") as f:
            f.writelines(json.dumps(q) + "\n" for q in reqs)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "lb_wavenet_tpu_torch.cli", "serve",
               "--mesh-model", "2", "--config", TP_CONFIG, "--requests", req_path,
               "--stream-chunk", str(TP_POOL_CHUNK),
               "--set", f"gen.checkpoint_dir={os.path.join(work, 'ckpt')}",
               "--set", f"gen.out_dir={os.path.join(work, 'wav')}",
               "--set", f"gen.batch_size={TP_POOL}", "--set", "gen.temperature=1.0",
               "--set", "gen.engine=mega"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=600)
        cli_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"torchrun CLI serve failed:\n{proc.stderr[-4000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        for q in reqs:
            _, wav = wavfile.read(os.path.join(work, "wav", f"{q['id']}.wav"))
            ref = mu_law_decode(torch.from_numpy(pools[0][q["id"]])).numpy()
            require(np.array_equal(wav, (np.clip(ref, -1, 1) * 32767.0).astype(np.int16)),
                    f"torchrun CLI audio of {q['id']} differs from the mesh pool's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({
        "phase": "tp_serving_2rank", "gpu": gpu, "ranks": 2,
        "backends": [r["backend"] for r in ranks], "devices": [r["device"] for r in ranks],
        "mesh": ranks[0]["mesh"], "config": "configs/stress_gen.json", "B": TP_B,
        "steps": TP_STEPS, "tp_launches_per_rank": [r["launches"] for r in ranks],
        "vs_1rank": readings,
        "step_ms_shared_card_host_staged_gloo": [r["step_ms"] for r in ranks],
        "pool": {"batch": TP_POOL, "chunk": TP_POOL_CHUNK, "requests": len(reqs),
                 "recycled": recycled, "steps": ranks[0]["pool_steps"],
                 "wall_s": ranks[0]["pool_wall_s"]},
        "spawn_s": spawn_s, "torchrun_cli_s": cli_s, "cli_summary": summary,
    }))
    require([r["backend"] for r in ranks] == ["gloo", "gloo"]
            and [r["device"] for r in ranks] == ["cuda:0", "cuda:0"],
            "the two ranks did not share cuda:0 over gloo")
    require(all(r["launches"] == TP_STEPS for r in ranks), "B7 did not launch once per step")
    require(len(recycled) == 2, f"late mesh requests did not take recycled lanes: {recycled}")
    require(summary["served"] == len(reqs) and summary["mesh"] == {
        "data": 1, "model": 2, "backend": "gloo"}, f"torchrun CLI summary: {summary}")
    return [r["step_ms"] for r in ranks]


def abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def sampling_atol(arch) -> float:
    """Tolerance of the mega and turbo kernels against their plain versions
    on the card: 0 where the kernels run on tensor cores, since the plain
    versions then sum as they do (ar_tc.default_order); LOGIT_ATOL else."""
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import ar_tc

    return 0.0 if ar_tc.default_order(arch, compute_dtype(arch), "cuda") else LOGIT_ATOL


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
    counts = F.frontend_fwd.launches, F.frontend_bwd.launches
    # Both routes at the training shape: the arch's (bf16: the tensor-core
    # route, h0 bit for bit) and fp32 (the CUDA-core route).
    for fdt in (dt, torch.float32) if dt != torch.float32 else (dt,):
        route = front_route(arch, fdt)
        leaves = {"embed": params["embed"].detach().clone().requires_grad_(True),
                  "w": params["input_conv"]["w"].detach().clone().requires_grad_(True),
                  "b": params["input_conv"]["b"].detach().clone().requires_grad_(True)}
        n = F.frontend_fwd.launches, F.frontend_bwd.launches
        h = F.fused_frontend(leaves["embed"], {"w": leaves["w"], "b": leaves["b"]}, x,
                             compute_dtype=str(fdt).split(".")[-1])
        (h * dh).sum().backward()
        torch.cuda.synchronize()
        launched = (F.frontend_fwd.launches - n[0], F.frontend_bwd.launches - n[1])
        with torch.no_grad():
            plain = [leaves[k].detach() for k in ("embed", "w", "b")]
            hp = F.frontend_fwd_plain(*plain, x, fdt)
            gp = dict(zip(("embed", "w", "b"),
                          F.frontend_bwd_plain(plain[0], plain[1], x, fdt, dh)))
        errs = {"h0": rel_err(h.detach(), hp),
                **{f"d_{k}": rel_err(leaves[k].grad, gp[k]) for k in gp}}
        tc = route == "tensor_cores"
        log(json.dumps({"phase": "frontend_vs_plain", "gpu": gpu, "dtype": str(fdt),
                        "route": route, "B": TRAIN_B, "T": x.shape[1], "rel_err": errs,
                        "rtol": KERNEL_RTOL, "h0_bit_exact": tc,
                        "launches_fwd_bwd": launched}))
        require(max(errs.values()) <= KERNEL_RTOL, f"frontend ({route}) differs: {errs}")
        require(not tc or torch.equal(h.detach(), hp),
                f"frontend h0 on the tensor-core route differs from plain: {errs['h0']}")
        require(launched == (2, 3 if tc else 4),
                f"frontend ({route}) launched {launched}, not (2, {3 if tc else 4})")
        if fdt == dt:
            report["frontend_fwd"] = abs_err(h.detach(), hp)
            report["frontend_bwd"] = max(abs_err(leaves[k].grad, gp[k]) for k in gp)
        del h, hp, gp, leaves
    F.frontend_fwd.launches, F.frontend_bwd.launches = counts
    del x, dh

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
            # How far the one-fp32-sum order (the CPU's) parts from the
            # kernels over 30 bf16 layers: reported, not held to a limit.
            s1, z1, x1 = TS.stack_fwd_plain(plain, h0, arch.dilations, dt, tapcat, False)
            d1, g1 = TS.stack_bwd_plain(plain, arch.dilations, dt, tapcat, z1, x1, g, False)
            other = {"skip": rel_err(skip.detach(), s1), "z_all": rel_err(zp, z1),
                     "x_all": rel_err(xp, x1), "dh0": rel_err(h.grad, d1),
                     "grads": max(rel_err(lp[k].grad, g1[k]) for k in g1)}
            del s1, z1, x1, d1, g1
        errs = {"skip": rel_err(skip.detach(), sp), "dh0": rel_err(h.grad, dp),
                **{f"layers.{k}": rel_err(lp[k].grad, gp[k]) for k in gp}}
        log(json.dumps({"phase": "train_stack_vs_plain", "gpu": gpu, "tapcat": tapcat,
                        "route": stack_route(arch), "B": TRAIN_B, "T": h0.shape[1],
                        "rel_err": errs, "rtol": KERNEL_RTOL,
                        "one_fp32_sum_order_rel_err": other}))
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
    gbar = torch.tensor(0.37, device="cuda")
    with torch.no_grad():
        plain = {k: v.detach() for k, v in params["post"].items()}
        num_p = PL.post_loss_plain(plain, skip, tgt, mask, TRAIN_W, dt)
        dsp, gp = PL.post_loss_bwd_plain(plain, skip, tgt, mask, TRAIN_W, dt, gbar)
        # How far the one-fp32-sum order (the CPU's) parts from the kernels:
        # reported, not held to a limit.
        num1 = PL.post_loss_plain(plain, skip, tgt, mask, TRAIN_W, dt, False)
        ds1, g1 = PL.post_loss_bwd_plain(plain, skip, tgt, mask, TRAIN_W, dt, gbar, False)
        other = {"num": rel_err(num.detach(), num1), "dskip": rel_err(s.grad, ds1),
                 **{f"post.{k}": rel_err(post[k].grad, g1[k]) for k in g1}}
        del num1, ds1, g1
    head = skip.shape[1] - TRAIN_W
    errs = {"num": rel_err(num.detach(), num_p), "dskip": rel_err(s.grad, dsp),
            **{f"post.{k}": rel_err(post[k].grad, gp[k]) for k in gp}}
    head_zero = not bool(s.grad[:, :head].any())
    log(json.dumps({"phase": "post_loss_vs_plain", "gpu": gpu, "route": post_route(arch),
                    "B": TRAIN_B, "T": skip.shape[1], "W": TRAIN_W, "rel_err": errs,
                    "head_dskip_exactly_zero": head_zero, "rtol": KERNEL_RTOL,
                    "one_fp32_sum_order_rel_err": other}))
    require(max(errs.values()) <= KERNEL_RTOL and head_zero, f"post-loss differs: {errs}")
    report["post_loss_fwd"] = abs_err(num.detach(), num_p)
    report["post_loss_bwd"] = max(abs_err(s.grad, dsp),
                                  *(abs_err(post[k].grad, gp[k]) for k in gp))
    return report


def phase_train_stack_cuda_core(arch, gpu):
    """The train stack's CUDA-core route (the first-version kernels: fp32,
    and bf16 at widths that are not multiples of 16) at the training shape
    and full depth: fp32 at WaveNet-30's widths and bf16 at C = G = 24,
    tapcat off and on, values and every gradient leaf against the plain
    versions (one fp32 sum per product) within KERNEL_RTOL, and each call's
    launches (L + 1 and 3 L + 1). Comparison launches: the counters are
    restored."""
    import dataclasses

    import torch

    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    counts = TS.train_stack_fwd.launches, TS.train_stack_bwd.launches
    L = len(arch.dilations)
    for name, variant in (("fp32", dataclasses.replace(arch, compute_dtype="float32")),
                          ("c24_bf16", dataclasses.replace(arch, residual_channels=24,
                                                           gate_channels=24))):
        dt = compute_dtype(variant)
        require(stack_route(variant) == "cuda_cores", f"{name} left the CUDA-core route")
        layers = params_from_jax(numpy_params(variant, 13), device="cuda")["layers"]
        h0, g = train_inputs(variant, 14)
        for tapcat in (False, True):
            lp = {k: v.detach().clone().requires_grad_(True) for k, v in layers.items()}
            h = h0.clone().requires_grad_(True)
            n_fwd, n_bwd = TS.train_stack_fwd.launches, TS.train_stack_bwd.launches
            skip = TS.make_fused_stack(variant, tapcat=tapcat)(lp, h)
            (skip * g).sum().backward()
            torch.cuda.synchronize()
            launches = (TS.train_stack_fwd.launches - n_fwd, TS.train_stack_bwd.launches - n_bwd)
            with torch.no_grad():
                sp, zp, xp = TS.stack_fwd_plain(layers, h0, variant.dilations, dt, tapcat)
                dp, gp = TS.stack_bwd_plain(layers, variant.dilations, dt, tapcat, zp, xp, g)
            errs = {"skip": rel_err(skip.detach(), sp), "dh0": rel_err(h.grad, dp),
                    **{f"layers.{k}": rel_err(lp[k].grad, gp[k]) for k in gp}}
            log(json.dumps({"phase": "train_stack_cuda_core_route", "gpu": gpu, "arch": name,
                            "C": variant.residual_channels, "S": variant.skip_channels,
                            "tapcat": tapcat, "B": TRAIN_B, "T": h0.shape[1],
                            "launches": launches, "rel_err": errs, "rtol": KERNEL_RTOL}))
            require(launches == (L + 1, 3 * L + 1),
                    f"train stack {name} launched {launches}, not {(L + 1, 3 * L + 1)}")
            require(max(errs.values()) <= KERNEL_RTOL,
                    f"train stack {name} (tapcat={tapcat}) differs: {errs}")
            del skip, sp, zp, xp, dp, gp, lp, h
        del h0, g, layers
    TS.train_stack_fwd.launches, TS.train_stack_bwd.launches = counts


def phase_post_loss_cuda_core(arch, gpu):
    """The post-loss's CUDA-core route (the first-version kernels: fp32, and
    bf16 at widths that are not multiples of 16) at the training shape:
    fp32 at WaveNet-30's widths and bf16 at S = Q = 24, the numerator,
    dskip (head rows exactly 0) and every post leaf against the plain
    versions (one fp32 sum per product) within KERNEL_RTOL, 2 and 3
    launches a call. Comparison launches: the counters are restored."""
    import dataclasses

    import torch

    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    counts = PL.post_loss_fwd.launches, PL.post_loss_bwd.launches
    for name, variant in (("fp32", dataclasses.replace(arch, compute_dtype="float32")),
                          ("s24_bf16", dataclasses.replace(arch, skip_channels=24,
                                                           quant_channels=24))):
        dt = compute_dtype(variant)
        require(post_route(variant) == "cuda_cores", f"{name} left the CUDA-core route")
        post = params_from_jax(numpy_params(variant, 15), device="cuda")["post"]
        skip, tgt, mask = post_inputs(variant, 16)
        gbar = torch.tensor(0.37, device="cuda")
        n_fwd, n_bwd = PL.post_loss_fwd.launches, PL.post_loss_bwd.launches
        num = PL.post_loss_fwd(post, skip, tgt, mask, TRAIN_W, dt)
        dskip, grads = PL.post_loss_bwd(post, skip, tgt, mask, TRAIN_W, dt, gbar)
        torch.cuda.synchronize()
        launches = (PL.post_loss_fwd.launches - n_fwd, PL.post_loss_bwd.launches - n_bwd)
        with torch.no_grad():
            num_p = PL.post_loss_plain(post, skip, tgt, mask, TRAIN_W, dt)
            dsp, gp = PL.post_loss_bwd_plain(post, skip, tgt, mask, TRAIN_W, dt, gbar)
        errs = {"num": rel_err(num, num_p), "dskip": rel_err(dskip, dsp),
                **{f"post.{k}": rel_err(grads[k], gp[k]) for k in gp}}
        head_zero = not bool(dskip[:, :skip.shape[1] - TRAIN_W].any())
        log(json.dumps({"phase": "post_loss_cuda_core_route", "gpu": gpu, "arch": name,
                        "S": variant.skip_channels, "Q": variant.quant_channels,
                        "B": TRAIN_B, "T": skip.shape[1], "W": TRAIN_W, "launches": launches,
                        "rel_err": errs, "head_dskip_exactly_zero": head_zero,
                        "rtol": KERNEL_RTOL}))
        require(launches == (2, 3), f"post-loss {name} launched {launches}, not (2, 3)")
        require(max(errs.values()) <= KERNEL_RTOL and head_zero,
                f"post-loss {name} differs: {errs}")
        del num, dskip, grads, num_p, dsp, gp, skip, tgt, mask, post
    PL.post_loss_fwd.launches, PL.post_loss_bwd.launches = counts


TRAIN_COUNTERS = ("frontend_fwd", "frontend_bwd", "train_stack_fwd", "train_stack_bwd",
                  "post_loss_fwd", "post_loss_bwd")


def stack_route(arch) -> str:
    """The train stack's route at the arch's widths and dtype."""
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    return TS.route(arch.residual_channels, arch.gate_channels, arch.skip_channels,
                    compute_dtype(arch))


def step_route(arch, s: int) -> str:
    """The route of the one-step stack kernels B1 and B7 at the arch's
    widths and dtype on a skip slice of width s."""
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import ar_tc

    return ar_tc.stack_route(arch.residual_channels, arch.gate_channels, s,
                             len(arch.dilations), compute_dtype(arch))


def front_route(arch, dt=None) -> str:
    """The frontend pair's route at the arch's widths and dtype (or dt)."""
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F

    return F.route(arch.quant_channels, arch.residual_channels, arch.input_kernel,
                   compute_dtype(arch) if dt is None else dt)


def post_route(arch) -> str:
    """The post-loss's route at the arch's widths and dtype."""
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL

    return PL.route(arch.skip_channels, arch.quant_channels, compute_dtype(arch))


def train_launches_per_call(arch) -> dict:
    """Kernel launches of one call of each training kernel pair's wrapper,
    on the route the arch takes: the frontend forward takes 2 (the tap
    table, the gather) and its backward 3 on the tensor-core route (the
    pass, the slots' sum, d_w) and 4 on the CUDA-core one; the train-stack
    backward takes 2 L + 3 on the tensor-core route (a g_skip pass, its
    db_skip sum, two passes per layer, one reduction) and 3 L + 1 on the
    CUDA-core one; the post-loss takes 2 and 3 on either route (the row
    pass and the partials' sum; the row pass, the weight-gradient pass and
    the reduction)."""
    L = len(arch.dilations)
    bwd = 2 * L + 3 if stack_route(arch) == "tensor_cores" else 3 * L + 1
    fbwd = 3 if front_route(arch) == "tensor_cores" else 4
    return {"frontend_fwd": 2, "frontend_bwd": fbwd, "train_stack_fwd": L + 1,
            "train_stack_bwd": bwd, "post_loss_fwd": 2, "post_loss_bwd": 3}


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
        per_step = train_launches_per_call(arch)
        log(json.dumps({
            "phase": "training", "gpu": gpu, "B": TRAIN_B, "W": TRAIN_W,
            "T": arch.receptive_field - 1 + TRAIN_W, "steps": state.step,
            "losses": losses, "step_ms": step_ms, "median_step_ms_after_first": ms,
            "samples_per_s": TRAIN_B * TRAIN_W / (ms / 1000.0), "wall_s": wall,
            "launches": launches, "launches_per_step": per_step,
            "routes": {"frontend": front_route(arch), "train_stack": stack_route(arch),
                       "post_loss": post_route(arch)},
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


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def phase_step_breakdown(cfg, corpus, gpu):
    """Where a training step's time goes: after a warm-up, STEP_PARTS steps
    as run_training runs them (prefetched batches) with CUDA events around
    the batch copy, the forward, the backward and Adam + EMA, and the host
    clock around each whole step; then one torch.profiler trace (device
    activity only) of two steps: device time of the port's kernels
    (namespace wn) and of every other kernel, and the largest others. The
    idle share is 1 - device busy time / step wall time, busy time being
    the union of the kernels' spans (a programmatic dependent launch's span
    overlaps the launch before it)."""
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
    kernels, spans = {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 2000.0
            spans.append((e.time_range.start, e.time_range.end))
    ours = sum(v for k, v in kernels.items() if "wn::" in k)
    other = {k: v for k, v in kernels.items() if "wn::" not in k}
    busy = union_us(spans) / 2000.0
    step_ms = statistics.median(wall)
    top = sorted(other.items(), key=lambda kv: -kv[1])[:10]
    port_top = sorted(((k, v) for k, v in kernels.items() if "wn::" in k),
                      key=lambda kv: -kv[1])[:12]
    log(json.dumps({
        "phase": "training_step_breakdown", "gpu": gpu, "steps": STEP_PARTS,
        "device_ms_per_step": ms, "step_wall_ms": step_ms,
        "profile_device_ms_per_step": {"port_kernels": ours,
                                       "other_kernels": sum(other.values()),
                                       "busy": busy},
        "idle_share": (1.0 - busy / step_ms) if busy else "not measured",
        "top_other_kernels_ms_per_step": [[k[:90], v] for k, v in top],
        "top_port_kernels_ms_per_step": [[k[:90], v] for k, v in port_top],
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


# ---------------------------------------------------------------------------
# The mel-conditioned vocoder (configs/wavenet30_mel.json, BASELINE config 3)
# and speaker conditioning: the conditioned variants of B2, B6, B1 and B7.

def mel_setup(n_speakers: int = 0):
    """(arch, params on the card) of configs/wavenet30_mel.json (with
    n_speakers speakers of E = 16 when given), weights from a numpy seed:
    the speaker override shares every leaf of the mel arch."""
    import dataclasses

    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    arch = dataclasses.replace(Config.load(MEL_CONFIG).arch, n_speakers=n_speakers)
    return arch, params_from_jax(numpy_params(arch, 7), device="cuda")


def kernel_counters() -> dict:
    """{name: the wrapper function holding its launch count} of the four
    sampling kernels."""
    from lb_wavenet_tpu_torch.ops.cuda import ar_mega, ar_step, ar_tp, ar_turbo

    return {"mega_generate": ar_mega.mega_generate, "turbo_step": ar_turbo.turbo_step,
            "fused_stack": ar_step.fused_stack, "tp_fused_stack": ar_tp.tp_fused_stack}


@contextlib.contextmanager
def comparison_launches():
    """Launches made to compare a kernel with its plain version are not
    counted: the four sampling counters are restored on exit."""
    saved = {k: f.launches for k, f in kernel_counters().items()}
    try:
        yield
    finally:
        for k, f in kernel_counters().items():
            f.launches = saved[k]


def mel_inputs(arch, g, b: int, lead: tuple, speakers=None):
    """(lp, cond) for a conditioned kernel call: random bf16 cond rows of
    shape lead + (b, Cc), or with `speakers` (params of the speaker arch)
    the rows folded with random speakers' rows into Cc' = Cc + E
    (generate._fold_gcond, as every engine folds them)."""
    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype

    cond = torch.randn((*lead, b, arch.cond_channels), device="cuda",
                       generator=g).to(compute_dtype(arch))
    if speakers is None:
        return None, cond
    ids = torch.randint(0, MEL_SPEAKERS, (b,), device="cuda", generator=g)
    return G._fold_gcond(speakers["layers"], cond, speakers["speaker_embed"][ids],
                         lead[0] if lead else None)


def phase_mel_kernels(params, arch, sp, gpu):
    """The conditioned B2, B6, B1 and B7 against their plain versions on the
    card at the mel config's full width (Cc' = 64, and 80 with speakers),
    bit for bit on the tensor-core route; the CUDA-core route at C = 24 with
    cond within LOGIT_ATOL (B7's skip within TP_RTOL); the conditioned
    mega's teacher-forced logits against the port's plain forward."""
    import dataclasses

    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype, forward, init_params
    from lb_wavenet_tpu_torch.ops.cuda import ar_mega, ar_step, ar_tc, ar_tp, ar_turbo

    g = torch.Generator(device="cuda").manual_seed(31)
    dt = compute_dtype(arch)
    c, cc = arch.residual_channels, arch.cond_channels
    ecc = cc + arch.speaker_embed_dim
    require(all(ar_tc.route(arch, dt, k) == "tensor_cores" for k in (cc, ecc))
            and ar_tc.route(arch, dt, 8) == "cuda_cores"
            and step_route(arch, arch.skip_channels) == "tensor_cores",
            "the mel config left the tensor-core routes (or Cc' = 8 joined them)")

    def lanes(b, t0):
        inv = torch.tensor([0.0, 1 / 0.7, 1.0]).repeat(b // 3 + 1)[:b].cuda()
        return torch.stack([
            torch.randint(0, 2**31 - 1, (b,), device="cuda", dtype=torch.int32, generator=g),
            torch.full((b,), t0 - 100, device="cuda", dtype=torch.int32), inv.view(torch.int32)])

    # The tensor-core checks run a chunk at a mid-stream t0 from a random
    # carry; the CUDA-core ones (t0 = 0) from the zero carry, as the
    # unconditioned C = 24 phase holds that route.
    def mega_pair(a, p, lp, cond, t0=5000):
        b = cond.shape[1]
        h0, e0 = G._fused_frontend_zero(p, a, b)
        ck = ar_mega.mega_zero_carry(a, h0, e0)
        for k in ("bufs", "hstate"):
            if t0:
                ck[k].normal_(generator=g)
        cp = {k: v.clone() for k, v in ck.items()}
        forced = torch.randint(0, a.quant_channels, cond.shape[:2], device="cuda",
                               dtype=torch.int32, generator=g)
        lane = lanes(b, t0)
        _, lk = ar_mega.mega_generate_cuda(p, lp, a, ck, t0, forced, 1.0, True, lane, 5,
                                           cond=cond)
        torch.cuda.synchronize()
        _, lpl = ar_mega.mega_generate_plain(p, lp, a, cp, t0, forced, 1.0, True, lane, 5,
                                             cond=cond)
        return max(abs_err(lk, lpl), max(abs_err(ck[k], cp[k]) for k in ck))

    def turbo_pair(a, p, lp, cond, t0=5000):
        b = cond.shape[1]
        if t0:
            st = {"bufs": torch.randn((sum(a.dilations), b, a.residual_channels),
                                      device="cuda", generator=g),
                  "h": torch.randn((b, a.residual_channels), device="cuda", generator=g),
                  "e": torch.randn((a.input_kernel - 1, b, a.residual_channels),
                                   device="cuda", generator=g)}
        else:
            h0, e0 = G._fused_frontend_zero(p, a, b)
            st = {"bufs": torch.zeros((sum(a.dilations), b, a.residual_channels),
                                      device="cuda"), "h": h0, "e": e0}
        sk = {k: v.clone() for k, v in st.items()}
        forced = torch.randint(0, a.quant_channels, cond.shape[:2], device="cuda",
                               dtype=torch.int32, generator=g)
        lane = lanes(b, t0)
        _, lk = ar_turbo.turbo_generate_cuda(p, lp, a, sk, t0, forced, 1.0, True, lane, 5,
                                             cond=cond)
        torch.cuda.synchronize()
        _, lpl = ar_turbo.turbo_generate_plain(p, lp, a, st, t0, forced, 1.0, True, lane, 5,
                                               cond=cond)
        return max(abs_err(lk, lpl), max(abs_err(sk[k], st[k]) for k in st))

    def stack_pair(a, lp, cond_t):
        b = cond_t.shape[0]
        ring = torch.randn((sum(a.dilations), b, a.residual_channels), device="cuda",
                           generator=g)
        h0 = torch.randn((b, a.residual_channels), device="cuda", generator=g)
        r_k, r_p = ring.clone(), ring.clone()
        _, s_k = ar_step.fused_stack(lp, a, h0, r_k, 1000, cond_t)
        torch.cuda.synchronize()
        _, s_p = ar_step.fused_stack_plain(lp, a, h0, r_p, 1000, cond_t=cond_t)
        return max(abs_err(r_k, r_p), abs_err(s_k, s_p))

    def tp_pair(a, p, lp, cond_t):
        b = cond_t.shape[0]
        fm = G._tp_weights(p, lp, compute_dtype(a))
        ring = torch.randn((sum(a.dilations), a.residual_channels, b), device="cuda",
                           generator=g)
        h0 = torch.randn((a.residual_channels, b), device="cuda", generator=g)
        r_k, r_p = ring.clone(), ring.clone()
        cond_fm = cond_t.t().contiguous()
        _, s_k = ar_tp.tp_fused_stack(fm, a, h0, r_k, TP_T, cond_fm)
        torch.cuda.synchronize()
        _, s_p = ar_tp.tp_fused_stack_plain(fm, a, h0, r_p, TP_T, cond_t=cond_fm)
        return {"ring": abs_err(r_k, r_p), "skip": abs_err(s_k, s_p),
                "skip_rel": rel_err(s_k, s_p)}

    lp = params["layers"]
    exact, core = {}, {}
    with comparison_launches():
        for b in (B, MEL_B):
            exact[f"mega B={b} Cc'={cc}"] = mega_pair(arch, params, lp,
                                                    mel_inputs(arch, g, b, (MEL_T,))[1])
        lp80, cond80 = mel_inputs(arch, g, MEL_B, (MEL_T,), sp)
        exact[f"mega B={MEL_B} Cc'={ecc}"] = mega_pair(arch, sp, lp80, cond80)
        exact[f"turbo B={MEL_B} Cc'={cc}"] = turbo_pair(arch, params, lp,
                                                       mel_inputs(arch, g, MEL_B, (64,))[1])
        lp80, cond80 = mel_inputs(arch, g, MEL_B, (64,), sp)
        exact[f"turbo B={MEL_B} Cc'={ecc}"] = turbo_pair(arch, sp, lp80, cond80)
        for b in (B, TURBO_POOL):
            exact[f"fused_stack B={b} Cc'={cc}"] = stack_pair(
                arch, lp, mel_inputs(arch, g, b, ())[1])
        lp80, cond80 = mel_inputs(arch, g, B, (), sp)
        exact[f"fused_stack B={B} Cc'={ecc}"] = stack_pair(arch, lp80, cond80)
        # B7 on the mel config's skip halves (S_l = 128, a model axis of 2),
        # at the gen batch and at B = 4 (masked copies of the taps).
        tp_read = {}
        for rank in (0, 1):
            for b in (MEL_B, 4):
                tp_read[f"tp_fused_stack S_l=128 rank {rank} B={b} Cc'={cc}"] = tp_pair(
                    arch, params, skip_half(lp, arch, rank), mel_inputs(arch, g, b, ())[1])
        lp80, cond80 = mel_inputs(arch, g, MEL_B, (), sp)
        tp_read[f"tp_fused_stack S_l=128 rank 0 B={MEL_B} Cc'={ecc}"] = tp_pair(
            arch, sp, skip_half(lp80, arch, 0), cond80)
        for k, r in tp_read.items():
            exact[k] = max(r["ring"], r["skip"])

        # The CUDA-core route with cond. fp32 at the mel widths holds the
        # cond term without bf16 rounding (teacher-forced from the zero
        # carry, within FP32_ATOL); bf16 at C = 24 one step of B1 and B7
        # within LOGIT_ATOL, and mega and turbo as free runs whose every
        # choice must be a near-argmax of the plain scores on the kernel's
        # own history (their teacher-forced logits drift by a few bf16
        # rounding flips over the run, reported).
        a32 = dataclasses.replace(arch, compute_dtype="float32")
        a24 = dataclasses.replace(arch, residual_channels=24)
        require(ar_tc.route(a24, dt, cc) == "cuda_cores"
                and step_route(a24, a24.skip_channels) == "cuda_cores"
                and ar_tc.route(a32, torch.float32, cc) == "cuda_cores",
                "C=24 or fp32 left the CUDA-core route")
        p32, p24 = init_params(32, a32, "cuda"), init_params(24, a24, "cuda")
        fp32 = {"mega": mega_pair(a32, p32, p32["layers"],
                                  mel_inputs(a32, g, GEN_B, (CUDA_CORE_T,))[1], t0=0),
                "turbo": turbo_pair(a32, p32, p32["layers"],
                                    mel_inputs(a32, g, GEN_B, (CUDA_CORE_T,))[1], t0=0),
                "fused_stack": stack_pair(a32, p32["layers"],
                                          mel_inputs(a32, g, TURBO_POOL, ())[1])}
        drift = {"mega": mega_pair(a24, p24, p24["layers"],
                                   mel_inputs(a24, g, GEN_B, (CUDA_CORE_T,))[1], t0=0),
                 "turbo": turbo_pair(a24, p24, p24["layers"],
                                     mel_inputs(a24, g, GEN_B, (CUDA_CORE_T,))[1], t0=0)}
        core["fused_stack"] = stack_pair(a24, p24["layers"],
                                         mel_inputs(a24, g, TURBO_POOL, ())[1])
        tp24 = tp_pair(a24, p24, skip_half(p24["layers"], a24, 0),
                       mel_inputs(a24, g, MEL_B, ())[1])
        gaps = {}
        cond24 = mel_inputs(a24, g, GEN_B, (CUDA_CORE_T,))[1]
        free = torch.full((CUDA_CORE_T, GEN_B), -1, device="cuda", dtype=torch.int32)
        lane = torch.stack([torch.randint(0, 2**31 - 1, (GEN_B,), device="cuda",
                                          dtype=torch.int32, generator=g),
                            torch.zeros(GEN_B, device="cuda", dtype=torch.int32)])
        h24, e24 = G._fused_frontend_zero(p24, a24, GEN_B)
        for name, kernel, plain, state, fm in (
                ("mega", ar_mega.mega_generate_cuda, ar_mega.mega_generate_plain,
                 lambda: ar_mega.mega_zero_carry(a24, h24, e24), lambda x: x),
                ("turbo", ar_turbo.turbo_generate_cuda, ar_turbo.turbo_generate_plain,
                 lambda: {"bufs": torch.zeros((sum(a24.dilations), GEN_B, 24), device="cuda"),
                          "h": h24.clone(), "e": e24.clone()}, lambda x: x.transpose(1, 2))):
            cls_k, _ = kernel(p24, p24["layers"], a24, state(), 0, free, 1.0, False, lane, 3,
                              cond=cond24)
            _, lg = plain(p24, p24["layers"], a24, state(), 0, cls_k, 1.0, True, lane, 3,
                          cond=cond24)
            gaps[name] = check_choices(fm(lg), cls_k, 1.0, lane, free)

        # The conditioned mega's teacher-forced logits against the plain
        # forward on the same cond (from the zero state: x = [Q/2, forced]).
        b = 8
        forced = torch.randint(0, arch.quant_channels, (b, MEL_FWD_T), device="cuda",
                               dtype=torch.int32, generator=g)
        cond = mel_inputs(arch, g, MEL_FWD_T, (b,))[1]          # (b, T, Cc)
        _, lk = G.generate_classes(params, arch, 0, b, MEL_FWD_T, cond=cond, forced=forced,
                                   return_logits=True, engine="mega")
        x = torch.cat([torch.full((b, 1), arch.quant_channels // 2, device="cuda",
                                  dtype=torch.int32), forced[:, :-1]], 1)
        with torch.no_grad():
            lf = forward(params, arch, x, cond=cond)
        fwd_err = abs_err(lk, lf)
    log(json.dumps({
        "phase": "mel_kernels", "gpu": gpu, "config": "configs/wavenet30_mel.json",
        "Cc": cc, "Cc_with_speakers": ecc, "T": MEL_T, "turbo_T": 64,
        "tensor_core_route_max_abs_err": exact, "bit_identical": max(exact.values()) == 0.0,
        "b7_readings": tp_read,
        "cuda_core_route": {"fp32_max_abs_err": fp32, "fp32_atol": FP32_ATOL,
                            "bf16_C24_max_abs_err": core, "tp_fused_stack_bf16_C24": tp24,
                            "atol": LOGIT_ATOL, "tp_rtol": TP_RTOL,
                            "bf16_C24_free_run_max_choice_gap": gaps,
                            "gap_tol": 2 * LOGIT_ATOL,
                            "bf16_C24_teacher_forced_logit_drift": drift},
        "mega_vs_plain_forward": {"B": b, "T": MEL_FWD_T, "max_abs_logit_err": fwd_err,
                                  "atol": LOGIT_ATOL},
    }))
    require(max(exact.values()) == 0.0, f"a conditioned kernel differs from plain: {exact}")
    require(max(fp32.values()) <= FP32_ATOL and max(core.values()) <= LOGIT_ATOL
            and tp24["ring"] <= LOGIT_ATOL and tp24["skip_rel"] <= TP_RTOL
            and max(gaps.values()) <= 2 * LOGIT_ATOL,
            f"the conditioned CUDA-core route differs: {fp32}, {core}, {tp24}, {gaps}")
    require(fwd_err <= LOGIT_ATOL, f"conditioned mega differs from forward: {fwd_err}")

    def worst(prefix):
        return max(v for k, v in exact.items() if k.startswith(prefix))

    return {"mega_generate_cond": worst("mega"), "turbo_step_cond": worst("turbo"),
            "fused_stack_cond": worst("fused_stack"),
            "tp_fused_stack_cond": worst("tp_fused_stack")}


def mel_utterances(params, arch, lengths, gpu):
    """Log-mel frames of len(lengths) synthetic waveforms (chords of two
    sinusoids, as data.synthetic_corpus makes), computed on the card, and
    each utterance's conditioning upsampled once (B = 1) on the card.
    Returns (frames (N, F, n_mels), [cond (n, Cc)], ms per upsampling)."""
    import math

    import torch

    from lb_wavenet_tpu_torch.models.conditioning import upsample_cond
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.mel import log_mel_spectrogram

    hop, sr = arch.hop_size, arch.sample_rate
    t = torch.arange(max(lengths), device="cuda") / sr
    f0 = 110.0 * 1.25 ** torch.arange(len(lengths), device="cuda")
    wav = 0.4 * torch.sin(2 * math.pi * f0[:, None] * t) + \
        0.2 * torch.sin(2 * math.pi * 2.5 * f0[:, None] * t)
    frames = log_mel_spectrogram(wav, arch.n_mels, 1024, hop, sr)
    require(bool(torch.isfinite(frames).all()), "non-finite log-mel frames")
    conds, ev = [], []
    for i, n in enumerate(lengths):
        e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        e[0].record()
        conds.append(upsample_cond(params["upsampler"], arch, frames[i: i + 1, : -(-n // hop)],
                                   compute_dtype(arch))[0, :n])
        e[1].record()
        ev.append(e)
    torch.cuda.synchronize()
    return frames, conds, [a.elapsed_time(b) for a, b in ev]


def phase_mel_serving(params, arch, sp, sarch, gpu):
    """The mel vocoder's serving path on the card, the four counts set to 0
    before it and read after: 8 mel requests (log-mel computed on the card,
    upsampled once per request) through a mega pool of batch 64, chunk 1024,
    the last two on recycled lanes, a sampled one replayed alone bit for
    bit; full pools of batch 64 and 512 (delivered audio-sec/s, the cond
    assembly's share); a turbo pool; a speaker-conditioned pool (Cc' = 80);
    the pallas engine with cond; a chunked mel run against the one-shot
    run; `cli generate --mel --stream-chunk` from a checkpoint against the
    in-process one-shot audio; one-rank model-sharded conditioned serving on
    NCCL."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.ops.cuda.build import BUILD
    from lb_wavenet_tpu_torch.parallel import synthesis as S
    from lb_wavenet_tpu_torch.parallel.mesh import make_mesh
    from lb_wavenet_tpu_torch.utils.checkpoint import save_params
    from lb_wavenet_tpu_torch.utils.multihost import init_distributed, shutdown

    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    lengths = [6000 + 1500 * i for i in range(MEL_REQUESTS)]
    frames, conds, up_ms = mel_utterances(params, arch, lengths, gpu)

    def spans(cond):
        return lambda t0, n: cond[t0: t0 + n]

    requests = [{"id": f"m{i}", "n_samples": n, "seed": 700 + i,
                 "temperature": (0.0, 0.7, 1.0)[i % 3], "cond_fn": spans(conds[i])}
                for i, n in enumerate(lengths)]
    first = MEL_REQUESTS - 2
    out, lanes, stats, wall = serve_pool(params, arch, requests, MEL_B, first_wave=first)
    require(len(out) == len(requests) and all(
        out[r["id"]].shape == (r["n_samples"],) and out[r["id"]].max() < arch.quant_channels
        for r in requests), "the mel pool did not deliver every request")
    recycled = [r["id"] for r in requests[first:] if lanes[r["id"]] < first]
    require(len(recycled) == 2, f"late mel requests did not take recycled lanes: {lanes}")
    rep = min((r for r in requests if r["temperature"] > 0 and r["id"] in recycled),
              key=lambda r: r["n_samples"])
    rep_out = serve_pool(params, arch, [rep], 1, first_wave=1)[0]
    replay_equal = bool(np.array_equal(rep_out[rep["id"]], out[rep["id"]]))
    require(replay_equal, f"replay of mel request {rep['id']} differs")
    nst = max(stats["steps"], 1)
    pool_8 = {"requests": len(requests), "pool_batch": MEL_B,
              "audio_sec": sum(lengths) / arch.sample_rate, "wall_s": wall,
              "delivered_audio_sec_per_s": sum(lengths) / arch.sample_rate / wall,
              "recycled_lanes": {rid: lanes[rid] for rid in recycled},
              "replay": {"request": rep["id"], "bit_identical": replay_equal},
              "phase_ms_per_step": {k[:-2]: 1000.0 * v / nst for k, v in stats.items()
                                    if k.endswith("_s")}}

    # Full pools: every lane a 2-chunk mel request (the 8 utterances' cond
    # shared), delivered audio-sec/s and the cond slab's share of the wall.
    full = {}
    for bb in (MEL_B, B):
        reqs = [{"id": f"f{i}", "n_samples": 2 * CHUNK, "seed": i, "temperature": 1.0,
                 "cond_fn": spans(conds[i % MEL_REQUESTS])} for i in range(bb)]
        o, _, st, w = serve_pool(params, arch, reqs, bb, first_wave=bb)
        require(len(o) == bb, f"the full mel pool of {bb} did not deliver")
        full[f"B={bb}"] = {"wall_s": w, "delivered_audio_sec_per_s":
                           bb * 2 * CHUNK / arch.sample_rate / w,
                           "cond_share_of_wall": st["cond_s"] / w,
                           "cond_ms_per_step": 1000.0 * st["cond_s"] / max(st["steps"], 1)}

    # A turbo pool, and a speaker-conditioned mega pool (Cc' = 80).
    treqs = [dict(r, n_samples=min(r["n_samples"], 3 * CHUNK)) for r in requests[:3]]
    n_turbo = counters["turbo_step"].launches
    tout, _, tst, _ = serve_pool(params, arch, treqs, 10, first_wave=3, engine="turbo")
    turbo_steps = counters["turbo_step"].launches - n_turbo
    require(len(tout) == 3 and turbo_steps == tst["steps"] * CHUNK,
            f"the turbo mel pool: {len(tout)} delivered, {turbo_steps} launches")
    sreqs = [dict(r, speaker=s) for r, s in zip(requests[:4], (0, 3, 5, 7))]
    sout, _, _, _ = serve_pool(sp, sarch, sreqs, MEL_B, first_wave=4)
    srep = min((r for r in sreqs if r["temperature"] > 0), key=lambda r: r["n_samples"])
    speaker_replay = bool(np.array_equal(serve_pool(sp, sarch, [srep], 1, first_wave=1)[0][
        srep["id"]], sout[srep["id"]]))
    require(len(sout) == 4 and speaker_replay, "the speaker pool failed or its replay differs")

    # The pallas engine with cond: B1 once per step.
    n_stack = counters["fused_stack"].launches
    cond64 = torch.stack([conds[i % MEL_REQUESTS][:64] for i in range(MEL_B)])
    pcls = G.generate_classes(params, arch, 3, MEL_B, 64, cond=cond64, engine="pallas")
    require(pcls.shape == (MEL_B, 64) and counters["fused_stack"].launches - n_stack == 64,
            "the conditioned pallas engine did not launch B1 once per step")

    # A chunked mel run replays the one-shot run bit for bit.
    n = 4 * CHUNK
    cond8 = torch.stack([cond[:n] for cond in conds])
    one_shot = G.generate_classes(params, arch, 11, MEL_REQUESTS, n, cond=cond8, engine="mega")
    stream = G.start_stream(arch, MEL_REQUESTS, 11, engine="mega", params=params)
    parts = []
    for i in range(4):
        cls, stream = G.stream_chunk(params, arch, stream, CHUNK,
                                     cond=cond8[:, i * CHUNK: (i + 1) * CHUNK], engine="mega")
        parts.append(cls)
    chunked_equal = bool(torch.equal(torch.cat(parts, 1), one_shot))
    require(chunked_equal, "a chunked mel run differs from the one-shot run")

    # `cli generate --mel --stream-chunk` (the StreamingUpsampler path) from
    # a checkpoint against the in-process one-shot audio.
    work = os.path.join(BUILD, "chip_smoke_mel")   # gitignored, removed below
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        save_params(os.path.join(work, "ckpt"), params, 0)
        n_cli = 2 * CHUNK
        mel = frames[:, : -(-n_cli // arch.hop_size) + 4].cpu().numpy()
        np.save(os.path.join(work, "mel.npy"), mel)
        proc = subprocess.run([
            sys.executable, "-m", "lb_wavenet_tpu_torch.cli", "generate",
            "--config", MEL_CONFIG, "--mel", os.path.join(work, "mel.npy"),
            "--stream-chunk", str(CHUNK),
            "--set", f"gen.checkpoint_dir={os.path.join(work, 'ckpt')}",
            "--set", f"gen.out_dir={os.path.join(work, 'wav')}",
            "--set", f"gen.batch_size={MEL_REQUESTS}", "--set", f"gen.n_samples={n_cli}",
            "--set", "gen.engine=mega", "--set", "gen.seed=5"],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        require(proc.returncode == 0, f"cli generate --mel failed:\n{proc.stderr[-4000:]}")
        ref = G.generate(params, arch, 5, MEL_REQUESTS, n_cli, cond_frames=mel,
                         engine="mega").cpu().numpy()
        cli_equal = all(np.array_equal(
            wavfile.read(os.path.join(work, "wav", f"gen_{i:04d}.wav"))[1],
            (np.clip(ref[i], -1, 1) * 32767.0).astype(np.int16)) for i in range(MEL_REQUESTS))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    require(cli_equal, "cli generate --mel --stream-chunk differs from the one-shot audio")

    # One-rank model-sharded conditioned serving on NCCL (B7 with cond).
    work = os.path.join(BUILD, "chip_smoke_mel_tp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    n_tp = counters["tp_fused_stack"].launches
    cond_tp = torch.stack([conds[i % MEL_REQUESTS][:MEL_TP_STEPS] for i in range(MEL_B)])
    try:
        backend = init_distributed(device="cuda", init_method=f"file://{work}/store", rank=0,
                                   world_size=1)
        mesh = make_mesh(1, 1)
        with no_plain_tp():
            greedy = S.mesh_generate_classes(params, arch, 19, MEL_B, MEL_TP_STEPS, mesh,
                                             engine="mega", temperature=0.0, cond=cond_tp)
            sess = S.ShardedSession(params, arch, MEL_B, 19, mesh, engine="mega")
            q = MEL_TP_STEPS // 4
            chunks = torch.cat([sess.chunk(q, cond=cond_tp[:, i * q: (i + 1) * q],
                                           temperature=1.0) for i in range(4)], 1)
            one = S.mesh_generate_classes(params, arch, 19, MEL_B, MEL_TP_STEPS, mesh,
                                          engine="mega", temperature=1.0, cond=cond_tp)
            torch.cuda.synchronize()
    finally:
        shutdown()
        shutil.rmtree(work, ignore_errors=True)
    tp_launches = counters["tp_fused_stack"].launches - n_tp
    ref = G.generate_classes(params, arch, 19, MEL_B, MEL_TP_STEPS, cond=cond_tp,
                             engine="mega", temperature=0.0)
    first_div, lanes_equal = compare_runs(greedy, ref)
    gap = hold_tp_choices(params, arch, greedy, 0.0, cond=cond_tp)
    tp_chunked_equal = bool(torch.equal(chunks, one))
    launches = {f"{k}_cond": f.launches for k, f in counters.items()}
    log(json.dumps({
        "phase": "mel_serving", "gpu": gpu, "config": "configs/wavenet30_mel.json",
        "chunk": CHUNK, "upsample_ms_per_utterance": up_ms, "utterance_samples": lengths,
        "mel_pool": pool_8, "full_pools": full,
        "turbo_pool": {"requests": len(treqs), "pool_batch": 10, "launches": turbo_steps},
        "speaker_pool": {"requests": len(sreqs), "Cc_folded": sarch.cond_channels
                         + sarch.speaker_embed_dim, "replay_bit_identical": speaker_replay},
        "pallas_engine_steps": 64, "chunked_equals_one_shot": chunked_equal,
        "cli_generate_mel_stream_equals_one_shot": cli_equal,
        "tp_1rank": {"backend": backend, "B": MEL_B, "steps": MEL_TP_STEPS,
                     "b7_launches": tp_launches, "greedy_vs_single_device_mega": {
                         "first_divergent_step": first_div, "lanes_equal": lanes_equal,
                         "max_choice_gap": gap, "gap_tol": 2 * LOGIT_ATOL},
                     "chunked_equals_one_shot": tp_chunked_equal},
        "launches": launches,
    }))
    require(backend == "nccl", f"one rank on its card should run NCCL, not {backend}")
    require(tp_launches == 3 * MEL_TP_STEPS, f"B7 launched {tp_launches} times")
    require(gap <= 2 * LOGIT_ATOL, f"conditioned B7 chose a class {gap} below the plain max")
    require(tp_chunked_equal, "the conditioned sharded session differs from one-shot")
    require(all(v > 0 for v in launches.values()), f"a conditioned kernel never ran: {launches}")
    return launches, {"upsample_ms": up_ms, "pool": pool_8, "full": full}


def phase_mel_timing(params, arch, measured, errs, launches, gpu):
    """The conditioned kernels timed against the unconditioned ones on the
    same inputs (mega per 1024-step chunk and turbo and B1 per step at B=64
    and 512, B7 per step at S_l=128, B=64), each beside its bound; one
    utterance's upsampling; the `kernels` rows of the conditioned variants
    (B=64, Cc'=64)."""
    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.models.conditioning import upsample_cond
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import ar_mega, ar_step, ar_tp, ar_turbo

    dt = compute_dtype(arch)
    wb, cc = torch.finfo(dt).bits // 8, arch.cond_channels
    lp = params["layers"]
    g = torch.Generator(device="cuda").manual_seed(41)
    table, rows = {}, []
    with comparison_launches():
        for b in (MEL_B, B):
            h0, e0 = G._fused_frontend_zero(params, arch, b)
            carry = ar_mega.mega_zero_carry(arch, h0, e0)
            free = torch.full((CHUNK, b), -1, device="cuda", dtype=torch.int32)
            lane = torch.stack([torch.arange(b, device="cuda", dtype=torch.int32),
                                torch.zeros(b, device="cuda", dtype=torch.int32),
                                torch.full((b,), 1 / 0.7, device="cuda").view(torch.int32)])
            cond = mel_inputs(arch, g, b, (CHUNK,))[1]
            state = {"bufs": torch.zeros((sum(arch.dilations), b, arch.residual_channels),
                                         device="cuda"), "h": h0.clone(), "e": e0.clone()}
            ring = torch.randn((sum(arch.dilations), b, arch.residual_channels), device="cuda",
                               generator=g)
            hh = torch.randn((b, arch.residual_channels), device="cuda", generator=g)
            for name, kw in (("uncond", {}), ("cond", {"cond": cond})):
                table[f"mega B={b} {name}"] = cuda_ms(lambda: ar_mega.mega_generate_cuda(
                    params, lp, arch, carry, 0, free, 1.0, False, lane, 0, **kw), 2)
                tc = {} if not kw else {"cond": cond[:64]}
                table[f"turbo B={b} {name}"] = cuda_ms(lambda: ar_turbo.turbo_generate_cuda(
                    params, lp, arch, state, 0, free[:64], 1.0, False, lane, 0, **tc), 3) / 64
                ct = None if not kw else cond[0]
                table[f"fused_stack B={b} {name}"] = cuda_ms(
                    lambda: ar_step.fused_stack(lp, arch, hh, ring, 700, ct), 50)
            table[f"bound mega B={b}"] = [bound_ms(*mega_cost(arch, b, CHUNK, 3, wb, k))[0]
                                          for k in (0, cc)]
            table[f"bound turbo B={b}"] = [bound_ms(*turbo_cost(arch, b, 3, wb, k))[0]
                                           for k in (0, cc)]
            table[f"bound fused_stack B={b}"] = [bound_ms(*stack_cost(arch, b, wb, k))[0]
                                                 for k in (0, cc)]
        b = MEL_B
        lp_h = skip_half(lp, arch, 0)
        fm_u = G._tp_weights(params, {k: v for k, v in lp_h.items() if k != "w_cond"}, dt)
        fm_c = G._tp_weights(params, lp_h, dt)
        ring_t = torch.randn((sum(arch.dilations), arch.residual_channels, b), device="cuda",
                             generator=g)
        h0_t = torch.randn((arch.residual_channels, b), device="cuda", generator=g)
        cond_fm = mel_inputs(arch, g, b, ())[1].t().contiguous()
        table["tp_fused_stack S_l=128 uncond"] = cuda_ms(
            lambda: ar_tp.tp_fused_stack(fm_u, arch, h0_t, ring_t, 700), 50)
        table["tp_fused_stack S_l=128 cond"] = cuda_ms(
            lambda: ar_tp.tp_fused_stack(fm_c, arch, h0_t, ring_t, 700, cond_fm), 50)
        s_l = arch.skip_channels // 2
        table["bound tp_fused_stack S_l=128"] = [bound_ms(*tp_cost(arch, b, s_l, wb, k))[0]
                                                 for k in (0, cc)]
        # The kernels rows (B = 64, Cc' = 64): mega over a 256-step launch
        # (its plain version emulates the tensor cores in float64).
        n = 256
        h0, e0 = G._fused_frontend_zero(params, arch, b)
        carry = ar_mega.mega_zero_carry(arch, h0, e0)
        free = torch.full((n, b), -1, device="cuda", dtype=torch.int32)
        lane = torch.stack([torch.arange(b, device="cuda", dtype=torch.int32),
                            torch.zeros(b, device="cuda", dtype=torch.int32)])
        cond = mel_inputs(arch, g, b, (n,))[1]
        state = {"bufs": torch.zeros((sum(arch.dilations), b, arch.residual_channels),
                                     device="cuda"), "h": h0.clone(), "e": e0.clone()}

        def plain_ms(fn, reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return 1000 * (time.perf_counter() - t0) / reps

        mega = (cuda_ms(lambda: ar_mega.mega_generate_cuda(
            params, lp, arch, carry, 0, free, 1.0, False, lane, 0, cond=cond), 3),
            plain_ms(lambda: ar_mega.mega_generate_plain(
                params, lp, arch, carry, 0, free, 1.0, False, lane, 0, cond=cond), 1),
            mega_cost(arch, b, n, 2, wb, cc))
        turbo = (cuda_ms(lambda: ar_turbo.turbo_generate_cuda(
            params, lp, arch, state, 0, free[:64], 1.0, False, lane, 0, cond=cond[:64]), 3) / 64,
            plain_ms(lambda: ar_turbo.turbo_generate_plain(
                params, lp, arch, state, 0, free[:4], 1.0, False, lane, 0, cond=cond[:4]), 1) / 4,
            turbo_cost(arch, b, 2, wb, cc))
        ring = torch.randn((sum(arch.dilations), b, arch.residual_channels), device="cuda",
                           generator=g)
        hh = torch.randn((b, arch.residual_channels), device="cuda", generator=g)
        stack = (cuda_ms(lambda: ar_step.fused_stack(lp, arch, hh, ring, 700, cond[0]), 50),
                 plain_ms(lambda: ar_step.fused_stack_plain(lp, arch, hh, ring, 700,
                                                            cond_t=cond[0]), 3),
                 stack_cost(arch, b, wb, cc))
        tp = (table["tp_fused_stack S_l=128 cond"],
              plain_ms(lambda: ar_tp.tp_fused_stack_plain(fm_c, arch, h0_t, ring_t, 700,
                                                          cond_t=cond_fm), 3),
              tp_cost(arch, b, s_l, wb, cc))
        frames = torch.randn((1, -(-arch.sample_rate // arch.hop_size), arch.n_mels),
                             device="cuda", generator=g)
        up = cuda_ms(lambda: upsample_cond(params["upsampler"], arch, frames, dt), 5)
    ratios = {k.replace(" cond", ""): table[k] / table[k.replace(" cond", " uncond")]
              for k in table if k.endswith(" cond")}
    log(json.dumps({
        "phase": "mel_timing", "gpu": gpu, "config": "configs/wavenet30_mel.json",
        "Cc": cc, "ms": {k: v for k, v in table.items() if not k.startswith("bound")},
        "bound_ms_uncond_cond": {k[6:]: v for k, v in table.items() if k.startswith("bound")},
        "cond_over_uncond": ratios,
        "units": {"mega": f"ms per {CHUNK}-step launch", "turbo": "ms per step",
                  "fused_stack": "ms per step", "tp_fused_stack": "ms per step"},
        "upsample_cond_ms_per_1s_utterance": up,
        "pool_cond_share_of_wall": {k: v["cond_share_of_wall"]
                                    for k, v in measured["full"].items()},
        "delivered_audio_sec_per_s": {k: v["delivered_audio_sec_per_s"]
                                      for k, v in measured["full"].items()},
    }))
    for name, src, rep, (ms, plain, cost), unit in (
        ("mega_generate_cond", "ar_mega.cu", "ar_mega.py:397", mega,
         f"ms per launch ({n} steps, B={b}, Cc'={cc})"),
        ("turbo_step_cond", "ar_turbo.cu", "ar_turbo.py:202", turbo,
         f"ms per launch (1 step, B={b}, Cc'={cc})"),
        ("fused_stack_cond", "ar_step.cu", "ar_step.py:105", stack,
         f"ms per launch (1 step, B={b}, Cc'={cc})"),
        ("tp_fused_stack_cond", "ar_tp.cu", "ar_tp.py:112", tp,
         f"ms per launch (1 step, B={b}, S_l={s_l}, Cc'={cc})"),
    ):
        bms, by = bound_ms(*cost)
        rows.append({
            "name": name, "route": "cuda", "source": f"lb_wavenet_tpu_torch/csrc/{src}",
            "replaces": f"lb_wavenet_tpu/ops/pallas/{rep}", "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "unit": unit, "launches_per_call": 1,
            "config": "configs/wavenet30_mel.json"})
    return rows


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
    # The post-loss's plain time is its one-fp32-sum composition (the float64
    # emulation of the tensor-core order is no yardstick of speed).
    out["post_loss_fwd"] = (
        cuda_ms(lambda: PL.post_loss_fwd(post, skip, tgt, mask, TRAIN_W, dt), 10),
        cuda_ms(lambda: PL.post_loss_plain(post, skip, tgt, mask, TRAIN_W, dt, False), 3),
        post_loss_cost(arch, TRAIN_B, t, TRAIN_W, wbytes, False))
    out["post_loss_bwd"] = (
        cuda_ms(lambda: PL.post_loss_bwd(post, skip, tgt, mask, TRAIN_W, dt, gbar), 10),
        cuda_ms(lambda: PL.post_loss_bwd_plain(post, skip, tgt, mask, TRAIN_W, dt, gbar,
                                               False), 3),
        post_loss_cost(arch, TRAIN_B, t, TRAIN_W, wbytes, True))
    for k, f in train_counters().items():
        f.launches = counts[k]
    return out


def tp_timings(params, arch):
    """{S_l: (ms, plain ms, (bytes, flops))} of B7 at B=256 on the whole
    skip width and on a 256-wide half (model axis 1 and 2)."""
    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import ar_tp

    dt = compute_dtype(arch)
    g = torch.Generator(device="cuda").manual_seed(6)
    c = arch.residual_channels
    h0 = torch.randn((c, TP_B), device="cuda", generator=g)
    ring = torch.randn((sum(arch.dilations), c, TP_B), device="cuda", generator=g)
    counts = ar_tp.tp_fused_stack.launches
    out = {}
    for s_l, layers in ((arch.skip_channels, params["layers"]),
                        (arch.skip_channels // 2, skip_half(params["layers"], arch, 0))):
        fm = G._tp_weights(params, layers, dt)
        out[s_l] = (cuda_ms(lambda: ar_tp.tp_fused_stack(fm, arch, h0, ring, 700), 50),
                    cuda_ms(lambda: ar_tp.tp_fused_stack_plain(fm, arch, h0, ring, 700), 5),
                    tp_cost(arch, TP_B, s_l, torch.finfo(dt).bits // 8))
    ar_tp.tp_fused_stack.launches = counts
    return out


def tc_smem() -> dict:
    """Dynamic shared memory of the last bf16 mega and turbo launches."""
    from lb_wavenet_tpu_torch.ops.cuda import build

    import ctypes

    out = {}
    for name, src, fn in (("mega_tc_kernel", "ar_mega", "wn_mega_tc_smem"),
                          ("turbo_tc_kernel", "ar_turbo", "wn_turbo_tc_smem")):
        f = getattr(build.load(src), fn)
        f.argtypes, f.restype = [], ctypes.c_int
        out[name] = f()
    return out


def sampling_timings(params, arch, b: int, plain: bool) -> dict:
    """{"mega": (ms per CHUNK-step launch, plain ms or None), "turbo": (ms
    per step, plain ms per step or None)} at batch b, the lane block as the
    pool's (3 rows), from the zero carry."""
    import torch

    from lb_wavenet_tpu_torch.generate import _fused_frontend_zero
    from lb_wavenet_tpu_torch.ops.cuda import ar_mega, ar_turbo

    lp = params["layers"]
    h0, e0 = _fused_frontend_zero(params, arch, b)
    carry = ar_mega.mega_zero_carry(arch, h0, e0)
    free = torch.full((CHUNK, b), -1, device="cuda", dtype=torch.int32)
    inv = torch.full((b,), 1 / 0.7, device="cuda")
    lane = torch.stack([torch.arange(b, device="cuda", dtype=torch.int32),
                        torch.zeros(b, device="cuda", dtype=torch.int32),
                        inv.view(torch.int32)])
    counts = ar_mega.mega_generate.launches, ar_turbo.turbo_step.launches
    mega_ms = cuda_ms(lambda: ar_mega.mega_generate_cuda(
        params, lp, arch, carry, 0, free, 1.0, False, lane, 0), 2)
    mega_plain = None
    if plain:
        t0 = time.perf_counter()
        ar_mega.mega_generate_plain(params, lp, arch, carry, 0, free, 1.0, False, lane, 0)
        torch.cuda.synchronize()
        mega_plain = 1000 * (time.perf_counter() - t0)
    # turbo: ms per step (one launch), from 64-step runs.
    state = {"bufs": torch.zeros((sum(arch.dilations), b, arch.residual_channels),
                                 device="cuda"), "h": h0.clone(), "e": e0.clone()}
    n = 64
    turbo_ms = cuda_ms(lambda: ar_turbo.turbo_generate_cuda(
        params, lp, arch, state, 0, free[:n], 1.0, False, lane, 0), 3) / n
    turbo_plain = None
    if plain:
        t0 = time.perf_counter()
        ar_turbo.turbo_generate_plain(params, lp, arch, state, 0, free[:8], 1.0, False, lane,
                                      0)
        torch.cuda.synchronize()
        turbo_plain = 1000 * (time.perf_counter() - t0) / 8
    ar_mega.mega_generate.launches, ar_turbo.turbo_step.launches = counts
    return {"mega": (mega_ms, mega_plain), "turbo": (turbo_ms, turbo_plain)}


def phase_timing(params, arch, errs, launches, gpu, tp, mel):
    import torch

    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import ar_step

    wbytes = torch.finfo(compute_dtype(arch)).bits // 8
    lp = params["layers"]
    g = torch.Generator(device="cuda").manual_seed(3)
    counts = ar_step.fused_stack.launches
    stack_times = {}
    for bb in (B, GEN_B):
        ring = torch.randn((sum(arch.dilations), bb, arch.residual_channels),
                           device="cuda", generator=g)
        h = torch.randn((bb, arch.residual_channels), device="cuda", generator=g)
        stack_times[bb] = cuda_ms(lambda: ar_step.fused_stack(lp, arch, h, ring, 700), 50)
        if bb == B:
            stack_plain = cuda_ms(lambda: ar_step.fused_stack_plain(lp, arch, h, ring, 700), 5)
    stack_ms = stack_times[B]
    ar_step.fused_stack.launches = counts

    sampling = {bb: sampling_timings(params, arch, bb, plain=bb == B) for bb in (B, GEN_B)}
    (mega_ms, mega_plain), (turbo_ms, turbo_plain) = sampling[B]["mega"], sampling[B]["turbo"]
    log(json.dumps({
        "phase": "sampling_timing", "gpu": gpu, "mega_ms_per_chunk": {
            f"B={bb}": v["mega"][0] for bb, v in sampling.items()},
        "turbo_ms_per_step": {f"B={bb}": v["turbo"][0] for bb, v in sampling.items()},
        "chunk": CHUNK, "lane_rows": 3,
        "bound_ms": {f"B={bb}": {"mega": bound_ms(*mega_cost(arch, bb, CHUNK, 3, wbytes))[0],
                                 "turbo": bound_ms(*turbo_cost(arch, bb, 3, wbytes))[0]}
                     for bb in sampling},
        "dynamic_smem_bytes": tc_smem(),
    }))

    trained = train_timings(params, arch)
    tp_arch, tp_params, tp_measured = tp
    tp_times = tp_timings(tp_params, tp_arch)
    s_whole = tp_arch.skip_channels
    log(json.dumps({
        "phase": "tp_timing", "gpu": gpu, "config": "configs/stress_gen.json", "B": TP_B,
        "tp_fused_stack": {f"S_l={s_l}": {"ms": ms, "plain_ms": plain,
                                          "bound_ms": bound_ms(*cost)[0],
                                          "bound_by": bound_ms(*cost)[1]}
                           for s_l, (ms, plain, cost) in tp_times.items()},
        "one_rank_step_split_ms": tp_measured["split"],
        "delivered_audio_sec_per_s_1rank_vs_single_device": tp_measured["rates"],
        "two_rank_step_ms": {"per_rank": tp_measured["two_rank_step_ms"],
                             "note": "two ranks sharing one card, all-reduce staged through "
                                     "host memory over gloo; not a multi-card figure"},
    }))
    # What one "ms" and one launch count of each row is: rows B3-B5 time a
    # whole autograd call of several launches.
    per_call = train_launches_per_call(arch)
    units = {"mega_generate": f"ms per launch ({CHUNK} steps, B={B})",
             "fused_stack": f"ms per launch (1 step, B={B})",
             "turbo_step": f"ms per launch (1 step, B={B})",
             "tp_fused_stack": f"ms per launch (1 step, B={TP_B}, S_l={tp_arch.skip_channels})",
             **{k: f"ms per call of {n} launches (B={TRAIN_B}, W={TRAIN_W})"
                for k, n in per_call.items()}}
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
        ("tp_fused_stack", "lb_wavenet_tpu_torch/csrc/ar_tp.cu",
         "lb_wavenet_tpu/ops/pallas/ar_tp.py:112", *tp_times[s_whole]),
    ):
        bms, by = bound_ms(*cost)
        row = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "unit": units[name],
            "launches_per_call": per_call.get(name, 1),
        }
        if name.startswith(("frontend", "train_stack", "post_loss")):
            row["kernel_route"] = (front_route(arch) if name.startswith("frontend")
                                   else stack_route(arch) if name.startswith("train_stack")
                                   else post_route(arch))
        if name.startswith("post_loss"):
            row["plain_order"] = "one fp32 sum per product"
        if name in ("mega_generate", "turbo_step", "fused_stack"):   # the gen batch too
            if name == "fused_stack":
                row[f"ms_B{GEN_B}"] = stack_times[GEN_B]
                cost_b = stack_cost(arch, GEN_B, wbytes)
            else:
                row[f"ms_B{GEN_B}"] = sampling[GEN_B][name.split("_")[0]][0]
                cost_b = (mega_cost(arch, GEN_B, CHUNK, 3, wbytes) if name == "mega_generate"
                          else turbo_cost(arch, GEN_B, 3, wbytes))
            row[f"bound_ms_B{GEN_B}"] = bound_ms(*cost_b)[0]
        if name == "fused_stack":
            row["kernel_route"] = step_route(arch, arch.skip_channels)
        if name == "tp_fused_stack":
            row["kernel_route"] = step_route(tp_arch, s_whole)
            row["ms_S_l256"], _, cost_h = tp_times[s_whole // 2]
            row["bound_ms_S_l256"] = bound_ms(*cost_h)[0]
        kernels.append(row)
    kernels += phase_mel_timing(*mel, errs, launches, gpu)
    train_shape = {"B": TRAIN_B, "W": TRAIN_W, "T": arch.receptive_field - 1 + TRAIN_W,
                   "tapcat": True}
    log(json.dumps({"phase": "shapes", "gpu": gpu,
                    "mega_generate": {"B": B, "T": CHUNK, "lane_rows": 3},
                    "fused_stack": {"B": B, "steps": 1, "also": f"B={GEN_B}"},
                    "turbo_step": {"B": B, "steps": 1, "lane_rows": 3, "ms": "per step"},
                    "frontend_fwd": train_shape, "frontend_bwd": train_shape,
                    "train_stack_fwd": train_shape,
                    "train_stack_bwd": train_shape, "post_loss_fwd": train_shape,
                    "post_loss_bwd": train_shape,
                    "tp_fused_stack": {"config": "configs/stress_gen.json", "B": TP_B,
                                       "S_l": s_whole, "steps": 1,
                                       "also": f"S_l={s_whole // 2}"}}))
    log(json.dumps({"kernels": kernels}))


def timed(name, fn, *args):
    """fn(*args), logging the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(json.dumps({"phase_seconds": name, "seconds": round(time.perf_counter() - t0, 2)}))
    return out


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
        timed("environment", phase_environment)
        arch = Config.load(os.path.join(ROOT, "configs", "wavenet30.json")).arch
        params = params_from_jax(numpy_params(arch, 0), device="cuda")
        errs = timed("kernels", phase_kernels, params, arch, gpu)
        errs.update(timed("turbo_kernels", phase_turbo_kernels, params, arch, gpu))
        timed("cuda_core_sampling", phase_cuda_core_sampling, arch, gpu)
        timed("stack_cuda_core", phase_stack_cuda_core, arch, gpu)
        errs.update(timed("train_kernels", phase_train_kernels, params, arch, gpu))
        timed("train_stack_cuda_core", phase_train_stack_cuda_core, arch, gpu)
        timed("post_loss_cuda_core", phase_post_loss_cuda_core, arch, gpu)
        launches = {"mega_generate": timed("serving", phase_serving, params, arch, gpu),
                    "fused_stack": timed("pallas_engine", phase_pallas_engine, params, arch,
                                         gpu),
                    "turbo_step": timed("turbo_serving", phase_turbo_serving, params, arch,
                                        gpu)}
        tp_arch, tp_params = tp_setup()
        errs.update(timed("tp_kernel", phase_tp_kernel, tp_params, tp_arch, gpu))
        launches["tp_fused_stack"], one_rank, tp_measured = timed(
            "tp_serving_1rank", phase_tp_serving_1rank, tp_params, tp_arch, gpu)
        tp_measured["two_rank_step_ms"] = timed("tp_serving_2rank", phase_tp_serving_2rank,
                                                tp_params, tp_arch, one_rank, gpu)
        mel_arch, mel_params = mel_setup()
        spk_arch, spk_params = mel_setup(MEL_SPEAKERS)
        errs.update(timed("mel_kernels", phase_mel_kernels, mel_params, mel_arch, spk_params,
                          gpu))
        mel_launches, mel_measured = timed("mel_serving", phase_mel_serving, mel_params,
                                           mel_arch, spk_params, spk_arch, gpu)
        launches.update(mel_launches)
        train_launches, _ = timed("training", phase_training, arch, gpu)
        launches.update(train_launches)
        timed("timing", phase_timing, params, arch, errs, launches, gpu,
              (tp_arch, tp_params, tp_measured), (mel_params, mel_arch, mel_measured))
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
