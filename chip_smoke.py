#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (`lb_wavenet_tpu_torch`, never JAX) at WaveNet-30 full width
(configs/wavenet30.json: 3x10 dilations, C=G=64, S=Q=256, bf16 compute) with
random weights seeded by numpy, in phases; any failure exits non-zero:

  1. environment: CUDA, the card and its power limit, triton, nvcc; build
     every kernel from lb_wavenet_tpu_torch/csrc with nvcc (sm_90a), one
     nvcc per source, all started together, and the native ingest tier
     with g++, by `python -m lb_wavenet_tpu_torch.cli warm` in a subprocess
     (its seconds per library); then build_all() must find nothing to build
     and a second `cli warm` only cache hits; the ptxas report (registers,
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
     within their tolerances; `mega_vmem`, mega's on-chip ring layout
     (WAVENET_MEGA_VMEM_D, B2v): one-shot mega through generate_classes at
     D = 2, 4, 8 (B=512, 1024 steps: teacher-forced classes and logits and
     a sampled free run bit for bit against D = 1), D = 4 against the plain
     version (128 teacher-forced steps, bit for bit), D = 4 conditioned
     (wavenet30_mel.json, B=64) and on the CUDA-core route (fp32; bf16 at
     C=24), the ValueError at D = 16, ms per launch at each D beside D = 1
     with its weight slots and shared memory;
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
     `export_serving`: a per-lane mega artifact (B=512, chunk 1024, by
     `cli export`) and a turbo one (B=100), loaded by a fresh `python -c`
     process that serves phases 3's and 5's requests through
     SessionPool(artifact=...) with the same audio bit for bit, imports
     no model code, launches the kernels (its own counters), keeps the ring
     in place, and times a chunk beside the in-process one; a model-sharded
     turbo artifact of the stress config (B=256) on one NCCL rank against
     ShardedSession with a lane reset; `http_serving`: `cli serve --listen`
     on a mega pool of 64, from the checkpoint and from a per-lane artifact,
     8 concurrent POSTs (seeds, temperatures {0, 0.7, 1.0}) each equal to a
     dedicated session, /healthz with the server's kernel launches, the
     request latencies (p50, p95);
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
     `pack_training`, after it: an hour of synthetic 16 kHz audio (60
     one-minute wavs from a numpy seed, 57.6 M samples) packed by `cli
     pack` (58 MB of uint8 classes); 50 batches of the recipe from the pack
     (pread), from the wavs through the native tier and through the Python
     path (WAVENET_NATIVE_LOADER=0), equal bit for bit, with each one's ms
     per batch and the pack path's RSS growth against the in-RAM corpus's
     bytes; `cli train --profile` from the pack for 5 steps with EMA,
     TensorBoard and a checkpoint: the losses of `cli train` from the wavs
     bit for bit, and the Chrome trace's B3/B4/B5 kernels as many as their
     launch counters; `cli pack` of a mel arch (with waves) and 3 steps of
     configs/wavenet30_mel.json's recipe from it, its mel frames equal to
     the wavs', the conditioned B3 pair every step; `cli generate --prime
     <1500 samples> --ema` on mega (B=64) and turbo, 4096 samples, each
     lane's primed span kept and the audio equal to in-process
     generate_classes(forced=...) on the EMA params; `cli serve --ema` with
     4 requests against a pool on the EMA params; `cli info`'s bounds equal
     to utils/profiling.py's and to PERF.md's rows 5-10 plus Adam's bytes;
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
     the CUDA-core route with cond against plain versions in its
     in-order FMA order (fp32 within FP32_ATOL; bf16 at C=24: one stack
     step and mega and turbo over 128 teacher-forced steps within
     LOGIT_ATOL, and free runs under the near-argmax check); the
     conditioned mega's logits against the plain forward over 48 steps,
     within twice the spread of two plain orders; `mel_serving`, with the four counts set to 0 before it and
     read after: log-mel of 8 synthetic waveforms on the card, upsampled
     once per request, served through a mega pool of batch 64 (chunk
     1024, recycled lanes, a replay bit for bit), full pools of 64 and 512
     (delivered audio-sec/s, the cond slab's share), a turbo pool, a
     speaker pool (Cc'=80), the pallas engine, a chunked run against the
     one-shot run, `cli generate --mel --stream-chunk` from a checkpoint
     against the in-process audio, and one NCCL rank of model-sharded
     conditioned serving;
 11. conditioned training (configs/wavenet30_mel.json's training half):
     `cond_train_kernels`, the conditioned training-stack pair (B3's
     has_cond) at the recipe's shape (B=8, W=6144), bit for bit against
     its plain versions on the tensor cores at Cc'=64 and 80 (tapcat on)
     in skip, z, x, dh0, d cond and every weight gradient, a rerun
     of the backward bit-identical, and the CUDA-core route (fp32, bf16 at
     C=24); `mel_training`, with the counts set to 0 before each run and
     read after: run_training of the recipe as written on synthetic chords
     (20 steps; the loss, median step ms, samples/s, the loader's ms per
     batch, the conditioned stack kernels every step), the step split
     (batch copy, upsampler, forward, backward, Adam + EMA, idle share),
     the speaker override (Cc'=80, 6 steps) with its split, the training
     upsampler against a float64 product with TF32 switched on around it,
     and held-out evaluation, fused and plain;
 12. training across ranks: `mask_kernels`, the masked kernel pairs (the
     TPU kernels' has_mask / input_mask: the sequence-parallel halo mask)
     at one shard of the mel recipe (B=8, T_ext = 3070 halo + 4607, Cc'=64,
     tapcat on): the frontend pair on both routes (h0 bit for bit on the
     tensor cores, gradients within KERNEL_RTOL), the stack pair bit for
     bit on the tensor cores in skip, z, x, dh0, d cond and every gradient,
     its CUDA-core route (fp32, bf16 at C=24) within tolerance, masked rows
     0, an all-ones mask bit for bit the unmasked kernels, and the masked
     pairs' times against the unmasked ones; `parallel_training`, two gloo
     ranks sharing the card, spawned once: config 5 (configs/
     multihost_mel.json) data-parallel, the mel recipe sequence-parallel
     (the masked kernels every step, no plain stack or frontend op) and the
     stress config skip-split over 2 model ranks, each step against the
     one-rank step within STEP_RTOL, the divergence guard, a model-sharded
     checkpoint and resume, then `torchrun --nproc-per-node 2 -m
     lb_wavenet_tpu_torch.cli train --set train.seq_parallel=true` and
     `cli eval` from its checkpoint;
 12b. `mol`: Tacotron 2's WaveNet vocoder
     (lb_wavenet_tpu_torch/configs/tacotron2_mol.json at full width: 24 kHz,
     hop 300 as 15 x 20, a 10-component mixture of logistics): the MoL head
     pair against its plain versions at the training shape (B=8, W=7200;
     bf16 on tensor cores, fp32 on CUDA cores), its ms a call beside the
     plain versions' and its bound; one training step through train_step
     (the fused stack, then the pair: 2 + 2 launches); 1 s of xla-engine
     generation (one lane, 24,000 steps) with the head outputs of its last
     steps held to the teacher-forced forward; the pair's rows of the
     `kernels` line;
 13. timings at the serving and training shapes (mega and turbo at B=512
     and at wavenet30.json's gen batch 64), the conditioned kernels against
     the unconditioned ones (`mel_timing`) and the `kernels` JSON line,
     each row with its unit (rows B3-B5 time a whole call of several
     launches; the `*_cond` rows at the mel config's B=64, the
     `(has_cond)` rows at its training shape, the `(has_mask)` and
     `(input_mask)` rows at a sequence-parallel shard with the launches of
     parallel_training's sequence-parallel steps), the card's name and
     power limit, and last the {"ok": true, ...} line.

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
# Steps of the conditioned CUDA-core route's fp32 runs at the mel widths and
# of its C=24 free runs: their plain versions' in-order FMA chains take one
# launch per k-step (ar_tc.fma_product), so these are cut in depth.
CUDA_CORE_FP32_T, CUDA_CORE_FREE_T = 32, 64
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
MEL_FWD_T = 48      # steps of the mega-vs-forward check (held against two plain orders' spread)
MEL_TRAIN_STEPS = 20  # steps of configs/wavenet30_mel.json's recipe in mel_training
MEL_SPK_STEPS = 6     # steps of the speaker override (Cc' = 80) in mel_training
MEL_TRAIN_B, MEL_TRAIN_W = 8, 6144   # wavenet30_mel.json train batch and window
MEL_EVAL_BATCHES = 2  # held-out batches of the mel evaluation
# The training upsampler (fp32 products) against float64 at the recipe
# shape: values within 1e-5 of the largest (a TF32 product reads ~1e-3);
# each weight's gradient within a tenth of the error of the same function
# taken through TF32 products in the same call (the bias gradients, plain
# sums over up to 73k rows, are reported).
UPSAMPLE_RTOL, UPSAMPLE_TF32_SHARE = 1e-5, 0.1
MEL_TP_STEPS = 128  # steps of the conditioned model-sharded run
# Training across ranks: two gloo ranks sharing the card (NCCL refuses two
# ranks on one device). BASELINE config 5 (data-parallel), the mel recipe
# time-sharded over SP_N ranks, the stress config's skip split over 2.
DP_CONFIG = os.path.join(ROOT, "configs", "multihost_mel.json")
SP_N = 2
PAR_STEPS = 3       # steps of each layout

sys.path.insert(0, ROOT)
try:   # the bounds' yardstick; main() reports a missing port
    from lb_wavenet_tpu_torch.utils.profiling import (  # noqa: F401
        bound_ms, frontend_cost, mega_cost, post_loss_cost, stack_cost, tp_cost,
        train_stack_cost, turbo_cost)
except ImportError:
    pass
KERNEL_SOURCES = ("ar_step", "ar_mega", "ar_turbo", "frontend", "train_stack", "post_loss",
                  "ar_tp", "post_mol")


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


def kernel_split_ms(fn, calls: int = 3) -> dict:
    """{kernel: device ms per call} of fn's kernels under torch.profiler
    (after a warm-up call), named without template or argument lists: the
    training stack's backward split into its layer pass, weight-gradient
    pass and the rest (kernels-line rows 6, 6c, 6m)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = e.name.split("(")[0].split("<")[0].replace("void ", "").strip()
            ms[k] = ms.get(k, 0.0) + e.time_range.elapsed_us() / 1000.0 / calls
    return {k: round(v, 4) for k, v in sorted(ms.items(), key=lambda kv: -kv[1])}


def wgrad_ptxas() -> dict:
    """tc_ptxas's report of the tensor-core weight-gradient pass
    (bwd_wgrad_tc)."""
    return {k: v for k, v in tc_ptxas().items() if "bwd_wgrad_tc" in k}


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
    # `cli warm` builds every library (nvcc, one process per source, all at
    # once; the native tier with g++) before any phase loads one.
    t0 = time.perf_counter()
    first = cli_warm()
    seconds = time.perf_counter() - t0
    built = {w["target"]: w["s"] for w in first["warmed"]}
    require(set(built) == {f"nvcc:{n}" for n in KERNEL_SOURCES} | {"native:loader"},
            f"cli warm built {sorted(built)}, expected every kernel source and the native tier")
    build.build_all()
    require(not build.build_seconds, f"libraries built after cli warm: {build.build_seconds}")
    second = cli_warm()
    require(all(w["cached"] for w in second["warmed"]),
            f"a second cli warm rebuilt: {second['warmed']}")
    for name in KERNEL_SOURCES:
        build.load(name)
    res = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
           for k, v in build.build_log.items()}
    log(json.dumps({"phase": "build", "seconds": round(seconds, 2), "cli_warm_s": built,
                    "cached_before": [w["target"] for w in first["warmed"] if w["cached"]],
                    "second_warm_all_cached": True, "ptxas": res}))
    # The train stack's route rests on tc_smem: the library must carve the
    # same bytes (WaveNet-30's widths, the stress config's, S = 1024).
    lib = build.load("train_stack")
    smem = {f"C{c}_G{g}_S{s}_Cc{cc}": (TS.tc_smem(c, g, s, cc), TS.lib_tc_smem(lib, c, g, s, cc))
            for c, g, s, cc in ((64, 64, 256, 0), (64, 64, 512, 0), (64, 64, 1024, 0),
                                (64, 64, 256, 64), (64, 64, 256, 80))}
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
    wg = wgrad_ptxas()
    require(wg and all(any("0 bytes spill stores, 0 bytes spill loads" in ln for ln in v)
                       for v in wg.values()),
            f"the weight-gradient pass spills or was not built: {wg}")
    require(all(a == b for a, b in psmem.values()),
            f"csrc/post_loss.cu and post_loss.tc_smem disagree: {psmem}")
    require(all(a == b for a, b in ssmem.values()),
            f"csrc/ar_step.cu or csrc/ar_tp.cu and ar_tc.stack_smem disagree: {ssmem}")


def cli_warm() -> dict:
    """`python -m lb_wavenet_tpu_torch.cli warm` in a subprocess: its last
    JSON line ({"warmed": [...], "cache_dir": ..., "backend": ...})."""
    proc = subprocess.run(
        [sys.executable, "-m", "lb_wavenet_tpu_torch.cli", "warm",
         "--config", os.path.join(ROOT, "configs", "wavenet30.json")],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    require(proc.returncode == 0, f"cli warm failed:\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    require(out["backend"] == "cuda", f"cli warm: {out}")
    return out


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
    versions in the kernels' order (in-order FMA chains, ar_tc.fma_product),
    teacher-forced over CUDA_CORE_T steps at B = GEN_B (comparison launches:
    the counters are restored)."""
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
    SERVED["mega"] = (requests, out)
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
    SERVED["turbo"] = (requests, out)
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
    backward takes 3 L + 3 on the tensor-core route (a g_skip pass, its
    db_skip sum, three passes per layer, one reduction) and 3 L + 1 on the
    CUDA-core one; the post-loss takes 2 and 3 on either route (the row
    pass and the partials' sum; the row pass, the weight-gradient pass and
    the reduction). Conditioning adds no launch to the train stack: its
    layer passes (tensor cores) or dx launches (CUDA cores) add to d cond,
    an fp32 (B, T, Cc') buffer zeroed by a memset per backward call."""
    L = len(arch.dilations)
    bwd = 3 * L + 3 if stack_route(arch) == "tensor_cores" else 3 * L + 1
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
def no_plain_frontend(stack: bool = False):
    """Fail if the training step runs the frontend as plain PyTorch: the
    unfused input_frontend or the kernel pair's plain versions; with
    `stack`, also the training stack's plain versions."""
    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    real = PT.input_frontend

    def fused_only(params, arch, x, dt, fused_frontend=False, **kw):
        require(fused_frontend, "the training step ran the unfused frontend")
        return real(params, arch, x, dt, fused_frontend, **kw)

    def refuse(*_, **__):
        raise SmokeFailure("the training step ran a kernel pair's plain version")

    swaps = [(F, "frontend_fwd_plain"), (F, "frontend_bwd_plain")] + (
        [(TS, "stack_fwd_plain"), (TS, "stack_bwd_plain")] if stack else [])
    saved = [getattr(m, n) for m, n in swaps]
    PT.input_frontend = fused_only
    for m, n in swaps:
        setattr(m, n, refuse)
    try:
        yield
    finally:
        PT.input_frontend = real
        for (m, n), f in zip(swaps, saved):
            setattr(m, n, f)


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

PACK_SEED = 23
PACK_FILES, PACK_FILE_SAMPLES = 60, 60 * 16000   # one hour of 16 kHz mono PCM16
PACK_BATCHES = 50       # batches compared across the pack, native and Python loaders
PACK_STEPS = 5          # cli train steps from the pack (traced) and from the wavs
PACK_MEL_STEPS = 3      # steps of the mel recipe from a with-waves pack
PRIME_SAMPLES, PRIME_GEN = 1500, 4096   # --prime length, samples generated
PACK_REQUESTS = 4       # cli serve --ema requests
# PERF.md's bound column, rows 5-10 (ms a call at B=8, W=10240): the train
# step's kernels, which `cli info` must sum to (plus Adam's bytes).
PERF_ROWS_5_10 = (0.238, 0.582, 0.0253, 0.0651, 0.0083, 0.0083)


def rss_kb() -> int:
    """This process's resident set (VmRSS of /proc/self/status), KB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise SmokeFailure("no VmRSS in /proc/self/status")


def source_kernels(name: str) -> set:
    """Qualified names (wn::...::name) of the __global__ functions defined
    in lb_wavenet_tpu_torch/csrc/<name> (a .cu or .cuh file), by a scan of
    its namespaces."""
    import re

    with open(os.path.join(ROOT, "lb_wavenet_tpu_torch", "csrc", name)) as f:
        text = re.sub(r"//[^\n]*|/\*.*?\*/", "", f.read(), flags=re.S)
    pat = re.compile(r"namespace\s+(\w+)\s*\{|__global__\s+void\s+"
                     r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(|[{}]")
    stack, depth, names = [], 0, set()
    for m in pat.finditer(text):
        if m.group(1):
            depth += 1
            stack.append((m.group(1), depth))
        elif m.group(2):
            names.add("::".join([n for n, _ in stack] + [m.group(2)]))
        elif m.group(0) == "{":
            depth += 1
        else:
            if stack and stack[-1][1] == depth:
                stack.pop()
            depth -= 1
    return names


def trace_kernel_counts(trace_dir: str, stems) -> tuple:
    """({source: kernel events}, {source: kernel names}) of the Chrome
    trace that `--profile` wrote into trace_dir. A kernel defined in a
    source's .cu counts for that source; one defined in a header that
    several sources include (tile.cuh's weight-gradient reduction) counts
    under "shared", as the trace alone cannot tell which source launched
    it."""
    import re

    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    require(len(files) == 1, f"--profile wrote {files} into {trace_dir}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    csrc = os.path.join(ROOT, "lb_wavenet_tpu_torch", "csrc")
    headers = set()
    for s in stems:
        with open(os.path.join(csrc, f"{s}.cu")) as f:
            headers |= set(re.findall(r'#include "(\w+\.cuh)"', f.read()))
    groups = {s: source_kernels(f"{s}.cu") for s in stems}
    groups["shared"] = set().union(*(source_kernels(h) for h in sorted(headers)))
    pats = {g: re.compile("|".join(r"(?<![\w:])" + re.escape(q) + r"[<(]" for q in sorted(qs)))
            for g, qs in groups.items()}
    counts, names = dict.fromkeys(groups, 0), {g: set() for g in groups}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for g, pat in pats.items():
            if pat.search(e.get("name", "")):
                counts[g] += 1
                names[g].add(e["name"].split("(")[0][-60:])
                break
    return counts, {g: sorted(v) for g, v in names.items()}


def trace_launch_ranges(trace_dir: str) -> tuple:
    """({innermost CPU range around its launch: kernels} of every kernel of
    the port's csrc sources in the Chrome trace that `--profile` wrote into
    trace_dir, {name: count} of the program's train.* and data.* ranges).
    A kernel's launch is the runtime call that shares its correlation id;
    the range is the latest-starting CPU range of that thread around it."""
    import bisect
    import re

    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    require(len(files) == 1, f"--profile wrote {files} into {trace_dir}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    csrc = os.path.join(ROOT, "lb_wavenet_tpu_torch", "csrc")
    ours = set().union(*(source_kernels(n) for n in sorted(os.listdir(csrc))
                         if n.endswith((".cu", ".cuh"))))
    pat = re.compile("|".join(r"(?<![\w:])" + re.escape(q) + r"[<(]" for q in sorted(ours)))
    runtime, ranges, phases = {}, {}, {}
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            runtime[args["correlation"]] = e
        elif cat in ("cpu_op", "user_annotation") and e.get("ph") == "X":
            ranges.setdefault((e["pid"], e["tid"]), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]))
            if e["name"].startswith(("train.", "data.")):
                phases[e["name"]] = phases.get(e["name"], 0) + 1
    for v in ranges.values():
        v.sort()
    starts = {k: [r[0] for r in v] for k, v in ranges.items()}
    launched: dict = {}
    for e in events:
        if e.get("cat") != "kernel" or not pat.search(e.get("name", "")):
            continue
        call = runtime.get((e.get("args") or {}).get("correlation"))
        name = "no runtime call"
        if call is not None:
            key, ts = (call["pid"], call["tid"]), float(call["ts"])
            v = ranges.get(key, [])
            i = bisect.bisect_right(starts.get(key, []), ts)
            name = "no range"
            while i > 0:
                i -= 1
                if v[i][1] >= ts:
                    name = v[i][2]
                    break
        launched[name] = launched.get(name, 0) + 1
    return launched, phases


def cli_main(argv) -> list:
    """`lb_wavenet_tpu_torch.cli.main(argv)` in this process: the JSON lines
    it printed, and its stderr."""
    import io

    from lb_wavenet_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    require(rc == 0, f"cli {argv[0]} returned {rc}:\n{err.getvalue()[-4000:]}")
    return [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")], \
        err.getvalue()


def batch_digests(corpus, train) -> tuple:
    """(sha256 of each of PACK_BATCHES batches, ms per batch of make_batches
    alone, after one warm-up window); the batches are dropped as they come,
    so RSS sees one."""
    import hashlib

    from lb_wavenet_tpu_torch.data import make_batches

    corpus.examples_batch([corpus.index[0]])   # one-time set-up (the native concat)
    it = make_batches(corpus, train)
    digests, spent = [], 0.0
    for _ in range(PACK_BATCHES):
        t0 = time.perf_counter()
        b = next(it)
        spent += time.perf_counter() - t0
        h = hashlib.sha256()
        for a in (b.inputs, b.targets, b.mask):
            h.update(a.tobytes())
        digests.append(h.hexdigest())
    return digests, 1000.0 * spent / PACK_BATCHES


def int16_audio(classes, arch):
    """The int16 samples write_wav stores for these classes."""
    import numpy as np

    from lb_wavenet_tpu_torch.ops.mulaw import mu_law_decode

    wav = mu_law_decode(classes, arch.quant_channels).cpu().numpy()
    return (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)


def phase_pack_training(arch, gpu):
    """The out-of-core corpus and the rest of the CLI at WaveNet-30 full
    width: an hour of synthetic audio packed by `cli pack`; batches from the
    pack, from the wavs through the native tier and through the Python path
    equal bit for bit; `cli train --profile` from the pack (EMA, TensorBoard,
    checkpoint) with the same losses as from the wavs and the B3/B4/B5
    kernels in its trace as often as their counters say, each launched
    inside its ctypes call's `kernel.<fn>` range, and the program's
    `train.*` ranges every step; the mel recipe
    from a with-waves pack; `cli generate --prime --ema` on mega and turbo
    against in-process generation; `cli serve --ema` against a pool on the
    EMA params; `cli info`'s bounds."""
    import importlib.util

    import numpy as np
    import torch
    from scipy.io import wavfile

    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.data import Corpus, load_wav, make_batches, write_wav
    from lb_wavenet_tpu_torch.generate import generate_classes
    from lb_wavenet_tpu_torch.ops.cuda.build import BUILD
    from lb_wavenet_tpu_torch.ops.mulaw import mu_law_encode
    from lb_wavenet_tpu_torch.utils import profiling
    from lb_wavenet_tpu_torch.utils.checkpoint import restore_params

    work = os.path.join(BUILD, "chip_smoke_pack")   # gitignored, removed below
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    conf = os.path.join(ROOT, "configs", "wavenet30.json")
    cfg = Config.load(conf)
    counters = train_counters()
    try:
        # An hour of synthetic chords and noise, 60 one-minute files.
        t0 = time.perf_counter()
        wavs = os.path.join(work, "wavs")
        os.makedirs(wavs)
        rng = np.random.default_rng(PACK_SEED)
        t = np.arange(PACK_FILE_SAMPLES) / arch.sample_rate
        for i in range(PACK_FILES):
            w = 0.02 * rng.standard_normal(PACK_FILE_SAMPLES)
            for f0, a in zip(rng.uniform(80, 400, 3), rng.uniform(0.05, 0.25, 3)):
                w += a * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
            write_wav(os.path.join(wavs, f"{i:02d}.wav"), w, arch.sample_rate)
        write_s = time.perf_counter() - t0
        pack = os.path.join(work, "corpus.pack")
        t0 = time.perf_counter()
        (summary,), _ = cli_main(["pack", "--config", conf, "--data-dir", wavs, "--out", pack])
        pack_s = time.perf_counter() - t0
        require(summary["n_samples"] == PACK_FILES * PACK_FILE_SAMPLES
                and summary["enc_dtype"] == "uint8" and not summary["with_waves"],
                f"cli pack: {summary}")

        # Batches: the pack (pread), the wavs through the native tier and
        # through the Python path, equal bit for bit; the pack's RSS growth.
        train = cfg.train
        rss0 = rss_kb()
        pc = Corpus.from_pack(pack, arch, TRAIN_W)
        d_pack, ms_pack = batch_digests(pc, train)
        rss_growth = rss_kb() - rss0
        dc = Corpus.from_dir(wavs, arch, TRAIN_W)
        d_native, ms_native = batch_digests(dc, train)
        ram_bytes = (sum(w.nbytes for w in dc.waves) + sum(e.nbytes for e in dc.encoded)
                     + dc._packed[0].nbytes)
        old = os.environ.get("WAVENET_NATIVE_LOADER")
        os.environ["WAVENET_NATIVE_LOADER"] = "0"
        try:
            t0 = time.perf_counter()
            yc = Corpus.from_dir(wavs, arch, TRAIN_W)
            ingest_python_s = time.perf_counter() - t0
            d_python, ms_python = batch_digests(yc, train)
        finally:
            if old is None:
                del os.environ["WAVENET_NATIVE_LOADER"]
            else:
                os.environ["WAVENET_NATIVE_LOADER"] = old
        del dc, yc
        loader = {"phase": "pack_loader", "gpu": gpu, "files": PACK_FILES,
                  "samples": PACK_FILES * PACK_FILE_SAMPLES, "pack_bytes": summary["bytes"],
                  "write_wavs_s": write_s, "cli_pack_s": pack_s,
                  "ingest_python_s": ingest_python_s, "batches": PACK_BATCHES,
                  "B": TRAIN_B, "W": TRAIN_W,
                  "ms_per_batch": {"pack_pread": ms_pack, "native_in_ram": ms_native,
                                   "python_in_ram": ms_python},
                  "pack_rss_growth_kb": rss_growth, "in_ram_corpus_bytes": ram_bytes,
                  "equal": {"pack_vs_native": d_pack == d_native,
                            "pack_vs_python": d_pack == d_python}}
        log(json.dumps(loader))
        require(d_pack == d_native == d_python,
                "batches from the pack, the native tier and the Python path differ")
        require(rss_growth * 1024 < ram_bytes // 20,
                f"the pack path's RSS grew {rss_growth} KB against an in-RAM corpus of "
                f"{ram_bytes} bytes")

        # cli train --profile from the pack, with EMA, TensorBoard and a
        # checkpoint; then from the wavs: the same losses.
        common = ["--config", conf, "--set", f"train.n_steps={PACK_STEPS}",
                  "--set", "train.log_every=1", "--set", "train.ema_decay=0.999",
                  "--set", f"train.checkpoint_every={PACK_STEPS}"]
        ckpt, prof, tb = (os.path.join(work, n) for n in ("ckpt", "profile", "tb"))
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        recs, err = cli_main(["train", *common, "--profile", prof,
                              "--set", f"train.data_dir={pack}",
                              "--set", f"train.checkpoint_dir={ckpt}",
                              "--set", f"train.tensorboard_dir={tb}"])
        traced_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        losses_pack = [r["loss"] for r in recs if "loss" in r]
        recs, _ = cli_main(["train", *common, "--set", f"train.data_dir={wavs}",
                            "--set", f"train.checkpoint_dir={os.path.join(work, 'ckpt_dir')}"])
        losses_dir = [r["loss"] for r in recs if "loss" in r]
        per_step = train_launches_per_call(arch)
        stems = ("train_stack", "post_loss", "frontend")
        traced, names = trace_kernel_counts(prof, stems)
        launch_ranges, phase_ranges = trace_launch_ranges(prof)
        want = {s: (per_step[f"{s}_fwd"] + per_step[f"{s}_bwd"]) * PACK_STEPS for s in stems}
        counted = {s: launches[f"{s}_fwd"] + launches[f"{s}_bwd"] for s in stems}
        # Every counted launch is in the trace: each source's own kernels at
        # most its count, the shared header kernels making up the rest.
        trace_ok = (counted == want and sum(traced.values()) == sum(counted.values())
                    and all(0 < traced[s] <= counted[s] for s in stems))
        has_tb = importlib.util.find_spec("tensorboard") is not None
        tb_tags = []
        if has_tb:
            from tensorboard.backend.event_processing.event_accumulator import (
                EventAccumulator)

            acc = EventAccumulator(tb)
            acc.Reload()
            tb_tags = acc.Tags()["scalars"]
        spread = max(abs(a - b) for a, b in zip(losses_pack, losses_dir)) \
            if len(losses_pack) == len(losses_dir) else None
        log(json.dumps({"phase": "pack_train", "gpu": gpu, "steps": PACK_STEPS,
                        "losses_pack": losses_pack, "losses_dir": losses_dir,
                        "loss_spread": spread, "traced_run_s": traced_s,
                        "trace_kernels": traced, "counters": counted, "expected": want,
                        "trace_kernel_names": names, "launch_ranges": launch_ranges,
                        "program_ranges": phase_ranges, "tensorboard_installed": has_tb,
                        "tensorboard_active": has_tb and "disabled" not in err,
                        "tensorboard_scalars": tb_tags}))
        require(len(losses_pack) == PACK_STEPS and losses_pack == losses_dir,
                f"losses from the pack {losses_pack} != from the wavs {losses_dir}")
        require(trace_ok, f"trace {traced}, counters {counted}, expected {want} kernel launches")
        # Each kernel's launching CPU range is its ctypes call's span.
        require(all(n.startswith("kernel.") for n in launch_ranges)
                and sum(launch_ranges.values()) == sum(counted.values()),
                f"launch ranges {launch_ranges} against {sum(counted.values())} launches")
        require(all(phase_ranges.get(n, 0) >= PACK_STEPS for n in (
            "train.step", "train.to_device", "train.forward", "train.backward",
            "train.optimizer", "data.wait")), f"the trace's program ranges: {phase_ranges}")
        require(not has_tb or "loss" in tb_tags, f"TensorBoard scalars: {tb_tags}")
        require(has_tb or "tensorboard writer disabled" in err,
                "no tensorboard package and no notice of it")

        # The mel recipe from a with-waves pack: mel frames equal the
        # directory's, the conditioned B3 pair every step.
        mcfg = Config.load(MEL_CONFIG)
        mel_pack = os.path.join(work, "mel.pack")
        (msum,), _ = cli_main(["pack", "--config", MEL_CONFIG, "--data-dir", wavs,
                               "--out", mel_pack])
        require(msum["with_waves"], f"cli pack of a mel arch: {msum}")
        mpc = Corpus.from_pack(mel_pack, mcfg.arch, MEL_TRAIN_W)
        mdc = Corpus.from_dir(wavs, mcfg.arch, MEL_TRAIN_W)
        first_mel_batches = []
        it_p = make_batches(mpc, mcfg.train, with_mel=True)
        it_d = make_batches(mdc, mcfg.train, with_mel=True)
        for _ in range(PACK_MEL_STEPS):
            a, b = next(it_p), next(it_d)
            first_mel_batches.append(bool(np.array_equal(a.mel, b.mel)
                                          and np.array_equal(a.inputs, b.inputs)))
        del mdc
        for f in counters.values():
            f.launches = 0
        recs, _ = cli_main(["train", "--config", MEL_CONFIG,
                            "--set", f"train.n_steps={PACK_MEL_STEPS}",
                            "--set", "train.log_every=1", "--set", f"train.data_dir={mel_pack}",
                            "--set", f"train.checkpoint_dir={os.path.join(work, 'ckpt_mel')}"])
        mel_launches = {k: f.launches for k, f in counters.items()}
        mel_losses = [r["loss"] for r in recs if "loss" in r]
        mel_per = train_launches_per_call(mcfg.arch)
        log(json.dumps({"phase": "pack_mel_train", "gpu": gpu, "pack_bytes": msum["bytes"],
                        "mel_batches_equal": first_mel_batches, "losses": mel_losses,
                        "launches": mel_launches, "launches_per_step": mel_per}))
        require(all(first_mel_batches), "mel frames from the pack differ from the wavs'")
        require(len(mel_losses) == PACK_MEL_STEPS and all(np.isfinite(mel_losses)),
                f"mel training from the pack: {mel_losses}")
        for k in ("train_stack_fwd", "train_stack_bwd"):
            require(mel_launches[k] == mel_per[k] * PACK_MEL_STEPS,
                    f"{k}: {mel_launches[k]} launches in {PACK_MEL_STEPS} mel steps")

        # generate --prime --ema on mega and turbo against in-process
        # generation on the EMA params.
        prime = os.path.join(work, "prime.wav")
        write_wav(prime, 0.3 * np.sin(2 * np.pi * 220.0 * np.arange(PRIME_SAMPLES)
                                      / arch.sample_rate), arch.sample_rate)
        prime_cls = mu_law_encode(torch.from_numpy(load_wav(prime)[0]),
                                  arch.quant_channels).numpy()
        ema = restore_params(ckpt, prefer_ema=True)
        forced = np.full((GEN_B, PRIME_GEN), -1, np.int32)
        forced[:, :PRIME_SAMPLES] = prime_cls
        kc = kernel_counters()
        primed = {}
        for engine, counter in (("mega", "mega_generate"), ("turbo", "turbo_step")):
            out_dir = os.path.join(work, f"gen_{engine}")
            kc[counter].launches = 0
            cli_main(["generate", "--config", conf, "--prime", prime, "--ema",
                      "--set", f"gen.checkpoint_dir={ckpt}", "--set", f"gen.engine={engine}",
                      "--set", f"gen.batch_size={GEN_B}", "--set", f"gen.n_samples={PRIME_GEN}",
                      "--set", f"gen.out_dir={out_dir}"])
            n_launch = kc[counter].launches
            with comparison_launches():
                classes = generate_classes(ema, arch, cfg.gen.seed, GEN_B, PRIME_GEN,
                                           forced=torch.from_numpy(forced),
                                           temperature=cfg.gen.temperature, engine=engine,
                                           device="cuda")
            cls = classes.cpu().numpy()
            want_audio = int16_audio(classes, arch)
            got = np.stack([wavfile.read(os.path.join(out_dir, f"gen_{i:04d}.wav"))[1]
                            for i in range(GEN_B)])
            primed[engine] = {"launches": n_launch,
                              "prime_kept": bool((cls[:, :PRIME_SAMPLES] == prime_cls).all()),
                              "cli_equals_in_process": bool(np.array_equal(got, want_audio)),
                              "lanes_distinct_after_prime": int(len(
                                  {row.tobytes() for row in cls[:, PRIME_SAMPLES:]}))}
        log(json.dumps({"phase": "pack_prime_ema", "gpu": gpu, "B": GEN_B,
                        "n_samples": PRIME_GEN, "prime": PRIME_SAMPLES, **primed}))
        for engine, r in primed.items():
            require(r["launches"] > 0 and r["prime_kept"] and r["cli_equals_in_process"],
                    f"generate --prime --ema ({engine}): {r}")

        # serve --ema against a pool on the EMA params.
        requests = [{"id": f"e{i}", "n_samples": 3000 + 700 * i, "seed": 50 + i,
                     "temperature": (0.0, 1.0)[i % 2]} for i in range(PACK_REQUESTS)]
        req = os.path.join(work, "requests.jsonl")
        with open(req, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in requests)
        served_dir = os.path.join(work, "served")
        cli_main(["serve", "--config", conf, "--ema", "--requests", req,
                  "--stream-chunk", str(CHUNK), "--set", f"gen.checkpoint_dir={ckpt}",
                  "--set", f"gen.out_dir={served_dir}", "--set", f"gen.batch_size={GEN_B}"])
        with comparison_launches():
            pool_out, _, _, _ = serve_pool(ema, arch, requests, GEN_B, first_wave=PACK_REQUESTS)
        serve_equal = {r["id"]: bool(np.array_equal(
            wavfile.read(os.path.join(served_dir, f"{r['id']}.wav"))[1],
            int16_audio(torch.from_numpy(pool_out[r["id"]]), arch))) for r in requests}

        # cli info: the bounds of utils.profiling and of PERF.md's rows.
        (info,), _ = cli_main(["info", "--config", conf])
        n_param = profiling.n_params(arch)
        want_train = profiling.train_step_speed_of_light(arch, TRAIN_B, TRAIN_W, n_param=n_param)
        want_ar = profiling.ar_step_speed_of_light(arch, cfg.gen.batch_size)
        perf_sum = sum(PERF_ROWS_5_10) + want_train["optimizer_ms"]
        log(json.dumps({"phase": "pack_serve_ema_and_info", "gpu": gpu,
                        "serve_equal": serve_equal, "info_gpu": info.get("gpu"),
                        "n_params": info["n_params"],
                        "train_sol_step_ms": info["train_speed_of_light"]["sol_step_ms"],
                        "perf_rows_5_10_plus_adam_ms": perf_sum,
                        "ar_sol_step_us": info["ar_speed_of_light"]["sol_step_us"]}))
        require(all(serve_equal.values()), f"serve --ema differs from the EMA pool: {serve_equal}")
        require(info["train_speed_of_light"] == want_train and info["ar_speed_of_light"] == want_ar
                and info["n_params"] == n_param, "cli info's bounds differ from utils.profiling's")
        require(abs(want_train["sol_step_ms"] - perf_sum) < 1e-3,
                f"train bound {want_train['sol_step_ms']} ms != PERF.md rows 5-10 + Adam "
                f"{perf_sum} ms")
        require(info.get("gpu"), "cli info did not name the card")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return loader


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def phase_step_breakdown(cfg, corpus, gpu, tag="training_step_breakdown"):
    """Where a training step's time goes: after a warm-up, STEP_PARTS steps
    as run_training runs them (prefetched batches) with CUDA events around
    the batch copy, the forward, the backward and Adam + EMA (with mel
    frames also around the upsampler's forward, inside the forward: the
    forward's part excludes it; its backward stays in the backward's), and
    the host clock around each whole step; then one torch.profiler trace
    (device activity only) of two steps: device time of the port's kernels
    (namespace wn) and of every other kernel, and the largest others. The
    idle share is 1 - device busy time / step wall time, busy time being
    the union of the kernels' spans (a programmatic dependent launch's span
    overlaps the launch before it). Returns the logged record."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.data import make_batches, prefetch

    arch, train = cfg.arch, cfg.train
    batches = prefetch(make_batches(corpus, train, with_mel=arch.use_local_cond))
    state = PT.init_state(2, arch, train, "cuda")
    up_events = []
    real_up = PT.upsample_cond_train

    def timed_up(*a):
        if up_events:
            up_events[0].record()
        out = real_up(*a)
        if up_events:
            up_events[1].record()
        return out

    def step(events=None):
        nonlocal state
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        up_events[:] = events[5:] if events else []
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

    PT.upsample_cond_train = timed_up
    try:
        for _ in range(2):
            step()
        parts = {"batch_copy": [], "forward": [], "backward": [], "adam_ema": []}
        if arch.use_local_cond:
            parts["upsampler_forward"] = []
        wall = []
        for _ in range(STEP_PARTS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(ev)
            torch.cuda.synchronize()
            wall.append(1000.0 * (time.perf_counter() - t0))
            for i, k in enumerate(("batch_copy", "forward", "backward", "adam_ema")):
                parts[k].append(ev[i].elapsed_time(ev[i + 1]))
            if arch.use_local_cond:
                up = ev[5].elapsed_time(ev[6])
                parts["upsampler_forward"].append(up)
                parts["forward"][-1] -= up
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step()
            torch.cuda.synchronize()
    finally:
        PT.upsample_cond_train = real_up
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
    rec = {
        "phase": tag, "gpu": gpu, "steps": STEP_PARTS,
        "device_ms_per_step": ms, "step_wall_ms": step_ms,
        "profile_device_ms_per_step": {"port_kernels": ours,
                                       "other_kernels": sum(other.values()),
                                       "busy": busy},
        "idle_share": (1.0 - busy / step_ms) if busy else "not measured",
        "top_other_kernels_ms_per_step": [[k[:90], v] for k, v in top],
        "top_port_kernels_ms_per_step": [[k[:90], v] for k, v in port_top],
    }
    log(json.dumps(rec))
    return rec


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

        # The CUDA-core route with cond, against plain versions that sum as
        # its kernels do (in-order FMA chains on the card, ar_tc.fma_product).
        # fp32 at the mel widths holds the cond term without bf16 rounding
        # (teacher-forced from the zero carry over CUDA_CORE_FP32_T steps,
        # within FP32_ATOL); bf16 at C = 24 one step of B1 and B7, and mega
        # and turbo teacher-forced over CUDA_CORE_T steps, within
        # LOGIT_ATOL, and as free runs (CUDA_CORE_FREE_T steps) whose every
        # choice must be a near-argmax of the plain scores on the kernel's
        # own history.
        a32 = dataclasses.replace(arch, compute_dtype="float32")
        a24 = dataclasses.replace(arch, residual_channels=24)
        require(ar_tc.route(a24, dt, cc) == "cuda_cores"
                and step_route(a24, a24.skip_channels) == "cuda_cores"
                and ar_tc.route(a32, torch.float32, cc) == "cuda_cores",
                "C=24 or fp32 left the CUDA-core route")
        p32, p24 = init_params(32, a32, "cuda"), init_params(24, a24, "cuda")
        fp32 = {"mega": mega_pair(a32, p32, p32["layers"],
                                  mel_inputs(a32, g, GEN_B, (CUDA_CORE_FP32_T,))[1], t0=0),
                "turbo": turbo_pair(a32, p32, p32["layers"],
                                    mel_inputs(a32, g, GEN_B, (CUDA_CORE_FP32_T,))[1], t0=0),
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
        cond24 = mel_inputs(a24, g, GEN_B, (CUDA_CORE_FREE_T,))[1]
        free = torch.full((CUDA_CORE_FREE_T, GEN_B), -1, device="cuda", dtype=torch.int32)
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
        # forward on the same cond (from the zero state: x = [Q/2, forced]),
        # held against the spread of two valid plain orders of the same run:
        # the forward's and mega's plain version summed in the CUDA-core
        # order (in-order FMA chains).
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
        h0, e0 = G._fused_frontend_zero(params, arch, b)
        _, lo = ar_mega.mega_generate_plain(
            params, lp, arch, ar_mega.mega_zero_carry(arch, h0, e0), 0,
            forced.t().contiguous(), 1.0, True, None, 0, tensor_cores=False,
            cond=cond.transpose(0, 1).contiguous())
        fwd_err, spread = abs_err(lk, lf), abs_err(lo.permute(2, 0, 1), lf)
        fwd_tol = max(LOGIT_ATOL, 2 * spread)
    log(json.dumps({
        "phase": "mel_kernels", "gpu": gpu, "config": "configs/wavenet30_mel.json",
        "Cc": cc, "Cc_with_speakers": ecc, "T": MEL_T, "turbo_T": 64,
        "cuda_core_T": {"fp32": CUDA_CORE_FP32_T, "bf16_C24_teacher_forced": CUDA_CORE_T,
                        "bf16_C24_free_run": CUDA_CORE_FREE_T},
        "tensor_core_route_max_abs_err": exact, "bit_identical": max(exact.values()) == 0.0,
        "b7_readings": tp_read,
        "cuda_core_route": {"fp32_max_abs_err": fp32, "fp32_atol": FP32_ATOL,
                            "bf16_C24_max_abs_err": core, "tp_fused_stack_bf16_C24": tp24,
                            "atol": LOGIT_ATOL, "tp_rtol": TP_RTOL,
                            "bf16_C24_free_run_max_choice_gap": gaps,
                            "gap_tol": 2 * LOGIT_ATOL,
                            "bf16_C24_teacher_forced_max_abs_err": drift},
        "mega_vs_plain_forward": {"B": b, "T": MEL_FWD_T, "max_abs_logit_err": fwd_err,
                                  "plain_orders_spread": spread,
                                  "atol": fwd_tol, "atol_rule": "max(LOGIT_ATOL, 2 x spread)"},
    }))
    require(max(exact.values()) == 0.0, f"a conditioned kernel differs from plain: {exact}")
    require(max(fp32.values()) <= FP32_ATOL and max(core.values()) <= LOGIT_ATOL
            and tp24["ring"] <= LOGIT_ATOL and tp24["skip_rel"] <= TP_RTOL
            and max(gaps.values()) <= 2 * LOGIT_ATOL and max(drift.values()) <= LOGIT_ATOL,
            f"the conditioned CUDA-core route differs: {fp32}, {core}, {tp24}, {gaps}, "
            f"teacher-forced {drift}")
    require(fwd_err <= fwd_tol,
            f"conditioned mega differs from forward: {fwd_err} (spread {spread})")

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


def cond_stack_case(arch, layers, cc: int, seed: int):
    """Numpy-seeded inputs of the conditioned training stack at the mel
    recipe's shape (B = 8, T = R - 1 + 6144) on the card: h0, a skip
    cotangent, cond (B, T, cc) holding bf16 values, and the layer weights
    with w_cond of cc channels (the mel arch's, or its fold [w_cond ;
    w_gcond] with speakers)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = arch.receptive_field - 1 + MEL_TRAIN_W
    h0 = rng.standard_normal((MEL_TRAIN_B, t, arch.residual_channels), dtype=np.float32)
    g = rng.standard_normal((MEL_TRAIN_B, t, arch.skip_channels), dtype=np.float32)
    cond = rng.standard_normal((MEL_TRAIN_B, t, cc), dtype=np.float32)
    lp = {k: v for k, v in layers.items() if k != "w_gcond"}
    if cc != lp["w_cond"].shape[1]:
        lp["w_cond"] = torch.cat([layers["w_cond"], layers["w_gcond"]], 1)
    return (torch.from_numpy(h0).cuda(), torch.from_numpy(g).cuda(),
            torch.from_numpy(cond).cuda().to(torch.bfloat16).float(), lp)


def phase_cond_train_kernels(params, arch, sp, gpu):
    """The conditioned training-stack pair (the TPU kernels' has_cond) at
    the mel recipe's shape: on the tensor cores at Cc' = 64 and 80 (mel +
    speaker), tapcat on as the recipe trains (tapcat off is a `-m cuda`
    case at small shapes), kernel against plain version bit for bit
    in skip, z, x, dh0, d cond and every weight gradient, a rerun of the
    backward bit-identical, and each call's launches; then the CUDA-core
    route, fp32 at the mel widths (relative error within FP32_ATOL) and
    bf16 at C = G = 24 (within KERNEL_RTOL), tapcat off and on. Returns
    the errors and times of the kernels line's has_cond rows (Cc' = 64,
    tapcat on, as the recipe trains). Comparison launches: the counters are
    restored."""
    import dataclasses

    import torch

    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    dt = compute_dtype(arch)
    dils, L = arch.dilations, len(arch.dilations)
    cc, ecc = arch.cond_channels, arch.cond_channels + arch.speaker_embed_dim
    counters = (TS.train_stack_fwd, TS.train_stack_bwd)
    saved = [(f.launches, f.cond_launches) for f in counters]
    out, exact = {}, {}
    for c_, layers, tapcat in ((cc, params["layers"], True), (ecc, sp["layers"], True)):
        require(TS.route(arch.residual_channels, arch.gate_channels, arch.skip_channels, dt,
                         c_) == "tensor_cores", f"Cc'={c_} left the tensor-core route")
        h0, g, cond, lp = cond_stack_case(arch, layers, c_, 40 + c_)
        n0 = [f.launches for f in counters]
        skip, z, x = TS.train_stack_fwd(lp, h0, dils, dt, tapcat, cond=cond)
        dh0, gr = TS.train_stack_bwd(lp, dils, dt, tapcat, z, x, g, cond=cond)
        launched = [f.launches - n for f, n in zip(counters, n0)]
        dh0b, grb = TS.train_stack_bwd(lp, dils, dt, tapcat, z, x, g, cond=cond)
        torch.cuda.synchronize()
        rerun = torch.equal(dh0, dh0b) and all(torch.equal(gr[k], grb[k]) for k in gr)
        del dh0b, grb
        with torch.no_grad():
            t_fwd = time.perf_counter()
            sp_, zp, xp = TS.stack_fwd_plain(lp, h0, dils, dt, tapcat, cond=cond)
            torch.cuda.synchronize()
            t_bwd = time.perf_counter()
            dp, gp = TS.stack_bwd_plain(lp, dils, dt, tapcat, zp, xp, g, cond=cond)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        errs = {"skip": abs_err(skip, sp_), "z_all": abs_err(z, zp), "x_all": abs_err(x, xp),
                "dh0": abs_err(dh0, dp), **{f"d {k}": abs_err(gr[k], gp[k]) for k in gp}}
        key = f"Cc'={c_} tapcat={tapcat}"
        exact[key] = errs
        log(json.dumps({"phase": "cond_train_stack_vs_plain", "gpu": gpu, "route": "tensor_cores",
                        "Cc": c_, "tapcat": tapcat, "B": MEL_TRAIN_B, "T": h0.shape[1],
                        "max_abs_err": errs, "bit_identical": max(errs.values()) == 0.0,
                        "backward_rerun_bit_identical": rerun, "launches_fwd_bwd": launched,
                        "plain_s": {"forward": t_bwd - t_fwd, "backward": t_end - t_bwd}}))
        require(max(errs.values()) == 0.0, f"conditioned train stack ({key}) differs: {errs}")
        require(rerun, f"conditioned train stack backward ({key}) is not reproducible")
        require(launched == [L + 1, 3 * L + 3],
                f"conditioned train stack ({key}) launched {launched}")
        if c_ == cc and tapcat:
            wb = torch.finfo(dt).bits // 8
            t = h0.shape[1]
            out["train_stack_fwd_cond"] = {
                "max_abs_err": max(errs[k] for k in ("skip", "z_all", "x_all")),
                "ms": cuda_ms(lambda: TS.train_stack_fwd(lp, h0, dils, dt, True, cond=cond), 5),
                "plain_ms": 1000.0 * (t_bwd - t_fwd),
                "cost": train_stack_cost(arch, MEL_TRAIN_B, t, wb, False, c_),
                "uncond_ms": cuda_ms(lambda: TS.train_stack_fwd(
                    {k: v for k, v in lp.items() if k != "w_cond"}, h0, dils, dt, True), 5)}
            out["train_stack_bwd_cond"] = {
                "max_abs_err": max(v for k, v in errs.items() if k.startswith("d")),
                "ms": cuda_ms(lambda: TS.train_stack_bwd(lp, dils, dt, True, z, x, g,
                                                         cond=cond), 3),
                "plain_ms": 1000.0 * (t_end - t_bwd),
                "cost": train_stack_cost(arch, MEL_TRAIN_B, t, wb, True, c_),
                "uncond_ms": cuda_ms(lambda: TS.train_stack_bwd(
                    {k: v for k, v in lp.items() if k != "w_cond"}, dils, dt, True, z, x, g), 3),
                "kernel_ms": kernel_split_ms(lambda: TS.train_stack_bwd(lp, dils, dt, True, z, x, g,
                                                                        cond=cond))}
        del skip, z, x, dh0, gr, sp_, zp, xp, dp, gp, h0, g, cond, lp

    for name, variant in (("fp32", dataclasses.replace(arch, compute_dtype="float32")),
                          ("c24_bf16", dataclasses.replace(arch, residual_channels=24,
                                                           gate_channels=24))):
        vdt = compute_dtype(variant)
        require(TS.route(variant.residual_channels, variant.gate_channels,
                         variant.skip_channels, vdt, cc) == "cuda_cores",
                f"{name} left the CUDA-core route")
        layers = params_from_jax(numpy_params(variant, 43), device="cuda")["layers"]
        h0, g, cond, lp = cond_stack_case(variant, layers, cc, 44)
        tol = FP32_ATOL if name == "fp32" else KERNEL_RTOL
        for tapcat in (False, True):
            n0 = [f.launches for f in counters]
            skip, z, x = TS.train_stack_fwd(lp, h0, dils, vdt, tapcat, cond=cond)
            dh0, gr = TS.train_stack_bwd(lp, dils, vdt, tapcat, z, x, g, cond=cond)
            torch.cuda.synchronize()
            launched = [f.launches - n for f, n in zip(counters, n0)]
            with torch.no_grad():
                sp_, zp, xp = TS.stack_fwd_plain(lp, h0, dils, vdt, tapcat, cond=cond)
                dp, gp = TS.stack_bwd_plain(lp, dils, vdt, tapcat, zp, xp, g, cond=cond)
            errs = {"skip": rel_err(skip, sp_), "dh0": rel_err(dh0, dp),
                    **{f"d {k}": rel_err(gr[k], gp[k]) for k in gp}}
            log(json.dumps({"phase": "cond_train_stack_cuda_core_route", "gpu": gpu,
                            "arch": name, "C": variant.residual_channels, "Cc": cc,
                            "tapcat": tapcat, "B": MEL_TRAIN_B, "T": h0.shape[1],
                            "launches_fwd_bwd": launched, "rel_err": errs, "rtol": tol}))
            require(launched == [L + 1, 3 * L + 1],
                    f"conditioned train stack {name} launched {launched}")
            require(max(errs.values()) <= tol,
                    f"conditioned train stack {name} (tapcat={tapcat}) differs: {errs}")
            del skip, z, x, dh0, gr, sp_, zp, xp, dp, gp
        del h0, g, cond, lp, layers
    for f, (n, nc) in zip(counters, saved):
        f.launches, f.cond_launches = n, nc
    return out


def upsample_plain(params, arch, frames, dtype):
    """The upsampler's function in `dtype` with plain products (the
    training upsampler's references: float64, and fp32 under the caller's
    TF32 switch): the projection, then per stage repeat, SAME (2f+1)-tap
    convolution and leaky ReLU."""
    import torch

    h = frames.to(dtype) @ params["proj_w"].to(dtype) + params["proj_b"].to(dtype)
    for f, stage in zip(arch.upsample_factors, params["stages"]):
        h = torch.repeat_interleave(h, f, dim=1)
        b, t, c = h.shape
        hp = torch.nn.functional.pad(h, (0, 0, f, f))
        win = hp.unfold(1, 2 * f + 1, 1).transpose(-1, -2).reshape(b, t, (2 * f + 1) * c)
        h = torch.nn.functional.leaky_relu(
            win @ stage["w"].to(dtype).reshape(-1, c) + stage["b"].to(dtype), 0.4)
    return h


def check_upsampler(params, arch, frames, gpu):
    """The training upsampler at the recipe's frames against float64
    (upsample_plain), values and every parameter's gradient, with cuBLAS's
    TF32 switch turned on around it (the upsampler must not depend on it),
    beside the same function through TF32 products; its forward and
    forward + backward times."""
    import torch

    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.models.conditioning import upsample_cond_train

    def run(fn, dtype):
        up = PT.tree_map(lambda p: p.detach().to(dtype).requires_grad_(True),
                         params["upsampler"])
        out = fn(up)
        (out * g.to(dtype)).sum().backward()
        return out.detach(), [p.grad for p in PT.tree_leaves(up)]

    g = torch.randn((frames.shape[0], frames.shape[1] * arch.hop_size, arch.cond_channels),
                    device="cuda", generator=torch.Generator(device="cuda").manual_seed(5))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got, ggot = run(lambda u: upsample_cond_train(u, arch, frames, torch.float32),
                        torch.float32)
        flag_kept = torch.backends.cuda.matmul.allow_tf32
        tf, gtf = run(lambda u: upsample_plain(u, arch, frames, torch.float32), torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    want, gwant = run(lambda u: upsample_plain(u, arch, frames, torch.float64), torch.float64)
    names = ["proj_b", "proj_w"] + [f"stages[{i}].{k}" for i in range(len(arch.upsample_factors))
                                    for k in ("b", "w")]
    err, tf_err = rel_err(got, want), rel_err(tf, want)
    gerr = {n: rel_err(a, b) for n, a, b in zip(names, ggot, gwant)}
    gtf_err = {n: rel_err(a, b) for n, a, b in zip(names, gtf, gwant)}
    held = {n: gerr[n] <= UPSAMPLE_TF32_SHARE * gtf_err[n] for n in names if n.endswith("w")}

    def fwd_bwd():
        u = PT.tree_map(lambda p: p.detach().requires_grad_(True), params["upsampler"])
        (upsample_cond_train(u, arch, frames, torch.bfloat16).float() * g).sum().backward()

    times = {"forward_ms": cuda_ms(lambda: upsample_cond_train(params["upsampler"], arch, frames,
                                                                torch.bfloat16), 10),
             "forward_backward_ms": cuda_ms(fwd_bwd, 5)}
    log(json.dumps({"phase": "training_upsampler_vs_float64", "gpu": gpu,
                    "frames": list(frames.shape), "rows": got.shape[1], "rel_err": err,
                    "tf32_products_rel_err": tf_err, "grad_rel_err": gerr,
                    "tf32_products_grad_rel_err": gtf_err, "weight_grads_held": held,
                    "rtol": UPSAMPLE_RTOL, "tf32_share": UPSAMPLE_TF32_SHARE,
                    "tf32_switch_on_around_the_call": True, "tf32_switch_restored": flag_kept,
                    **times}))
    require(err <= UPSAMPLE_RTOL and all(held.values()) and flag_kept,
            f"the training upsampler is not float32: {err}, {gerr}, TF32's {gtf_err}")
    return times


def phase_mel_training(gpu):
    """configs/wavenet30_mel.json's training half as written (B = 8, W =
    6144, bf16, fused frontend, stack with tapcat, post-loss, mm_embed_grad)
    on synthetic chords: run_training for MEL_TRAIN_STEPS steps with the
    counts set to 0 before it and read after (the conditioned stack pair
    every step), the loss, median step ms and samples/s; the loader's time
    per batch; the step split (upsampler included); then the speaker
    override (n_speakers = 8, Cc' = 80) for MEL_SPK_STEPS steps with its
    split; the training upsampler against float64; evaluation of held-out
    windows, fused and plain."""
    import dataclasses
    import io
    import statistics

    import torch

    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.data import make_batches, synthetic_corpus
    from lb_wavenet_tpu_torch.eval import evaluate
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS
    from lb_wavenet_tpu_torch.ops.cuda.build import BUILD

    work = os.path.join(BUILD, "chip_smoke_mel_train")   # gitignored, removed below
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = Config.load(MEL_CONFIG)
    tr = cfg.train
    require(tr.fused_frontend and tr.fused_stack and tr.tapcat and tr.fused_post
            and tr.mm_embed_grad and tr.mesh_data == -1 and cfg.arch.use_local_cond
            and (tr.batch_size, tr.window_size) == (MEL_TRAIN_B, MEL_TRAIN_W),
            "wavenet30_mel.json no longer holds the training settings this phase drives")
    counters = train_counters()
    stack = (TS.train_stack_fwd, TS.train_stack_bwd)
    results = {}
    try:
        for name, n_spk, steps in (("mel", 0, MEL_TRAIN_STEPS),
                                   ("mel+speaker", MEL_SPEAKERS, MEL_SPK_STEPS)):
            arch = dataclasses.replace(cfg.arch, n_speakers=n_spk)
            train = dataclasses.replace(tr, n_steps=steps, log_every=1, checkpoint_every=0,
                                        checkpoint_dir=os.path.join(work, f"ckpt{n_spk}"))
            run_cfg = dataclasses.replace(cfg, arch=arch, train=train)
            corpus = synthetic_corpus(arch, MEL_TRAIN_W, n_files=8, file_len=160000, seed=0)
            if n_spk:
                corpus.speakers = [i % n_spk for i in range(len(corpus.waves))]
            loader = make_batches(corpus, train, with_mel=True)
            next(loader)
            t0 = time.perf_counter()
            for _ in range(10):
                next(loader)
            loader_ms = 100.0 * (time.perf_counter() - t0)
            for f in (*counters.values(), *stack):
                f.launches = 0
            for f in stack:
                f.cond_launches = 0
            out = io.StringIO()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), no_plain_frontend():
                state = PT.run_training(run_cfg, corpus=corpus, device="cuda")
            wall = time.perf_counter() - t0
            launches = {k: f.launches for k, f in counters.items()}
            cond_launches = {f.__name__: f.cond_launches for f in stack}
            recs = [json.loads(ln) for ln in out.getvalue().splitlines()]
            losses = [r["loss"] for r in recs]
            step_ms = [r["step_time_ms"] for r in recs]
            ms = statistics.median(step_ms[1:])
            per_step = train_launches_per_call(arch)
            t = arch.receptive_field - 1 + MEL_TRAIN_W
            rec = {"phase": "mel_training", "gpu": gpu, "run": name,
                   "config": "configs/wavenet30_mel.json", "n_speakers": n_spk,
                   "Cc": arch.cond_channels + (arch.speaker_embed_dim if n_spk else 0),
                   "B": MEL_TRAIN_B, "W": MEL_TRAIN_W, "T": t, "steps": state.step,
                   "losses": losses, "step_ms": step_ms, "median_step_ms_after_first": ms,
                   "samples_per_s": MEL_TRAIN_B * MEL_TRAIN_W / (ms / 1000.0), "wall_s": wall,
                   "loader_ms_per_batch": loader_ms, "launches": launches,
                   "cond_stack_launches": cond_launches, "launches_per_step": per_step,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            log(json.dumps(rec))
            require(state.step == steps and len(losses) == steps, f"{name}: training stopped")
            require(all(v == v and abs(v) < 1e3 for v in losses), f"{name}: loss {losses}")
            require(steps < MEL_TRAIN_STEPS or losses[-1] < losses[0] - 0.1,
                    f"{name}: the loss did not fall: {losses}")
            for k, n in per_step.items():
                require(launches[k] == n * steps,
                        f"{name} {k}: {launches[k]} launches in {steps} steps, expected {n} each")
            require(cond_launches == {"train_stack_fwd": per_step["train_stack_fwd"] * steps,
                                      "train_stack_bwd": per_step["train_stack_bwd"] * steps},
                    f"{name}: the conditioned stack kernels launched {cond_launches}")
            rec["breakdown"] = phase_step_breakdown(run_cfg, corpus, gpu,
                                                    tag=f"mel_training_step_breakdown ({name})")
            results[name] = rec
            if n_spk == 0:
                cond_main = cond_launches
                mel_state, mel_arch, mel_train = state, arch, train
            del state, corpus

        held = synthetic_corpus(mel_arch, MEL_TRAIN_W, n_files=2, file_len=40000, seed=1)
        frames = torch.from_numpy(next(make_batches(held, mel_train, with_mel=True)).mel).cuda()
        up_times = check_upsampler(mel_state.params, mel_arch, frames, gpu)
        fused = evaluate(mel_state.params, mel_arch, held, MEL_TRAIN_B,
                         max_batches=MEL_EVAL_BATCHES, fused=True, tapcat=True)
        plain = evaluate(mel_state.params, mel_arch, held, MEL_TRAIN_B,
                         max_batches=MEL_EVAL_BATCHES)
        gap = abs(fused["nll"] - plain["nll"])
        log(json.dumps({"phase": "mel_eval", "gpu": gpu, "windows": fused["n_windows"],
                        "fused": fused, "plain": plain, "fused_vs_plain_nll": gap,
                        "atol": EVAL_NLL_ATOL}))
        require(0 < fused["nll"] < 10 and fused["n_windows"] == min(
            MEL_EVAL_BATCHES * MEL_TRAIN_B, len(held.index)), f"bad mel eval metrics: {fused}")
        require(gap <= EVAL_NLL_ATOL, f"mel eval fused and plain differ by {gap} nats")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return ({"train_stack_fwd_cond": cond_main["train_stack_fwd"],
             "train_stack_bwd_cond": cond_main["train_stack_bwd"]},
            {"runs": results, "upsampler": up_times})


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


def phase_timing(params, arch, errs, launches, gpu, tp, mel, mel_train, extra_rows=()):
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
    # Row 6's backward by kernel (its launches are not counted).
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    counted = TS.train_stack_fwd.launches, TS.train_stack_bwd.launches
    h30, g30 = train_inputs(arch, 13)
    _, z30, x30 = TS.train_stack_fwd(lp, h30, arch.dilations, compute_dtype(arch), True)
    stack_split = kernel_split_ms(lambda: TS.train_stack_bwd(
        lp, arch.dilations, compute_dtype(arch), True, z30, x30, g30))
    TS.train_stack_fwd.launches, TS.train_stack_bwd.launches = counted
    del h30, g30, z30, x30
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
        if name == "train_stack_bwd":
            row["kernel_ms"] = stack_split
            row["ptxas_bwd_wgrad_tc"] = wgrad_ptxas()
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
    kernels += cond_train_rows(*mel_train, launches, gpu)
    for row in extra_rows:
        if row["name"] == "mega_generate_vmem":   # row 2's function, plain version and shape
            row["plain_ms"] = mega_plain
    kernels += list(extra_rows)
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


def cond_train_rows(arch, cond_stack, trained, launches, gpu):
    """The kernels line's rows of the conditioned training-stack pair (the
    has_cond variants of B3), timed in cond_train_kernels at the mel
    recipe's shape (Cc' = 64, tapcat on), with the launches of the
    mel_training run; and the conditioned training cell's summary."""
    per_call = train_launches_per_call(arch)
    t = arch.receptive_field - 1 + MEL_TRAIN_W
    rows = []
    for name, key, rep in (("train_stack_fwd (has_cond)", "train_stack_fwd_cond",
                            "lb_wavenet_tpu/ops/pallas/train_stack.py:580"),
                           ("train_stack_bwd (has_cond)", "train_stack_bwd_cond",
                            "lb_wavenet_tpu/ops/pallas/train_stack.py:681")):
        m = cond_stack[key]
        bms, by = bound_ms(*m["cost"])
        n = per_call[key.replace("_cond", "")]
        rows.append({
            "name": name, "route": "cuda", "source": "lb_wavenet_tpu_torch/csrc/train_stack.cu",
            "replaces": rep, "launches": launches[key], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": None, "unit": f"ms per call of {n} launches (B={MEL_TRAIN_B}, "
                                        f"W={MEL_TRAIN_W}, T={t}, Cc'={arch.cond_channels})",
            "launches_per_call": n, "kernel_route": stack_route(arch),
            "uncond_ms_same_shape": m["uncond_ms"], "config": "configs/wavenet30_mel.json",
            "kernel_ms": m["kernel_ms"]})
    runs = trained["runs"]
    log(json.dumps({
        "phase": "mel_training_cell", "gpu": gpu, "config": "configs/wavenet30_mel.json",
        "median_step_ms": {k: v["median_step_ms_after_first"] for k, v in runs.items()},
        "samples_per_s": {k: v["samples_per_s"] for k, v in runs.items()},
        "loader_ms_per_batch": {k: v["loader_ms_per_batch"] for k, v in runs.items()},
        "device_ms_per_step": {k: v["breakdown"]["device_ms_per_step"] for k, v in runs.items()},
        "idle_share": {k: v["breakdown"]["idle_share"] for k, v in runs.items()},
        "upsampler_ms": trained["upsampler"],
        "stack_cond_over_uncond": {k: cond_stack[k]["ms"] / cond_stack[k]["uncond_ms"]
                                   for k in cond_stack},
    }))
    return rows


def sp_shape(arch):
    """(halo, T_l, T_ext) of one sequence-parallel shard of the mel recipe's
    window (T = R - 1 + W) over SP_N ranks."""
    halo = arch.receptive_field - 1
    t_l = -(-(halo + MEL_TRAIN_W) // SP_N)
    return halo, t_l, halo + t_l


def mask_case(arch, layers, t: int, cc: int, seed: int):
    """Numpy-seeded inputs of the masked training stack at (MEL_TRAIN_B, t)
    on the card: the halo mask (the first R - 1 rows 0, as rank 0's shard
    holds it), h0 masked as the masked frontend gives it, a skip cotangent,
    cond (B, t, cc) holding bf16 values, and the layer weights without
    w_gcond."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b, halo = MEL_TRAIN_B, arch.receptive_field - 1
    mask = torch.ones((b, t), device="cuda")
    mask[:, :halo] = 0.0
    h0 = torch.from_numpy(rng.standard_normal((b, t, arch.residual_channels),
                                              dtype=np.float32)).cuda() * mask[..., None]
    g = torch.from_numpy(rng.standard_normal((b, t, arch.skip_channels), dtype=np.float32)).cuda()
    cond = torch.from_numpy(rng.standard_normal((b, t, cc), dtype=np.float32)).cuda()
    lp = {k: v for k, v in layers.items() if k != "w_gcond"}
    return mask, h0, g, cond.to(torch.bfloat16).float(), lp


def phase_mask_kernels(params, arch, gpu):
    """The masked kernel pairs (the TPU kernels' has_mask / input_mask, rows
    5m, 6m, 9m, 10m) at one sequence-parallel shard of the mel recipe (B =
    8, T_ext = R - 1 + T_l, the halo mask's first R - 1 rows 0, Cc' = 64,
    tapcat on). The frontend pair on both routes: h0 bit for bit on the
    tensor cores (within KERNEL_RTOL elsewhere) with its masked rows 0, the
    gradients within KERNEL_RTOL, as the unmasked pair's; the stack pair on
    the tensor cores bit for bit in skip, z, x, dh0, d cond and every
    gradient, x's masked rows 0; an all-ones mask bit for bit the unmasked
    kernels on every route; the stack's CUDA-core route (fp32; bf16 at C =
    24), tapcat off and on, within FP32_ATOL / KERNEL_RTOL. Then the masked
    pairs' times against the unmasked pairs at the same shape, and the
    unconditioned unmasked stack at WaveNet-30's T = 13310. Comparison
    launches: the counters are restored."""
    import dataclasses

    import numpy as np
    import torch

    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    dt, wb = compute_dtype(arch), 2
    dils, L = arch.dilations, len(arch.dilations)
    halo, t_l, t = sp_shape(arch)
    b, cc = MEL_TRAIN_B, arch.cond_channels
    counters = (F.frontend_fwd, F.frontend_bwd, TS.train_stack_fwd, TS.train_stack_bwd)
    saved = [(f.launches, f.mask_launches) for f in counters]
    out = {}

    rng = np.random.default_rng(51)
    x = torch.from_numpy(rng.integers(0, arch.quant_channels, (b, t)).astype(np.int32)).cuda()
    dh = torch.from_numpy(rng.standard_normal((b, t, arch.residual_channels),
                                              dtype=np.float32)).cuda()
    mask = torch.ones((b, t), device="cuda")
    mask[:, :halo] = 0.0
    ones = torch.ones_like(mask)
    emb, w, bias = params["embed"], params["input_conv"]["w"], params["input_conv"]["b"]
    for fdt in (dt, torch.float32):
        route = front_route(arch, fdt)
        tc = route == "tensor_cores"
        n0 = [f.mask_launches for f in counters[:2]]
        h = F.frontend_fwd(emb, w, bias, x, fdt, mask=mask)
        grads = F.frontend_bwd(emb, w, x, fdt, dh, mask=mask)
        torch.cuda.synchronize()
        launched = [f.mask_launches - n for f, n in zip(counters[:2], n0)]
        t0 = time.perf_counter()
        hp = F.frontend_fwd_plain(emb, w, bias, x, fdt, mask=mask)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gp = F.frontend_bwd_plain(emb, w, x, fdt, dh, mask=mask)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        errs = {"h0": rel_err(h, hp), **{f"d_{k}": rel_err(u, v) for k, u, v in
                                          zip(("embed", "w", "b"), grads, gp)}}
        ones_exact = torch.equal(F.frontend_fwd(emb, w, bias, x, fdt, mask=ones),
                                 F.frontend_fwd(emb, w, bias, x, fdt)) and all(
            torch.equal(u, v) for u, v in zip(F.frontend_bwd(emb, w, x, fdt, dh, mask=ones),
                                              F.frontend_bwd(emb, w, x, fdt, dh)))
        rows_zero = bool((h[mask == 0] == 0).all())
        log(json.dumps({"phase": "masked_frontend_vs_plain", "gpu": gpu, "dtype": str(fdt),
                        "route": route, "B": b, "T": t, "masked_rows": halo, "rel_err": errs,
                        "rtol": KERNEL_RTOL, "h0_bit_exact": torch.equal(h, hp),
                        "masked_rows_zero": rows_zero, "all_ones_equals_unmasked": ones_exact,
                        "launches_fwd_bwd": launched}))
        require(max(errs.values()) <= KERNEL_RTOL, f"masked frontend ({route}) differs: {errs}")
        require(not tc or torch.equal(h, hp), "masked frontend h0 differs from plain")
        require(rows_zero and ones_exact, f"masked frontend ({route}): rows {rows_zero}, "
                                          f"all-ones {ones_exact}")
        require(launched == [2, 3 if tc else 4], f"masked frontend launched {launched}")
        if fdt == dt:
            out["frontend_fwd_mask"] = {
                "max_abs_err": abs_err(h, hp), "plain_ms": 1000.0 * (t1 - t0),
                "ms": cuda_ms(lambda: F.frontend_fwd(emb, w, bias, x, fdt, mask=mask), 20),
                "unmasked_ms": cuda_ms(lambda: F.frontend_fwd(emb, w, bias, x, fdt), 20),
                "cost": frontend_cost(arch, b, t, False)}
            out["frontend_bwd_mask"] = {
                "max_abs_err": max(abs_err(u, v) for u, v in zip(grads, gp)),
                "plain_ms": 1000.0 * (t2 - t1),
                "ms": cuda_ms(lambda: F.frontend_bwd(emb, w, x, fdt, dh, mask=mask), 20),
                "unmasked_ms": cuda_ms(lambda: F.frontend_bwd(emb, w, x, fdt, dh), 20),
                "cost": frontend_cost(arch, b, t, True)}
        del h, grads, hp, gp
    del x, dh

    require(TS.route(arch.residual_channels, arch.gate_channels, arch.skip_channels, dt,
                     cc) == "tensor_cores", "the masked stack left the tensor-core route")
    mask, h0, g, cond, lp = mask_case(arch, params["layers"], t, cc, 52)
    n0 = [f.mask_launches for f in counters[2:]]
    skip, z, xa = TS.train_stack_fwd(lp, h0, dils, dt, True, cond=cond, mask=mask)
    dh0, gr = TS.train_stack_bwd(lp, dils, dt, True, z, xa, g, cond=cond, mask=mask)
    torch.cuda.synchronize()
    launched = [f.mask_launches - n for f, n in zip(counters[2:], n0)]
    with torch.no_grad():
        t0 = time.perf_counter()
        sp_, zp, xp = TS.stack_fwd_plain(lp, h0, dils, dt, True, cond=cond, mask=mask)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dp, gp = TS.stack_bwd_plain(lp, dils, dt, True, zp, xp, g, cond=cond, mask=mask)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    errs = {"skip": abs_err(skip, sp_), "z_all": abs_err(z, zp), "x_all": abs_err(xa, xp),
            "dh0": abs_err(dh0, dp), **{f"d {k}": abs_err(gr[k], gp[k]) for k in gp}}
    rows_zero = bool((xa[:, mask == 0] == 0).all())
    del sp_, zp, xp, dp, gp
    a = TS.train_stack_fwd(lp, h0, dils, dt, True, cond=cond, mask=torch.ones_like(mask))
    u = TS.train_stack_fwd(lp, h0, dils, dt, True, cond=cond)
    ones_exact = all(torch.equal(p, q) for p, q in zip(a, u))
    da, ga = TS.train_stack_bwd(lp, dils, dt, True, *a[1:], g, cond=cond,
                                mask=torch.ones_like(mask))
    du, gu = TS.train_stack_bwd(lp, dils, dt, True, *u[1:], g, cond=cond)
    ones_exact = ones_exact and torch.equal(da, du) and all(torch.equal(ga[k], gu[k]) for k in gu)
    del a, u, da, ga, du, gu
    log(json.dumps({"phase": "masked_train_stack_vs_plain", "gpu": gpu, "route": "tensor_cores",
                    "Cc": cc, "tapcat": True, "B": b, "T": t, "masked_rows": halo,
                    "max_abs_err": errs, "bit_identical": max(errs.values()) == 0.0,
                    "x_masked_rows_zero": rows_zero, "all_ones_equals_unmasked": ones_exact,
                    "launches_fwd_bwd": launched,
                    "plain_s": {"forward": t1 - t0, "backward": t2 - t1}}))
    require(max(errs.values()) == 0.0, f"masked train stack differs: {errs}")
    require(rows_zero and ones_exact, f"masked train stack: rows {rows_zero}, all-ones "
                                      f"{ones_exact}")
    require(launched == [L + 1, 3 * L + 3], f"masked train stack launched {launched}")
    out["train_stack_fwd_mask"] = {
        "max_abs_err": max(errs[k] for k in ("skip", "z_all", "x_all")),
        "plain_ms": 1000.0 * (t1 - t0),
        "ms": cuda_ms(lambda: TS.train_stack_fwd(lp, h0, dils, dt, True, cond=cond,
                                                 mask=mask), 5),
        "unmasked_ms": cuda_ms(lambda: TS.train_stack_fwd(lp, h0, dils, dt, True, cond=cond),
                               5),
        "cost": train_stack_cost(arch, b, t, wb, False, cc)}
    out["train_stack_bwd_mask"] = {
        "max_abs_err": max(v for k, v in errs.items() if k.startswith("d")),
        "plain_ms": 1000.0 * (t2 - t1),
        "ms": cuda_ms(lambda: TS.train_stack_bwd(lp, dils, dt, True, z, xa, g, cond=cond,
                                                 mask=mask), 3),
        "unmasked_ms": cuda_ms(lambda: TS.train_stack_bwd(lp, dils, dt, True, z, xa, g,
                                                          cond=cond), 3),
        "kernel_ms": kernel_split_ms(lambda: TS.train_stack_bwd(lp, dils, dt, True, z, xa, g,
                                                                cond=cond, mask=mask)),
        "cost": train_stack_cost(arch, b, t, wb, True, cc)}
    del skip, z, xa, dh0, gr, h0, g, cond
    # The unconditioned, unmasked pair at WaveNet-30's training shape (the
    # mel arch's layer widths are WaveNet-30's).
    plain_lp = {k: v for k, v in lp.items() if k != "w_cond"}
    t30 = arch.receptive_field - 1 + TRAIN_W
    rng = np.random.default_rng(53)
    h30 = torch.from_numpy(rng.standard_normal((TRAIN_B, t30, arch.residual_channels),
                                               dtype=np.float32)).cuda()
    g30 = torch.from_numpy(rng.standard_normal((TRAIN_B, t30, arch.skip_channels),
                                               dtype=np.float32)).cuda()
    _, z30, x30 = TS.train_stack_fwd(plain_lp, h30, dils, dt, True)
    out["uncond_bwd_ms_T13310"] = cuda_ms(
        lambda: TS.train_stack_bwd(plain_lp, dils, dt, True, z30, x30, g30), 5)
    del z30, x30, h30, g30

    for name, variant in (("fp32", dataclasses.replace(arch, compute_dtype="float32")),
                          ("c24_bf16", dataclasses.replace(arch, residual_channels=24,
                                                           gate_channels=24))):
        vdt = compute_dtype(variant)
        require(TS.route(variant.residual_channels, variant.gate_channels,
                         variant.skip_channels, vdt, cc) == "cuda_cores",
                f"{name} left the CUDA-core route")
        layers = params_from_jax(numpy_params(variant, 54), device="cuda")["layers"]
        mask, h0, g, cond, lp = mask_case(variant, layers, t, cc, 55)
        tol = FP32_ATOL if name == "fp32" else KERNEL_RTOL
        for tapcat in (False, True):
            n0 = [f.mask_launches for f in counters[2:]]
            skip, z, xa = TS.train_stack_fwd(lp, h0, dils, vdt, tapcat, cond=cond, mask=mask)
            dh0, gr = TS.train_stack_bwd(lp, dils, vdt, tapcat, z, xa, g, cond=cond, mask=mask)
            torch.cuda.synchronize()
            launched = [f.mask_launches - n for f, n in zip(counters[2:], n0)]
            with torch.no_grad():
                sp_, zp, xp = TS.stack_fwd_plain(lp, h0, dils, vdt, tapcat, cond=cond,
                                                 mask=mask)
                dp, gp = TS.stack_bwd_plain(lp, dils, vdt, tapcat, zp, xp, g, cond=cond,
                                            mask=mask)
            errs = {"skip": rel_err(skip, sp_), "dh0": rel_err(dh0, dp),
                    **{f"d {k}": rel_err(gr[k], gp[k]) for k in gp}}
            rows_zero = bool((xa[:, mask == 0] == 0).all())
            a = TS.train_stack_fwd(lp, h0, dils, vdt, tapcat, cond=cond,
                                   mask=torch.ones_like(mask))
            u = TS.train_stack_fwd(lp, h0, dils, vdt, tapcat, cond=cond)
            da, _ = TS.train_stack_bwd(lp, dils, vdt, tapcat, *a[1:], g, cond=cond,
                                       mask=torch.ones_like(mask))
            du, _ = TS.train_stack_bwd(lp, dils, vdt, tapcat, *u[1:], g, cond=cond)
            ones_exact = all(torch.equal(p, q) for p, q in zip(a, u)) and torch.equal(da, du)
            log(json.dumps({"phase": "masked_train_stack_cuda_core_route", "gpu": gpu,
                            "arch": name, "C": variant.residual_channels, "Cc": cc,
                            "tapcat": tapcat, "B": b, "T": t, "launches_fwd_bwd": launched,
                            "rel_err": errs, "rtol": tol, "x_masked_rows_zero": rows_zero,
                            "all_ones_equals_unmasked": ones_exact}))
            require(launched == [L + 1, 3 * L + 1], f"masked stack {name} launched {launched}")
            require(max(errs.values()) <= tol and rows_zero and ones_exact,
                    f"masked train stack {name} (tapcat={tapcat}) differs: {errs}, rows "
                    f"{rows_zero}, all-ones {ones_exact}")
            del skip, z, xa, dh0, gr, sp_, zp, xp, dp, gp, a, u, da, du
        del mask, h0, g, cond, lp, layers
    for f, (n, nm) in zip(counters, saved):
        f.launches, f.mask_launches = n, nm
    log(json.dumps({"phase": "mask_timing", "gpu": gpu, "B": b, "T": t, "Cc": cc,
                    "tapcat": True, "masked_ms": {k: v["ms"] for k, v in out.items()
                                                   if isinstance(v, dict)},
                    "unmasked_ms_same_shape": {k: v["unmasked_ms"] for k, v in out.items()
                                               if isinstance(v, dict)},
                    "masked_over_unmasked": {k: v["ms"] / v["unmasked_ms"]
                                             for k, v in out.items() if isinstance(v, dict)},
                    "uncond_unmasked_train_stack_bwd_ms_B8_T13310":
                        out["uncond_bwd_ms_T13310"]}))
    return out


def mask_rows(arch, masked, launches):
    """The kernels line's rows of the masked variants (rows 5m, 6m, 9m,
    10m), timed in mask_kernels at one shard's shape, with the launches of
    parallel_training's sequence-parallel steps (both ranks); each bound is
    its unmasked function's plus the mask's bytes read."""
    halo, t_l, t = sp_shape(arch)
    per_call = train_launches_per_call(arch)
    rows = []
    for name, key, base, rep in (
            ("frontend_fwd (input_mask)", "frontend_fwd_mask", "frontend_fwd",
             "lb_wavenet_tpu/ops/pallas/frontend.py:71"),
            ("frontend_bwd (input_mask)", "frontend_bwd_mask", "frontend_bwd",
             "lb_wavenet_tpu/ops/pallas/frontend.py:120"),
            ("train_stack_fwd (has_mask)", "train_stack_fwd_mask", "train_stack_fwd",
             "lb_wavenet_tpu/ops/pallas/train_stack.py:580"),
            ("train_stack_bwd (has_mask)", "train_stack_bwd_mask", "train_stack_bwd",
             "lb_wavenet_tpu/ops/pallas/train_stack.py:681")):
        m = masked[key]
        nbytes, flops = m["cost"]
        bms, by = bound_ms(nbytes + 4 * MEL_TRAIN_B * t, flops)
        src = "frontend" if base.startswith("frontend") else "train_stack"
        rows.append({
            "name": name, "route": "cuda", "source": f"lb_wavenet_tpu_torch/csrc/{src}.cu",
            "replaces": rep, "launches": launches[key], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "unit": f"ms per call of {per_call[base]} launches (one sequence-parallel shard: "
                    f"B={MEL_TRAIN_B}, T_ext={t} = {halo} halo + {t_l}"
                    + (f", Cc'={arch.cond_channels}" if src == "train_stack" else "") + ")",
            "launches_per_call": per_call[base],
            "kernel_route": front_route(arch) if src == "frontend" else stack_route(arch),
            "unmasked_ms_same_shape": m["unmasked_ms"], "config": "configs/wavenet30_mel.json",
            "kernel_ms": m["kernel_ms"]})
    return rows


@contextlib.contextmanager
def mask_counters_zeroed():
    """Set every training counter (all and masked launches) to 0 around a
    driven path and yield the masked counts' reader."""
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    fs = {"frontend_fwd_mask": F.frontend_fwd, "frontend_bwd_mask": F.frontend_bwd,
          "train_stack_fwd_mask": TS.train_stack_fwd, "train_stack_bwd_mask": TS.train_stack_bwd}
    for f in (*train_counters().values(), *fs.values()):
        f.launches = 0
    for f in fs.values():
        f.mask_launches = 0
    yield lambda: {k: f.mask_launches for k, f in fs.items()}


def par_corpus(arch, window: int, seed: int = 0):
    """The synthetic corpus every process of parallel_training builds
    alike."""
    from lb_wavenet_tpu_torch.data import synthetic_corpus

    return synthetic_corpus(arch, window, n_files=8, file_len=160000, seed=seed)


def par_layouts():
    """{name: Config} of the three layouts parallel_training drives: config
    5 as written (data-parallel), the mel recipe time-sharded, the stress
    config's training section skip-split over 2 model ranks."""
    import dataclasses

    from lb_wavenet_tpu_torch.config import Config

    sp = Config.load(MEL_CONFIG)
    tp = Config.load(TP_CONFIG)
    return {"dp": Config.load(DP_CONFIG),
            "sp": dataclasses.replace(sp, train=dataclasses.replace(sp.train,
                                                                    seq_parallel=True)),
            "tp": dataclasses.replace(tp, train=dataclasses.replace(tp.train, mesh_model=2))}


def par_batches(cfg, host_id=0, host_count=1):
    """The first PAR_STEPS host batches of a layout's loader."""
    from lb_wavenet_tpu_torch.data import make_batches

    corpus = par_corpus(cfg.arch, cfg.train.window_size)
    it = make_batches(corpus, cfg.train, host_id=host_id, host_count=host_count,
                      with_mel=cfg.arch.use_local_cond)
    return [next(it) for _ in range(PAR_STEPS)]


def host_rows(hb, mesh):
    """This data rank's rows data_rank::data of a global host batch."""
    import dataclasses

    return dataclasses.replace(hb, **{
        f.name: getattr(hb, f.name)[mesh.data_rank::mesh.data]
        for f in dataclasses.fields(hb) if getattr(hb, f.name) is not None})


def train_rank(rank, world, store, work):
    """One of two ranks sharing the card (spawned by parallel_training)
    over gloo: (a) data-parallel steps of config 5 on this rank's rows, (b)
    sequence-parallel steps of the mel recipe on this rank's time shard
    (the masked kernels, no plain stack or frontend op), (c) skip-split
    steps of the stress config on this rank's skip half, (d) the
    divergence guard and a model-sharded run_training that checkpoints and
    resumes. Results saved under `work`."""
    import dataclasses
    import io
    import statistics

    import numpy as np
    import torch

    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.parallel import halo as H
    from lb_wavenet_tpu_torch.parallel.mesh import all_reduce_, all_reduce_flat_, make_mesh
    from lb_wavenet_tpu_torch.utils import checkpoint, multihost
    from lb_wavenet_tpu_torch.utils.convert import params_to_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = multihost.init_distributed(device="cuda", init_method=f"file://{store}",
                                         rank=rank, world_size=world, local_world_size=world)
    layouts = par_layouts()
    out = {"backend": backend}

    def timed_ms(fn, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1000.0 * (time.perf_counter() - t0))
        return statistics.median(times)

    def drive(mesh, step, state, batches, to_device):
        """PAR_STEPS steps: the first one's loss and Adam mu (whole width),
        the later steps' median ms."""
        rec, times = {}, []
        for i, hb in enumerate(batches):
            batch = to_device(hb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            loss = float(loss)
            torch.cuda.synchronize()
            times.append(1000.0 * (time.perf_counter() - t0))
            if i == 0:
                whole = PT.gather_state(state, mesh)
                rec["loss"] = loss
                if rank == 0:
                    rec["mu"] = params_to_numpy(whole.opt_state["mu"])
                del whole
            rec.setdefault("losses", []).append(loss)
        rec["step_ms"] = times
        rec["median_step_ms_after_first"] = statistics.median(times[1:])
        return state, rec

    try:
        # (a) data-parallel: config 5 as written, this rank's rows.
        cfg = layouts["dp"]
        mesh = make_mesh(cfg.train.mesh_data, cfg.train.mesh_model)
        out["device"], out["dp_mesh"] = str(mesh.device), mesh.describe()
        state = PT.init_state(cfg.train.seed, cfg.arch, cfg.train, mesh.device)
        # The steps take this rank's rows of the global batch, as its own
        # loader gives them (held below): the log-mel of a batched call is
        # not bitwise the same at another batch size, and the input conv's
        # and the embedding's gradients, sums over 590k positions with
        # cancellation, carry such differences far.
        whole = par_batches(cfg)
        batches = [host_rows(hb, mesh) for hb in whole]
        own = par_batches(cfg, mesh.data_rank, mesh.data)
        out["dp_loader"] = {
            "inputs_targets_mask_equal": all(
                np.array_equal(getattr(a, k), getattr(b, k)) for a, b in zip(own, batches)
                for k in ("inputs", "targets", "mask")),
            "mel_max_abs_diff": max(float(np.abs(a.mel - b.mel).max())
                                    for a, b in zip(own, batches))}
        del whole, own
        with mask_counters_zeroed():
            state, out["dp"] = drive(mesh, PT.make_dp_train_step(mesh, cfg.arch, cfg.train),
                                     state, batches, lambda hb: PT.batch_to_device(hb, mesh.device))
            out["dp"]["launches"] = {k: f.launches for k, f in train_counters().items()}
        n = sum(x.numel() for x in PT.tree_leaves(state.params)) + 2
        buf = torch.zeros(n, device=mesh.device)
        out["dp"]["all_reduce_ms"] = timed_ms(
            lambda: all_reduce_flat_([buf], mesh.data_group, mesh.data), 5)
        out["dp"]["all_reduce_floats"] = n
        out["dp"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del state, batches, buf

        # (b) sequence-parallel: the mel recipe, time sharded over the data
        # axis; the masked kernels every step, no plain stack or frontend op.
        cfg = layouts["sp"]
        mesh = make_mesh(-1, 1)
        state = PT.init_state(cfg.train.seed, cfg.arch, cfg.train, mesh.device)
        params0 = state.params
        batches = par_batches(cfg)
        to_dev = lambda hb: PT.seq_batch_to_device(hb, mesh, cfg.train.window_size,  # noqa: E731
                                                   mesh.device)
        with mask_counters_zeroed() as read, no_plain_frontend(stack=True):
            state, out["sp"] = drive(mesh, PT.make_sp_train_step(mesh, cfg.arch, cfg.train),
                                     state, batches, to_dev)
            out["sp"]["mask_launches"] = read()
            out["sp"]["launches"] = {k: f.launches for k, f in train_counters().items()}
        b0 = to_dev(batches[0])
        with torch.no_grad():
            logits = H.sequence_parallel_logits(
                params0, cfg.arch, b0["inputs"], mesh, cond_frames=b0["mel"], fused_stack=True,
                tapcat=True, fused_frontend=True)
        torch.save(logits.cpu(), os.path.join(work, f"sp_logits{rank}.pt"))
        out["sp"]["shard"] = {"T": b0["inputs"].shape[1], "T_l": logits.shape[1],
                              "halo": cfg.arch.receptive_field - 1}
        del state, params0, batches, b0, logits

        # (c) skip-split model-parallel: the stress config, model axis 2.
        cfg = layouts["tp"]
        mesh = make_mesh(cfg.train.mesh_data, cfg.train.mesh_model)
        out["tp_mesh"] = mesh.describe()
        whole = PT.init_state(cfg.train.seed, cfg.arch, cfg.train, mesh.device)
        state = PT.shard_state(whole, mesh)
        out["tp_w_skip_local"] = list(state.params["layers"]["w_skip"].shape)
        batches = par_batches(cfg)
        with mask_counters_zeroed():
            state, out["tp"] = drive(mesh, PT.make_tp_train_step(mesh, cfg.arch, cfg.train),
                                     state, batches, lambda hb: PT.batch_to_device(hb, mesh.device))
            out["tp"]["launches"] = {k: f.launches for k, f in train_counters().items()}
        hidden = torch.zeros((cfg.train.batch_size, cfg.train.window_size,
                              cfg.arch.skip_channels), device=mesh.device)
        out["tp"]["hidden_all_reduce_ms"] = timed_ms(lambda: all_reduce_(hidden,
                                                                          mesh.model_group), 5)

        # (d) the guard on every rank, then run_training (model-sharded)
        # that checkpoints (rank 0 writes whole tensors) and resumes.
        multihost.assert_replicated_params(state.params, PAR_STEPS, mesh)
        out["guard_passed"] = True
        out["checksum"] = multihost.params_checksum(state.params, mesh)
        del state, whole, batches, hidden
        ckpt = os.path.join(work, "ckpt_tp")
        run_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=ckpt, checkpoint_every=1, log_every=1))
        corpus = par_corpus(cfg.arch, cfg.train.window_size)
        with contextlib.redirect_stdout(io.StringIO()):
            PT.run_training(run_cfg, corpus=corpus, n_steps=2)
            final = PT.run_training(run_cfg, corpus=corpus, n_steps=3)
        out["run"] = {"step": final.step, "ckpt_steps": checkpoint.steps(ckpt),
                      "w_skip_local": list(final.params["layers"]["w_skip"].shape)}
        if rank == 0:
            whole = checkpoint.restore_params(ckpt)
            out["run"]["ckpt_shapes"] = {"layers.w_skip": list(whole["layers"]["w_skip"].shape),
                                         "layers.b_skip": list(whole["layers"]["b_skip"].shape),
                                         "post.w1": list(whole["post"]["w1"].shape)}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()


def par_reference(name, cfg):
    """The one-rank step of a layout at its initial state on the first
    global batch, on the card, in the accumulable form every multi-rank
    step takes (the numerator's gradients, divided by the mask sum after
    the backward: the data-parallel step on one rank), its loss and Adam
    mu. Each reference computes every row as its layout does, since the
    bf16 stack carries a one-ulp change of an input through 30 layers into
    gradient leaves built from cancelling sums:
      * "dp": grad_accum = 2, whose micros (rows i::2) are the ranks' rows
        at the ranks' shape (the training upsampler, a library product,
        gives other bits for a row at another batch size: read below);
      * "sp": the windowed (unsharded) fused step;
      * "tp": the unsharded step with the post network and CE in plain
        PyTorch, as the model-parallel step runs them.
    Also the recipe's own one-shot step (train_step, fused post-loss) as a
    reading, and its time on the card alone (a second call); for "dp" the upsampler's rows 0::2 at B = 64 against B = 32;
    for "sp" the unsharded forward's logits of the time-padded batch."""
    import dataclasses

    import torch

    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.parallel.halo import upsample_for_sp
    from lb_wavenet_tpu_torch.parallel.mesh import local_mesh
    from lb_wavenet_tpu_torch.utils.convert import params_to_numpy

    train = dataclasses.replace(cfg.train, seq_parallel=False, mesh_model=1)
    state = PT.init_state(train.seed, cfg.arch, train, "cuda")
    hb = par_batches(cfg)[0]
    batch = PT.batch_to_device(hb, "cuda")
    same_rows = dict(dp=dict(grad_accum=SP_N), sp={}, tp=dict(fused_post=False))[name]
    new, loss = PT.make_dp_train_step(local_mesh("cuda"), cfg.arch, dataclasses.replace(
        train, **same_rows))(state, batch)
    ref = {"loss": float(loss), "mu": params_to_numpy(new.opt_state["mu"]),
           "as_ranks": same_rows}
    new, loss = PT.train_step(state, batch, cfg.arch, train)
    ref["recipe_mu"] = params_to_numpy(new.opt_state["mu"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, loss = PT.train_step(state, batch, cfg.arch, train)   # warm: timed
    float(loss)
    torch.cuda.synchronize()
    ref["recipe_step_ms"] = 1000.0 * (time.perf_counter() - t0)
    if name == "dp":
        from lb_wavenet_tpu_torch.models.conditioning import upsample_cond_train
        from lb_wavenet_tpu_torch.models.wavenet import compute_dtype

        with torch.no_grad():
            up = lambda m: upsample_cond_train(state.params["upsampler"], cfg.arch, m,  # noqa: E731
                                               compute_dtype(cfg.arch))
            ref["upsampler_rows_B64_vs_B32"] = abs_err(up(batch["mel"])[0::2],
                                                       up(batch["mel"][0::2]))
    if name == "sp":
        mesh = local_mesh("cuda")
        b = PT.seq_batch_to_device(hb, dataclasses.replace(mesh, data=SP_N), train.window_size,
                                   "cuda")
        with torch.no_grad():
            cond = upsample_for_sp(state.params, cfg.arch, b["mel"], b["inputs"].shape[1])
            ref["logits"] = PT.forward_fused(state.params, cfg.arch, b["inputs"], cond=cond,
                                             tapcat=True, fused_frontend=True).cpu()
    del state, new
    torch.cuda.empty_cache()
    return ref


def phase_parallel_training(gpu):
    """Training across ranks on the one card: two processes over gloo
    (NCCL refuses two ranks on one device; every collective goes through
    host memory), spawned once (`train_rank`). (a) config 5 data-parallel,
    (b) the mel recipe sequence-parallel, (c) the stress config skip-split,
    each PAR_STEPS steps: the first step's loss and every Adam first moment
    (1 - b1) g against the one-rank step at the same state and batch
    within STEP_RTOL; the sequence-parallel steps launch the masked kernels
    every step and no plain stack or frontend op, and its scored logits
    rows are compared with the unsharded forward's; (d) the guard passes on
    both ranks and a model-sharded run_training checkpoints whole tensors
    and resumes. Then `torchrun --nproc-per-node 2 -m
    lb_wavenet_tpu_torch.cli train --set train.seq_parallel=true` for 2
    steps and `cli eval` from its checkpoint directory. Returns the masked
    kernels' launches (both ranks) and the layouts' readings."""
    import numpy as np
    import torch

    from lb_wavenet_tpu_torch.data import write_wav
    from lb_wavenet_tpu_torch.ops.cuda.build import BUILD

    layouts = par_layouts()
    work = os.path.join(BUILD, "chip_smoke_par")   # gitignored, removed below
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.perf_counter()
        refs = {name: par_reference(name, cfg) for name, cfg in layouts.items()}
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(train_rank, args=(2, os.path.join(work, "store"), work),
                                    nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        sp_logits = [torch.load(os.path.join(work, f"sp_logits{r}.pt")) for r in range(2)]

        readings, problems = {}, []
        for name in ("dp", "sp", "tp"):
            got, ref = ranks[0][name], refs[name]
            errs = {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"])}
            errs.update(leaf_errs_np(got["mu"], ref["mu"]))
            worst = max(errs, key=errs.get)
            recipe_errs = leaf_errs_np(got["mu"], ref["recipe_mu"])
            recipe_worst = max(recipe_errs, key=recipe_errs.get)
            readings[name] = {"loss": got["loss"], "loss_1rank": ref["loss"],
                              "losses": got["losses"], "max_rel_err": errs[worst],
                              "max_rel_err_leaf": worst, "rel_err": errs,
                              "reference_as_ranks": ref["as_ranks"],
                              "vs_recipe_one_shot_step": {
                                  recipe_worst: recipe_errs[recipe_worst]},
                              "ranks_agree": ranks[1][name]["losses"] == got["losses"],
                              "step_ms_per_rank": [r[name]["step_ms"] for r in ranks],
                              "median_step_ms_after_first_per_rank": [
                                  r[name]["median_step_ms_after_first"] for r in ranks],
                              "one_rank_recipe_step_ms": ref["recipe_step_ms"]}
            if errs[worst] > STEP_RTOL:
                problems.append(f"{name}: the two-rank step differs from the one-rank step "
                                f"({worst}: {errs[worst]})")
            if not readings[name]["ranks_agree"]:
                problems.append(f"{name}: the ranks' losses differ")
        whole_rows = refs["sp"]["logits"]
        shards = torch.cat(sp_logits, 1)
        logit_err = rel_err(shards, whole_rows)
        readings["sp"]["logits_rows_bit_identical"] = torch.equal(shards, whole_rows)
        readings["sp"]["logits_rows_rel_err"] = logit_err
        if logit_err > KERNEL_RTOL:
            problems.append(f"sp: the shards' logits differ by {logit_err}")
        launches = {k: sum(r["sp"]["mask_launches"][k] for r in ranks)
                    for k in ranks[0]["sp"]["mask_launches"]}
        per = train_launches_per_call(layouts["sp"].arch)
        for r in ranks:
            for k, v in r["sp"]["mask_launches"].items():
                if v != per[k.replace("_mask", "")] * PAR_STEPS:
                    problems.append(f"sp: {k} launched {v} times in {PAR_STEPS} steps on a rank")
        if not (all(r["guard_passed"] for r in ranks)
                and ranks[0]["checksum"] == ranks[1]["checksum"]):
            problems.append("the guard's checksums differ")
        run = ranks[0]["run"]
        s = layouts["tp"].arch.skip_channels
        if not (run["step"] == 3 and run["ckpt_steps"][-1] == 3
                and run["ckpt_shapes"]["post.w1"] == [s, s]
                and run["ckpt_shapes"]["layers.w_skip"][-1] == s
                and run["w_skip_local"][-1] == s // 2):
            problems.append(f"model-sharded checkpoint / resume: {run}")
        if not all(r["dp_loader"]["inputs_targets_mask_equal"]
                   and r["dp_loader"]["mel_max_abs_diff"] < 1e-3 for r in ranks):
            problems.append(f"dp: a rank's loader rows differ: {[r['dp_loader'] for r in ranks]}")
        if not ([r["backend"] for r in ranks] == ["gloo", "gloo"]
                and [r["device"] for r in ranks] == ["cuda:0", "cuda:0"]):
            problems.append("the two ranks did not share cuda:0 over gloo")

        # The CLI: sequence-parallel training under torchrun, then eval.
        arch = layouts["sp"].arch
        wavs = os.path.join(work, "wavs")
        os.makedirs(wavs)
        rng = np.random.default_rng(9)
        for i in range(3):
            t = np.arange(3 * arch.sample_rate) / arch.sample_rate
            write_wav(os.path.join(wavs, f"w{i}.wav"),
                      (0.4 * np.sin(2 * np.pi * (150 + 60 * i) * t)
                       + 0.03 * rng.standard_normal(t.size)).astype(np.float32),
                      arch.sample_rate)
        ckpt = os.path.join(work, "ckpt_cli")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "lb_wavenet_tpu_torch.cli", "train",
               "--config", MEL_CONFIG, "--set", "train.seq_parallel=true",
               "--set", f"train.data_dir={wavs}", "--set", f"train.checkpoint_dir={ckpt}",
               "--set", "train.n_steps=2", "--set", "train.log_every=1"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=600)
        cli_s = time.perf_counter() - t0
        summary, losses, metrics = None, [], None
        lines = proc.stdout.strip().splitlines()
        if proc.returncode:
            problems.append(f"torchrun cli train failed:\n{proc.stderr[-4000:]}")
        else:
            summary = json.loads(lines[-1])
            losses = [json.loads(ln)["loss"] for ln in lines[:-1] if '"loss"' in ln]
        if summary != {"trained_to_step": 2, "seq_parallel": True,
                       "mesh": {"data": 2, "model": 1, "backend": "gloo"}} or not (
                len(losses) == 2 and all(np.isfinite(losses))):
            problems.append(f"torchrun cli train: {summary}, losses {losses}")
        ev = subprocess.run([sys.executable, "-m", "lb_wavenet_tpu_torch.cli", "eval",
                             "--config", MEL_CONFIG, "--data-dir", wavs,
                             "--set", f"gen.checkpoint_dir={ckpt}",
                             "--set", "train.eval_batches=1"],
                            capture_output=True, text=True, cwd=ROOT, timeout=600)
        if ev.returncode:
            problems.append(f"cli eval failed:\n{ev.stderr[-4000:]}")
        else:
            metrics = json.loads(ev.stdout.strip().splitlines()[-1])
            if not 0 < metrics["nll"] < 10:
                problems.append(f"cli eval metrics: {metrics}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({
        "phase": "parallel_training", "gpu": gpu, "ranks": 2,
        "backends": [r["backend"] for r in ranks], "devices": [r["device"] for r in ranks],
        "note": "two ranks sharing one card, every collective staged through host memory "
                "over gloo: a correctness path, not a multi-card figure",
        "dp": {"config": "configs/multihost_mel.json", "mesh": ranks[0]["dp_mesh"],
               "global_B": layouts["dp"].train.batch_size,
               "loader_per_rank": [r["dp_loader"] for r in ranks],
               "upsampler_rows_B64_vs_B32_max_abs": refs["dp"]["upsampler_rows_B64_vs_B32"],
               "W": layouts["dp"].train.window_size, **readings["dp"],
               "all_reduce_ms_per_rank": [r["dp"]["all_reduce_ms"] for r in ranks],
               "all_reduce_floats": ranks[0]["dp"]["all_reduce_floats"],
               "launches_rank0": ranks[0]["dp"]["launches"],
               "peak_mem_gb_per_rank": [r["dp"]["peak_mem_gb"] for r in ranks]},
        "sp": {"config": "configs/wavenet30_mel.json + train.seq_parallel=true",
               "shard": ranks[0]["sp"]["shard"], **readings["sp"],
               "mask_launches_per_rank": [r["sp"]["mask_launches"] for r in ranks],
               "launches_rank0": ranks[0]["sp"]["launches"]},
        "tp": {"config": "configs/stress_gen.json (train, mesh_model=2)",
               "mesh": ranks[0]["tp_mesh"], "w_skip_local": ranks[0]["tp_w_skip_local"],
               **readings["tp"],
               "hidden_all_reduce_ms_per_rank": [r["tp"]["hidden_all_reduce_ms"]
                                                 for r in ranks],
               "launches_rank0": ranks[0]["tp"]["launches"]},
        "guard_checksums": [r["checksum"] for r in ranks], "checkpoint": ranks[0]["run"],
        "rtol": STEP_RTOL, "one_rank_refs_s": ref_s, "spawn_s": spawn_s,
        "torchrun_cli_train": {"s": cli_s, "summary": summary, "losses": losses},
        "cli_eval": metrics, "problems": problems,
    }))
    require(not problems, "; ".join(problems))
    return launches, readings


def leaf_errs_np(got, want, prefix=""):
    """{path: max |got - want| / max |want|} over two nested dicts / lists of
    numpy arrays."""
    import numpy as np

    if isinstance(want, dict):
        out = {}
        for k in sorted(want):
            out.update(leaf_errs_np(got[k], want[k], f"{prefix}{k}."))
        return out
    if isinstance(want, (list, tuple)):
        out = {}
        for i, v in enumerate(want):
            out.update(leaf_errs_np(got[i], v, f"{prefix}{i}."))
        return out
    scale = float(np.abs(want).max()) or 1.0
    return {prefix[:-1]: float(np.abs(np.asarray(got) - want).max()) / scale}


# ---- mega's on-chip ring layout (B2v), serving artifacts, HTTP -------------

VMEM_DS = (2, 4, 8)     # WAVENET_MEGA_VMEM_D values held against D = 1
VMEM_TOO_BIG = 16       # leaves WaveNet-30's tensor-core kernel under 2 weight slots
VMEM_PLAIN_T = 128      # teacher-forced steps of the D = 4 kernel-vs-plain check
VMEM_MEL_T = 256        # steps of the conditioned and CUDA-core D = 4 checks
SERVED = {}             # engine -> (requests, {id: classes}) of the in-process pools
HTTP_POOL = 64          # the --listen pool (configs/wavenet30.json gen.batch_size)
ART_TP_CHUNK = 64       # steps per chunk of the sharded artifact check


@contextlib.contextmanager
def vmem_d(d: int):
    """WAVENET_MEGA_VMEM_D=d for the block (generate_classes reads it per call)."""
    old = os.environ.get("WAVENET_MEGA_VMEM_D")
    os.environ["WAVENET_MEGA_VMEM_D"] = str(d)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("WAVENET_MEGA_VMEM_D")
        else:
            os.environ["WAVENET_MEGA_VMEM_D"] = old


def vmem_one_shot(params, arch, b: int, t: int, d: int, cond=None):
    """One-shot mega through generate_classes at WAVENET_MEGA_VMEM_D=d:
    (teacher-forced classes, logits) on random classes, and free-running
    sampled classes (per-lane hash), from fixed seeds."""
    import torch

    from lb_wavenet_tpu_torch import generate as G

    gen = torch.Generator(device="cuda").manual_seed(31)
    forced = torch.randint(0, arch.quant_channels, (b, t), device="cuda", dtype=torch.int32,
                           generator=gen)
    with vmem_d(d):
        cls, logits = G.generate_classes(params, arch, 9, b, t, cond=cond, forced=forced,
                                         temperature=1.0, return_logits=True, engine="mega")
        free = G.generate_classes(params, arch, 9, b, t, cond=cond, temperature=1.0,
                                  engine="mega")
    torch.cuda.synchronize()
    return cls, logits, free


def phase_mega_vmem(params, arch, gpu):
    """B2v, mega's on-chip ring layout: one-shot mega through generate_classes
    at D = 2, 4, 8 on WaveNet-30's tensor-core route (B = 512, CHUNK steps:
    teacher-forced classes and logits, and a sampled free run, bit for bit
    against D = 1), D = 4 against the plain version, D = 4 conditioned
    (wavenet30_mel.json) and on the CUDA-core route (fp32, and bf16 at
    C = 24), the ValueError of a D whose rings leave no room for two weight
    slots, and the timings. Returns the kernels line's row."""
    import dataclasses

    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype, init_params
    from lb_wavenet_tpu_torch.ops.cuda import ar_mega, ar_tc

    require(ar_tc.route(arch, compute_dtype(arch)) == "tensor_cores",
            "WaveNet-30 left the tensor-core route")
    with comparison_launches():
        ref = vmem_one_shot(params, arch, B, CHUNK, 1)
    same = {}
    launches = 0
    for d in VMEM_DS:
        ar_mega.mega_generate.launches = 0     # the main path of this slice: D = 4
        got = vmem_one_shot(params, arch, B, CHUNK, d)
        if d == 4:
            launches = ar_mega.mega_generate.launches
        same[d] = [bool(torch.equal(x, y)) for x, y in zip(got, ref)]
        del got
    log(json.dumps({"phase": "mega_vmem_vs_d1", "gpu": gpu, "B": B, "T": CHUNK,
                    "route": "tensor_cores",
                    "bit_identical_forced_classes_logits_free_classes": same}))
    require(all(all(v) for v in same.values()), f"on-chip rings change mega's output: {same}")
    require(launches == 2, f"generate_classes at D=4 launched mega {launches} times, not 2")
    del ref

    # D = 4 kernel against the plain version, teacher-forced, 3-row lanes.
    h0, e0 = G._fused_frontend_zero(params, arch, B)
    lp = params["layers"]
    gen = torch.Generator(device="cuda").manual_seed(32)
    forced = torch.randint(0, arch.quant_channels, (VMEM_PLAIN_T, B), device="cuda",
                           dtype=torch.int32, generator=gen)
    inv = torch.tensor([0.0, 1 / 0.7, 1.0], device="cuda").repeat(B // 3 + 1)[:B]
    lane = torch.stack([torch.arange(B, device="cuda", dtype=torch.int32) * 7919,
                        torch.zeros(B, device="cuda", dtype=torch.int32),
                        inv.view(torch.int32)])
    with comparison_launches():
        ck, cp = (ar_mega.mega_zero_carry(arch, h0, e0) for _ in range(2))
        kc, kl = ar_mega.mega_generate_cuda(params, lp, arch, ck, 0, forced, 1.0, True, lane,
                                            5, vmem_d=4)
        pc, pl = ar_mega.mega_generate_plain(params, lp, arch, cp, 0, forced, 1.0, True, lane,
                                             5, vmem_d=4)
        torch.cuda.synchronize()
    plain_err = abs_err(kl, pl)
    log(json.dumps({"phase": "mega_vmem_vs_plain", "gpu": gpu, "D": 4, "B": B,
                    "T": VMEM_PLAIN_T, "lane_rows": 3, "max_abs_logit_err": plain_err,
                    "classes_equal": bool(torch.equal(kc, pc)),
                    "h_s_equal": bool(torch.equal(ck["h_s"], cp["h_s"]))}))
    require(plain_err == 0.0 and torch.equal(kc, pc),
            f"mega at D=4 differs from the plain version: {plain_err}")
    del ck, cp, kl, pl

    # Conditioned (mel, B = 64) and the CUDA-core route (fp32; bf16 C = 24).
    mel_arch, mel_params = mel_setup()
    cond = torch.randn((MEL_B, VMEM_MEL_T, mel_arch.cond_channels), device="cuda",
                       generator=gen).to(compute_dtype(mel_arch))
    cases = {"cond_mel": (mel_params, mel_arch, cond)}
    for tag, a in (("cuda_core_fp32", dataclasses.replace(arch, compute_dtype="float32")),
                   ("cuda_core_bf16_C24", dataclasses.replace(arch, residual_channels=24))):
        require(ar_tc.route(a, compute_dtype(a)) == "cuda_cores", f"{tag} left its route")
        cases[tag] = (init_params(33, a, "cuda"), a, None)
    other = {}
    with comparison_launches():
        for tag, (p, a, cnd) in cases.items():
            want = vmem_one_shot(p, a, MEL_B, VMEM_MEL_T, 1, cnd)
            got = vmem_one_shot(p, a, MEL_B, VMEM_MEL_T, 4, cnd)
            other[tag] = all(bool(torch.equal(x, y)) for x, y in zip(got, want))
    log(json.dumps({"phase": "mega_vmem_other_routes", "gpu": gpu, "D": 4, "B": MEL_B,
                    "T": VMEM_MEL_T, "bit_identical_to_d1": other}))
    require(all(other.values()), f"on-chip rings change mega's output: {other}")

    # A D whose rings leave the tensor-core kernel under two weight slots.
    try:
        with vmem_d(VMEM_TOO_BIG), comparison_launches():
            G.generate_classes(params, arch, 9, B, 8, temperature=0.0, engine="mega")
        refused = None
    except ValueError as e:
        refused = str(e)
    log(json.dumps({"phase": "mega_vmem_refused", "D": VMEM_TOO_BIG, "error": refused}))
    require(refused is not None and "bytes" in refused,
            f"WAVENET_MEGA_VMEM_D={VMEM_TOO_BIG} was not refused with the bytes: {refused}")

    # Timing: ms per CHUNK-step launch at B, each D beside D = 1 in turns.
    carry = ar_mega.mega_zero_carry(arch, h0, e0)
    free = torch.full((CHUNK, B), -1, device="cuda", dtype=torch.int32)
    ms = {d: [] for d in (1, *VMEM_DS)}
    smem = {}
    with comparison_launches():
        for _ in range(2):
            for d in (1, *VMEM_DS):
                ms[d].append(cuda_ms(lambda: ar_mega.mega_generate_cuda(
                    params, lp, arch, carry, 0, free, 1.0, False, lane, 0, vmem_d=d), 2))
                smem[d] = tc_smem()["mega_tc_kernel"]
    c = arch.residual_channels
    fixed = smem[1] - 6 * 32768          # activations at D = 1 (six weight slots)
    rows = {d: ar_mega.vmem_rows(arch.dilations, d) for d in (1, *VMEM_DS)}
    per_d = {f"D={d}": {"ms": sum(v) / len(v), "ms_runs": v, "dynamic_smem_bytes": smem[d],
                        "on_chip_ring_rows": rows[d],
                        "weight_slots": (smem[d] - fixed - rows[d] * c * 8 * 4) // 32768}
             for d, v in ms.items()}
    wbytes = torch.finfo(compute_dtype(arch)).bits // 8
    bms, by = bound_ms(*mega_cost(arch, B, CHUNK, 3, wbytes))
    log(json.dumps({"phase": "mega_vmem_timing", "gpu": gpu, "B": B, "T": CHUNK,
                    "lane_rows": 3, "by_d": per_d, "bound_ms": bms, "bound_by": by,
                    "ptxas": {k: v for k, v in tc_ptxas().items() if "mega" in k}}))
    return {"name": "mega_generate_vmem", "route": "cuda",
            "source": "lb_wavenet_tpu_torch/csrc/ar_mega.cu",
            "replaces": "lb_wavenet_tpu/ops/pallas/ar_mega.py:101",
            "launches": launches, "max_abs_err": plain_err,
            "ms": per_d["D=4"]["ms"], "plain_ms": None, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "unit": f"ms per launch ({CHUNK} steps, B={B}, WAVENET_MEGA_VMEM_D=4)",
            "ms_d1_same_call": per_d["D=1"]["ms"]}


def _artifact_pool_script(work: str) -> str:
    """A fresh interpreter's program: load the params and the per-lane
    artifacts, serve the in-process pools' requests through SessionPool
    (artifact=...), time chunks, and save what it saw."""
    return f"""
import json, sys, time
import numpy as np, torch
from lb_wavenet_tpu_torch.serving import SessionPool
from lb_wavenet_tpu_torch.utils.export import load_serving
from lb_wavenet_tpu_torch.server import kernel_launches
work = {work!r}
params = torch.load(work + "/params.pt")
spec = json.load(open(work + "/spec.json"))
res = {{}}
for name, s in spec.items():
    art = load_serving(work + "/" + name)
    pool = SessionPool(params, art.arch, s["batch"], 0, artifact=art, temperature=1.0,
                       pipeline=True, device="cuda")
    before = kernel_launches()
    queue, out, parts = list(s["requests"]), {{}}, {{}}
    def submit(r):
        assert pool.submit(r["id"], r["n_samples"], seed=r["seed"], temperature=r["temperature"])
        parts[r["id"]] = []
    for r in queue[: s["first_wave"]]:
        submit(r)
    queue = queue[s["first_wave"]:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pool.active or queue:
        for rid, (c, done) in pool.step().items():
            parts[rid].append(c)
            if done:
                out[rid] = np.concatenate(parts.pop(rid))
                if queue:
                    submit(queue.pop(0))
    wall = time.perf_counter() - t0
    after = kernel_launches()
    np.savez(work + "/" + name + "_out.npz", **out)
    # ms per chunk through the artifact, and the ring not copied per call.
    st = art.init(params, 1)
    lane = torch.stack([torch.arange(s["batch"], dtype=torch.int32) * 7919,
                        torch.zeros(s["batch"], dtype=torch.int32),
                        torch.full((s["batch"],), 1 / 0.7).view(torch.int32)]).cuda()
    ptr = st["bufs"].data_ptr()
    art.step(params, st, lane=lane)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ts = []
    for _ in range(3):
        t1 = time.perf_counter()
        _, st = art.step(params, st, lane=lane)
        torch.cuda.synchronize()
        ts.append(1000 * (time.perf_counter() - t1))
    res[name] = {{"launches": {{k: after[k] - before[k] for k in after}}, "wall_s": wall,
                 "steps": pool.stats["steps"], "chunk_ms": ts,
                 "ring_bytes": st["bufs"].numel() * 4, "ring_in_place": st["bufs"].data_ptr() == ptr,
                 "peak_extra_bytes_per_chunk": torch.cuda.max_memory_allocated() - base,
                 "device_kind": art.manifest["device_kind"]}}
res["modules"] = sorted(m for m in sys.modules if m.startswith("lb_wavenet_tpu_torch."))
print(json.dumps(res))
"""


def inprocess_chunk_ms(params, arch, engine: str, b: int) -> list:
    """ms per chunk of stream_chunk on an in-process session at batch b
    with the pool's 3-row lane block (host clock around a synchronised
    call), beside the artifact's."""
    import torch

    from lb_wavenet_tpu_torch import generate as G

    s = G.start_stream(arch, b, 1, engine=engine, params=params)
    kw = dict(lane_seed=torch.arange(b, dtype=torch.int32).cuda() * 7919,
              lane_t0=torch.zeros(b, dtype=torch.int32).cuda(),
              lane_inv_temp=torch.full((b,), 1 / 0.7).cuda())
    with comparison_launches():
        G.stream_chunk(params, arch, s, CHUNK, temperature=1.0, engine=engine, **kw)
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, s = G.stream_chunk(params, arch, s, CHUNK, temperature=1.0, engine=engine, **kw)
            torch.cuda.synchronize()
            out.append(1000 * (time.perf_counter() - t0))
    return out


def phase_export_serving(params, arch, gpu):
    """Serving artifacts: a mega (per-lane, B = 512, CHUNK; by `cli export`)
    and a turbo (per-lane, TURBO_POOL) artifact, loaded by a fresh
    interpreter that serves the serving phases' requests through
    SessionPool(artifact=...): the audio equals the in-process pools' bit
    for bit, that process's launch counters show the hand-written kernels,
    and its ms per chunk stands beside the in-process chunk. Then a
    model-sharded artifact on one NCCL rank at the stress config against
    ShardedSession."""
    import numpy as np
    import torch

    from lb_wavenet_tpu_torch.ops.cuda.build import BUILD
    from lb_wavenet_tpu_torch.utils.export import export_serving

    work = os.path.join(BUILD, "chip_smoke_art")   # gitignored, removed below
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run([
            sys.executable, "-m", "lb_wavenet_tpu_torch.cli", "export",
            "--config", os.path.join(ROOT, "configs", "wavenet30.json"),
            "--out", os.path.join(work, "mega"), "--engine", "mega", "--batch", str(B),
            "--chunk", str(CHUNK), "--per-lane", "--set", "gen.temperature=1.0"],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        require(proc.returncode == 0, f"cli export failed:\n{proc.stderr[-4000:]}")
        t1 = time.perf_counter()
        export_serving(params, arch, TURBO_POOL, CHUNK, os.path.join(work, "turbo"),
                       engine="turbo", temperature=1.0, per_lane=True)
        t2 = time.perf_counter()
        torch.save({k: v for k, v in params.items()}, os.path.join(work, "params.pt"))
        spec = {"mega": {"batch": B, "first_wave": 8, "requests": SERVED["mega"][0]},
                "turbo": {"batch": TURBO_POOL, "first_wave": 4,
                          "requests": SERVED["turbo"][0]}}
        with open(os.path.join(work, "spec.json"), "w") as f:
            json.dump(spec, f)
        proc = subprocess.run([sys.executable, "-c", _artifact_pool_script(work)],
                              capture_output=True, text=True, cwd=ROOT, timeout=900)
        require(proc.returncode == 0, f"artifact pool process failed:\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        mods = [m for m in res.pop("modules")
                if m.startswith(("lb_wavenet_tpu_torch.models", "lb_wavenet_tpu_torch.generate"))]
        require(not mods, f"the artifact process imported model code: {mods}")
        equal = {}
        for name, (requests, want) in SERVED.items():
            got = np.load(os.path.join(work, f"{name}_out.npz"))
            equal[name] = all(np.array_equal(got[r["id"]], want[r["id"]]) for r in requests)
        inproc = {"mega": inprocess_chunk_ms(params, arch, "mega", B),
                  "turbo": inprocess_chunk_ms(params, arch, "turbo", TURBO_POOL)}
        log(json.dumps({
            "phase": "export_serving", "gpu": gpu, "export_s": {"mega_cli": t1 - t0,
                                                                "turbo": t2 - t1},
            "audio_equal_to_in_process_pool": equal,
            "artifact": res, "in_process_chunk_ms": inproc, "chunk": CHUNK,
            "batch": {"mega": B, "turbo": TURBO_POOL}}))
        require(all(equal.values()), f"artifact pools' audio differs: {equal}")
        require(res["mega"]["launches"]["mega_generate"] == res["mega"]["steps"],
                f"the mega artifact pool launched mega {res['mega']['launches']}")
        require(res["turbo"]["launches"]["turbo_step"] == res["turbo"]["steps"] * CHUNK,
                f"the turbo artifact pool launched turbo {res['turbo']['launches']}")
        for name in res:
            require(res[name]["ring_in_place"] and
                    res[name]["peak_extra_bytes_per_chunk"] < res[name]["ring_bytes"] // 4,
                    f"the {name} artifact copies its ring per chunk: {res[name]}")
        sharded = artifact_sharded_1rank(work, gpu)
        return {"mega_generate": res["mega"]["launches"]["mega_generate"],
                "turbo_step": res["turbo"]["launches"]["turbo_step"],
                "tp_fused_stack": sharded}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def artifact_sharded_1rank(work: str, gpu) -> int:
    """A model-sharded turbo artifact of the stress config (B = TP_B) on one
    NCCL rank in this process, against ShardedSession chunk for chunk with
    a lane reset; returns B7's launches through the artifact."""
    import torch

    from lb_wavenet_tpu_torch.ops.cuda import ar_tp
    from lb_wavenet_tpu_torch.parallel.mesh import make_mesh
    from lb_wavenet_tpu_torch.parallel.synthesis import ShardedSession
    from lb_wavenet_tpu_torch.utils.export import export_sharded_serving, load_serving
    from lb_wavenet_tpu_torch.utils.multihost import init_distributed, shutdown

    arch, params = tp_setup()
    art_dir = os.path.join(work, "sharded")
    export_sharded_serving(params, arch, TP_B, ART_TP_CHUNK, art_dir, engine="turbo",
                           temperature=1.0, mesh_data=1, mesh_model=1)
    mask = torch.zeros(TP_B, dtype=torch.bool)
    mask[1::7] = True
    try:
        init_distributed(device="cuda", init_method=f"file://{work}/store", rank=0,
                         world_size=1)
        mesh = make_mesh(1, 1)
        art = load_serving(art_dir)
        placed = art.place_params(params)
        state = art.init(placed, TP_SEED)
        ar_tp.tp_fused_stack.launches = 0
        got = []
        for i in range(3):
            cls, state = art.step(placed, state)
            got.append(cls)
            if i == 0:
                state = art.reset(placed, state, mask)
        torch.cuda.synchronize()
        launches = ar_tp.tp_fused_stack.launches
        with comparison_launches():
            sess = ShardedSession(params, arch, TP_B, TP_SEED, mesh, engine="turbo")
            want = []
            for i in range(3):
                want.append(sess.chunk(ART_TP_CHUNK, temperature=1.0))
                if i == 0:
                    sess.reset_lanes(mask)
        same = bool(torch.equal(torch.cat(got, 1), torch.cat(want, 1)))
        log(json.dumps({"phase": "export_sharded_1rank", "gpu": gpu,
                        "config": "configs/stress_gen.json", "B": TP_B,
                        "steps": 3 * ART_TP_CHUNK, "backend": mesh.backend,
                        "bit_identical_to_sharded_session": same,
                        "tp_fused_stack_launches": launches}))
        require(same, "the sharded artifact differs from ShardedSession")
        require(launches == 3 * ART_TP_CHUNK, f"B7 launched {launches} times")
        return launches
    finally:
        shutdown()


def _post(url: str, payload: dict):
    import urllib.request

    req = urllib.request.Request(url + "/synthesize", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
    return body, time.perf_counter() - t0


def http_round(cmd, requests, work, tag):
    """Start `cli serve --listen` (cmd), send the requests concurrently,
    read /healthz, stop the server. Returns ({id: classes}, {id: latency s},
    healthz)."""
    import threading
    import urllib.request

    import numpy as np

    log_path = os.path.join(work, f"{tag}.log")
    with open(log_path, "w") as errf:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=errf, text=True, cwd=ROOT)
    try:
        import select

        ready, _, _ = select.select([proc.stdout], [], [], 300)
        line = proc.stdout.readline() if ready else ""
        require(line.strip().startswith("{"),
                f"{tag}: the server did not start:\n{open(log_path).read()[-4000:]}")
        url = "http://" + json.loads(line)["listening"]
        out, lat, errors = {}, {}, []

        def go(r):
            try:
                body, s = _post(url, {"n_samples": r["n_samples"], "seed": r["seed"],
                                      "temperature": r["temperature"], "format": "classes"})
                out[r["id"]] = np.asarray(body["classes"], np.int32)
                lat[r["id"]] = s
            except Exception as e:  # noqa: BLE001 (reported below)
                errors.append(f"{r['id']}: {e}")

        threads = [threading.Thread(target=go, args=(r,)) for r in requests]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        require(not errors and len(out) == len(requests), f"{tag}: {errors}")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        return out, lat, health
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def phase_http_serving(params, arch, gpu):
    """`cli serve --listen` on a mega pool of HTTP_POOL, from the checkpoint
    and from a per-lane artifact: 8 concurrent POSTs with seeds and
    temperatures {0, 0.7, 1.0}, each response equal to a dedicated session
    (a pool of one), /healthz with the server's kernel launches, and the
    request latencies."""
    import numpy as np

    from lb_wavenet_tpu_torch.ops.cuda.build import BUILD
    from lb_wavenet_tpu_torch.utils.checkpoint import save_params
    from lb_wavenet_tpu_torch.utils.export import export_serving

    requests = [{"id": f"h{i}", "n_samples": 4000 + 1237 * i, "seed": 300 + 11 * i,
                 "temperature": (0.0, 0.7, 1.0)[i % 3]} for i in range(8)]
    work = os.path.join(BUILD, "chip_smoke_http")   # gitignored, removed below
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        save_params(os.path.join(work, "ckpt"), params, 0)
        export_serving(params, arch, HTTP_POOL, CHUNK, os.path.join(work, "art"),
                       engine="mega", temperature=1.0, per_lane=True)
        base = [sys.executable, "-m", "lb_wavenet_tpu_torch.cli", "serve",
                "--config", os.path.join(ROOT, "configs", "wavenet30.json"),
                "--listen", "127.0.0.1:0", "--stream-chunk", str(CHUNK),
                "--set", f"gen.checkpoint_dir={os.path.join(work, 'ckpt')}",
                "--set", f"gen.batch_size={HTTP_POOL}", "--set", "gen.temperature=1.0",
                "--set", "gen.engine=mega"]
        with comparison_launches():
            want = {r["id"]: serve_pool(params, arch, [r], 1, first_wave=1)[0][r["id"]]
                    for r in requests}
        report = {}
        for tag, cmd in (("params", base),
                         ("artifact", base + ["--artifact", os.path.join(work, "art")])):
            out, lat, health = http_round(cmd, requests, work, tag)
            equal = all(np.array_equal(out[r["id"]], want[r["id"]]) for r in requests)
            ms = sorted(1000 * v for v in lat.values())
            report[tag] = {"equal_to_dedicated_sessions": equal,
                           "latency_ms": {"p50": float(np.percentile(ms, 50)),
                                          "p95": float(np.percentile(ms, 95)),
                                          "max": ms[-1], "all": ms},
                           "healthz": health}
            require(equal, f"HTTP ({tag}) responses differ from dedicated sessions")
            require(health["ok"] and health["kernel_launches"]["mega_generate"] > 0,
                    f"HTTP ({tag}): the server never launched the mega kernel: {health}")
        total = sum(r["n_samples"] for r in requests)
        log(json.dumps({"phase": "http_serving", "gpu": gpu, "pool_batch": HTTP_POOL,
                        "chunk": CHUNK, "requests": len(requests), "concurrent": True,
                        "audio_sec": total / arch.sample_rate, **report}))
        return report["params"]["healthz"]["kernel_launches"]["mega_generate"]
    finally:
        shutil.rmtree(work, ignore_errors=True)


MOL_CONFIG = os.path.join(ROOT, "lb_wavenet_tpu_torch", "configs", "tacotron2_mol.json")
MOL_B, MOL_W = 8, 7200      # the config's recipe
# Generated samples: 1 s at 24 kHz. The xla engine is launch-bound at ~21 ms
# a step on an H100 (~1,250 launches a step, measured on one H100), so this
# phase takes ~8.5 min.
MOL_GEN = 24000
MOL_TAIL = 64               # generated steps held to the teacher-forced forward
# The generated steps' head outputs against the teacher-forced forward: one
# lane's step products sum in another order than the whole sequence's, and
# bf16 rounding flips carry through 30 layers.
MOL_GEN_ATOL = 0.1


def phase_mol(gpu):
    """The mol section (phase 12b): the head pair against its plain versions
    on both routes, one train step, MOL_GEN steps of xla-engine generation;
    returns the kernels line's rows of the pair."""
    import math

    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.models.conditioning import upsample_cond
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype, forward, init_params
    from lb_wavenet_tpu_torch.ops import mol
    from lb_wavenet_tpu_torch.ops.cuda import post_mol as PM
    from lb_wavenet_tpu_torch.utils.profiling import mol_post_cost

    cfg = Config.load(MOL_CONFIG)
    arch, train = cfg.arch, cfg.train
    t = arch.receptive_field - 1 + MOL_W
    g = torch.Generator(device="cuda").manual_seed(11)
    params = init_params(5, arch, "cuda")
    skip = torch.randn((MOL_B, t, arch.skip_channels), device="cuda", generator=g)
    tgt = mol.to_grid(0.5 * torch.randn((MOL_B, MOL_W), device="cuda", generator=g))
    tgt[:, :8] = -1.0
    mask = (torch.rand((MOL_B, MOL_W), device="cuda", generator=g) > 0.05).float()
    gbar = torch.tensor(1.0 / MOL_W, device="cuda")
    head = params["mol"]
    errs, rows = {}, []
    for dt in (torch.bfloat16, torch.float32):
        num = PM.post_mol_fwd(head, skip, tgt, mask, MOL_W, dt)
        want = PM.post_mol_plain(head, skip, tgt, mask, MOL_W, dt)
        dskip, grads = PM.post_mol_bwd(head, skip, tgt, mask, MOL_W, dt, gbar)
        w_dskip, w_grads = PM.post_mol_bwd_plain(head, skip, tgt, mask, MOL_W, dt, gbar)
        torch.cuda.synchronize()
        e = {"num": rel_err(num, want), "dskip": rel_err(dskip, w_dskip),
             **{f"d{k}": rel_err(grads[k], w_grads[k]) for k in grads}}
        # KERNEL_RTOL, the other training pairs': the products sum in the same
        # order (tc_mm on the tensor cores), but dy differs by the NLL's
        # transcendentals (expf, log1pf: ulps), and rounding dy to bf16 for
        # the dskip and dw products turns some of them into a bf16 ulp
        # (dskip read 6.9e-4, measured on one H100).
        require(all(v <= KERNEL_RTOL for v in e.values()), f"MoL head pair vs plain ({dt}): {e}")
        require(float(dskip[:, : t - MOL_W].abs().max()) == 0.0, "MoL head rows of dskip not 0")
        errs[str(dt)] = e
    dt = compute_dtype(arch)
    launches0 = PM.post_mol_fwd.launches, PM.post_mol_bwd.launches
    ms_f = cuda_ms(lambda: PM.post_mol_fwd(head, skip, tgt, mask, MOL_W, dt), 20)
    ms_b = cuda_ms(lambda: PM.post_mol_bwd(head, skip, tgt, mask, MOL_W, dt, gbar), 20)
    plain_f = cuda_ms(lambda: PM.post_mol_plain(head, skip, tgt, mask, MOL_W, dt), 2)
    plain_b = cuda_ms(lambda: PM.post_mol_bwd_plain(head, skip, tgt, mask, MOL_W, dt, gbar), 2)
    PM.post_mol_fwd.launches, PM.post_mol_bwd.launches = launches0
    # One training step through train_step on a batch of 16-bit samples.
    x = mol.to_grid(0.3 * torch.randn((MOL_B, t), device="cuda", generator=g))
    frames = torch.randn((MOL_B, -(-t // arch.hop_size), arch.n_mels), device="cuda", generator=g)
    batch = {"inputs": x, "targets": torch.cat([x[:, 1:], x[:, -1:]], 1)[:, -MOL_W:],
             "mask": torch.ones((MOL_B, MOL_W), device="cuda"), "mel": frames}
    state = PT.TrainState(params, PT.make_optimizer(train).init(params), 0)
    before = PM.post_mol_fwd.launches, PM.post_mol_bwd.launches
    t0 = time.perf_counter()
    state, loss = PT.train_step(state, batch, arch, train)
    loss = float(loss)
    step_s = time.perf_counter() - t0
    step_launches = (PM.post_mol_fwd.launches - before[0], PM.post_mol_bwd.launches - before[1])
    require(math.isfinite(loss) and step_launches == (2, 2),
            f"mol train step: loss {loss}, head launches {step_launches}")
    # MOL_GEN steps of xla-engine generation, one lane, on random frames.
    gen_frames = torch.randn((1, -(-MOL_GEN // arch.hop_size), arch.n_mels), device="cuda",
                             generator=g)
    cond = upsample_cond(params["upsampler"], arch, gen_frames, dt)
    t0 = time.perf_counter()
    samples, y = G.generate_classes(params, arch, 3, 1, MOL_GEN, cond=cond, return_logits=True,
                                    engine="xla", device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    require(bool(torch.isfinite(samples).all()) and float(samples.abs().max()) <= 1.0,
            "mol generation left [-1, 1]")
    lo = MOL_GEN - MOL_TAIL - arch.receptive_field
    prev = torch.cat([torch.zeros_like(samples[:, :1]), samples[:, :-1]], 1)[:, lo:]
    want = forward(params, arch, prev, cond=cond[:, lo:MOL_GEN])[:, -MOL_TAIL:]
    gen_err = float((y[:, -MOL_TAIL:] - want).abs().max())
    require(gen_err <= MOL_GEN_ATOL, f"mol generation's head outputs vs forward: {gen_err}")
    log(json.dumps({"phase": "mol", "gpu": gpu, "config": MOL_CONFIG, "pair_vs_plain": errs,
                    "train_step_loss": loss, "train_step_s": step_s,
                    "head_launches_per_step": step_launches, "gen_samples": MOL_GEN,
                    "gen_s": gen_s, "gen_ms_per_step": 1e3 * gen_s / MOL_GEN,
                    "gen_tail_max_abs_err": gen_err}))
    for name, ms, plain, bwd in (("post_mol_fwd", ms_f, plain_f, False),
                                 ("post_mol_bwd", ms_b, plain_b, True)):
        bms, by = bound_ms(*mol_post_cost(arch, MOL_B, t, MOL_W, bwd))
        rows.append({
            "name": name, "route": "cuda", "source": "lb_wavenet_tpu_torch/csrc/post_mol.cu",
            "replaces": "none (the JAX package has no mixture output)",
            "launches": step_launches[int(bwd)], "max_abs_err": errs[str(dt)],
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": None,
            "unit": f"ms per call of 2 launches (B={MOL_B}, W={MOL_W}, T={t}, S=256, 3M=30)",
            "launches_per_call": 2, "kernel_route": PM.route(arch.skip_channels, arch.n_mix, dt),
            "config": "lb_wavenet_tpu_torch/configs/tacotron2_mol.json"})
    return rows


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
        vmem_row = timed("mega_vmem", phase_mega_vmem, params, arch, gpu)
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
        art_launches = timed("export_serving", phase_export_serving, params, arch, gpu)
        http_launches = timed("http_serving", phase_http_serving, params, arch, gpu)
        log(json.dumps({"phase": "artifact_and_http_launches", "artifact_process":
                        art_launches, "http_server_mega_generate": http_launches}))
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
        cond_stack = timed("cond_train_kernels", phase_cond_train_kernels, mel_params, mel_arch,
                           spk_params, gpu)
        cond_launches, mel_trained = timed("mel_training", phase_mel_training, gpu)
        launches.update(cond_launches)
        masked = timed("mask_kernels", phase_mask_kernels, mel_params, mel_arch, gpu)
        mask_launches, _ = timed("parallel_training", phase_parallel_training, gpu)
        train_launches, _ = timed("training", phase_training, arch, gpu)
        launches.update(train_launches)
        timed("pack_training", phase_pack_training, arch, gpu)
        mol_rows = timed("mol", phase_mol, gpu)
        timed("timing", phase_timing, params, arch, errs, launches, gpu,
              (tp_arch, tp_params, tp_measured), (mel_params, mel_arch, mel_measured),
              (mel_arch, cond_stack, mel_trained),
              [*mask_rows(mel_arch, masked, mask_launches), vmem_row, *mol_rows])
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
