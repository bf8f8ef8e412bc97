#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (`lb_wavenet_tpu_torch`, never JAX) at WaveNet-30 full width
(configs/wavenet30.json: 3x10 dilations, C=G=64, S=Q=256, bf16 compute) with
random weights seeded by numpy, in phases; any failure exits non-zero:

  1. environment: CUDA, the card and its power limit, triton, nvcc; build
     every kernel from lb_wavenet_tpu_torch/csrc with nvcc (sm_90a);
  2. each kernel against its plain PyTorch version on the card at B=512:
     fused_stack (one step at a mid-stream t: ring and skip), mega_generate
     (teacher-forced logits and carry over one 1024-step streaming chunk at
     a mid-stream t0 with a 3-row lane block, as the pool calls it; greedy,
     per-lane 2-row and 3-row lane blocks over 256 steps from the zero
     carry: first divergent step reported, and every class the kernel
     picked must be a near-argmax of the plain version's scores on the
     kernel's own history);
  3. serving: SessionPool(engine="mega", device="cuda"), pool batch 512,
     chunk 1024, pipelined, 12 requests of 8000-24000 samples with seeds and
     temperatures {0, 0.7, 1.0}, the last 4 on recycled lanes; a sampled
     request replayed on a dedicated session must match bit for bit; the
     same requests through `python -m lb_wavenet_tpu_torch.cli serve` from a
     save_params checkpoint must write the same audio;
  4. the pallas engine (fused_stack per step) at B=512;
  5. timings at the serving shapes and the `kernels` JSON line, the card's
     name and power limit, and last the {"ok": true, ...} line.

Launch counts are set to 0 right before each path is driven and read right
after; comparison launches are not counted.
"""
from __future__ import annotations

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
LOGIT_ATOL = 5e-2   # bf16 operands: a flipped rounding moves logits ~1e-2
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak (H100 SXM data sheet)
H100_BYTES_S = 3.35e12    # HBM3 bandwidth (H100 SXM data sheet)


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
    for name in ("ar_step", "ar_mega"):
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


def make_requests():
    """12 requests of 8000-24000 samples, temperatures {0, 0.7, 1.0}."""
    return [
        {"id": f"r{i:02d}", "n_samples": 8000 + (i * 1455) % 16001,
         "seed": 1000 + 17 * i, "temperature": (0.0, 0.7, 1.0)[i % 3]}
        for i in range(12)
    ]


def serve_pool(params, arch, requests, batch, first_wave):
    """Serve `requests` through a pipelined mega SessionPool; the first
    `first_wave` go in at once, the rest as lanes free up (so they take
    recycled lanes). Returns ({id: classes}, {id: lane}, stats, wall)."""
    import numpy as np
    import torch

    from lb_wavenet_tpu_torch.serving import SessionPool

    pool = SessionPool(params, arch, batch, 0, engine="mega", chunk_size=CHUNK,
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
    from lb_wavenet_tpu_torch.utils.checkpoint import save_params

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

    # The same requests through the CLI, from a save_params checkpoint.
    from lb_wavenet_tpu_torch.ops.cuda.build import BUILD

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
            "--set", f"gen.batch_size={B}", "--set", "gen.temperature=1.0",
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                              timeout=600)
        require(proc.returncode == 0, f"CLI serve failed:\n{proc.stderr[-4000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        require(summary["served"] == len(requests), f"CLI served {summary['served']}")
        from scipy.io import wavfile

        from lb_wavenet_tpu_torch.ops.mulaw import mu_law_decode
        import torch

        for r in requests:
            _, wav = wavfile.read(os.path.join(work, "wav", f"{r['id']}.wav"))
            ref = mu_law_decode(torch.from_numpy(out[r["id"]])).numpy()
            ref = (np.clip(ref, -1, 1) * 32767.0).astype(np.int16)
            require(np.array_equal(wav, ref), f"CLI audio of {r['id']} differs")
        summary["gpu"] = gpu
        log(json.dumps({"phase": "cli_serve", "summary": summary,
                        "audio_equal_to_pool": True}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
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


def phase_timing(params, arch, errs, launches, gpu):
    import torch

    from lb_wavenet_tpu_torch.generate import _fused_frontend_zero
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import ar_mega, ar_step

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

    kernels = []
    for name, src, rep, ms, plain, cost in (
        ("mega_generate", "lb_wavenet_tpu_torch/csrc/ar_mega.cu",
         "lb_wavenet_tpu/ops/pallas/ar_mega.py:397", mega_ms, mega_plain,
         mega_cost(arch, B, CHUNK, 3, wbytes)),
        ("fused_stack", "lb_wavenet_tpu_torch/csrc/ar_step.cu",
         "lb_wavenet_tpu/ops/pallas/ar_step.py:105", stack_ms, stack_plain,
         stack_cost(arch, B, wbytes)),
    ):
        bms, by = bound_ms(*cost)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
        })
    log(json.dumps({"phase": "shapes", "gpu": gpu, "mega_generate": {"B": B, "T": CHUNK, "lane_rows": 3},
                    "fused_stack": {"B": B, "steps": 1}}))
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
        launches = {"mega_generate": phase_serving(params, arch, gpu),
                    "fused_stack": phase_pallas_engine(params, arch, gpu)}
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
