#!/usr/bin/env python3
"""Time every port kernel of one checkout of the repository on the card,
for A/B comparisons of two commits on the same card in one call.

    python3 lb_wavenet_tpu_torch/tools/kernel_ab.py --root <checkout> [--tag NAME]

Run it as a file, once per checkout (e.g. parent, change, change, parent):
it imports `lb_wavenet_tpu_torch` and `chip_smoke.py` from --root, builds
that tree's kernels into its own build directory, and prints one JSON line:
mega_generate (ms per 1024-step launch) and turbo_step (ms per step) at
B=512 and B=64, fused_stack at B=512 and B=64, tp_fused_stack on the stress
config (S_l = 512 and 256) and the six training kernels (ms per call), all
with CUDA events; the frontend pair again at the training shape on both of
its routes (bf16 and fp32: a call's wall, device and host time) and on the
classes of a corpus batch; the one-rank model-sharded step
split into its parts (chip_smoke.py `tp_step_split`: one NCCL rank, 64
greedy steps after 8 of warm-up); the training step's wall, parts, busy
time and idle share (chip_smoke.py `phase_step_breakdown`, its JSON record);
and the card's name and power limit.
"""
import argparse
import contextlib
import io
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.ops.cuda import ar_step, build
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    arch = Config.load(os.path.join(root, "configs", "wavenet30.json")).arch
    params = params_from_jax(CS.numpy_params(arch, 0), device="cuda")
    lp = params["layers"]
    out = {"tag": args.tag, "root": root, "gpu": CS.gpu_line()}
    for b in (512, 64):
        times = CS.sampling_timings(params, arch, b, plain=False)
        out[f"mega_generate B={b}"] = times["mega"][0]
        out[f"turbo_step B={b}"] = times["turbo"][0]
    g = torch.Generator(device="cuda").manual_seed(3)
    for b in (512, 64):
        ring = torch.randn((sum(arch.dilations), b, arch.residual_channels), device="cuda",
                           generator=g)
        h = torch.randn((b, arch.residual_channels), device="cuda", generator=g)
        out[f"fused_stack B={b}"] = CS.cuda_ms(
            lambda: ar_step.fused_stack(lp, arch, h, ring, 700), 50)
    for name, (ms, _, _) in CS.train_timings(params, arch).items():
        out[name] = ms
    out.update(frontend_times(CS, params, arch, root))
    tp_arch, tp_params = CS.tp_setup()
    for s_l, (ms, _, _) in CS.tp_timings(tp_params, tp_arch).items():
        out[f"tp_fused_stack S_l={s_l}"] = ms
    out["tp_step_split_1rank"] = tp_split(CS, tp_arch, tp_params)
    out["training_step"] = step_breakdown(CS, root)
    print(json.dumps(out), flush=True)
    return 0


def frontend_times(CS, params, arch, root) -> dict:
    """ms per call of the frontend pair at the training shape on the arch's
    dtype (bf16) and on fp32: 50 calls back to back by CUDA events (the wall
    of a call where the host is the slower), the device time of a call
    (torch.profiler, the union of its kernels' spans over 20 calls) and its
    host time (the host clock over 50 calls queued back to back), on
    uniform random classes; and the device time on the classes of a
    training batch of the synthetic corpus (bf16), whose sinusoids repeat
    classes often."""
    import torch

    from lb_wavenet_tpu_torch.ops.cuda import frontend as F

    x, dh = CS.frontend_inputs(arch, 15)
    e, w, b = params["embed"], params["input_conv"]["w"], params["input_conv"]["b"]
    out = {}
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        for pas, fn in (("fwd", lambda: F.frontend_fwd(e, w, b, x, dt)),
                        ("bwd", lambda: F.frontend_bwd(e, w, x, dt, dh))):
            out[f"frontend_{pas} {name}"] = CS.cuda_ms(fn, 50)
            out[f"frontend_{pas} {name} device"] = device_ms(CS, fn, 20)
            out[f"frontend_{pas} {name} host"] = host_ms(fn, 50)
    xc = corpus_classes(CS, root)
    out["frontend_fwd bf16 corpus device"] = device_ms(
        CS, lambda: F.frontend_fwd(e, w, b, xc, torch.bfloat16), 20)
    out["frontend_bwd bf16 corpus device"] = device_ms(
        CS, lambda: F.frontend_bwd(e, w, xc, torch.bfloat16, dh), 20)
    return out


def corpus_classes(CS, root, device="cuda"):
    """The input classes (B, T) of the first training batch of the
    synthetic corpus under configs/wavenet30.json's recipe, on the device."""
    import dataclasses

    import torch

    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.data import make_batches, synthetic_corpus

    cfg = Config.load(os.path.join(root, "configs", "wavenet30.json"))
    train = dataclasses.replace(cfg.train, checkpoint_every=0)
    corpus = synthetic_corpus(cfg.arch, CS.TRAIN_W, n_files=8, file_len=160000, seed=0)
    return torch.from_numpy(next(make_batches(corpus, train)).inputs).to(device)


def host_ms(fn, reps: int) -> float:
    """Host time of one fn() call: reps calls queued back to back, timed on
    the host clock before the card catches up (the queue is far from full)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def device_ms(CS, fn, reps: int) -> float:
    """Device time of one fn() call: the union of its kernels' spans over
    reps calls (torch.profiler; a programmatic dependent launch's span
    overlaps the launch before it), per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    return CS.union_us(spans) / reps / 1e3


def step_breakdown(CS, root) -> dict:
    """The record of chip_smoke.py's training_step_breakdown (the recipe of
    configs/wavenet30.json on a synthetic corpus, as chip_smoke.py trains)."""
    import dataclasses

    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.data import synthetic_corpus

    cfg = Config.load(os.path.join(root, "configs", "wavenet30.json"))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, checkpoint_every=0))
    corpus = synthetic_corpus(cfg.arch, CS.TRAIN_W, n_files=8, file_len=160000, seed=0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        CS.phase_step_breakdown(cfg, corpus, CS.gpu_line())
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return next(r for r in recs if r.get("phase") == "training_step_breakdown")


def tp_split(CS, arch, params) -> dict:
    """chip_smoke.py's tp_step_split of the stress config on one NCCL rank
    (a file:// store under the tree's gitignored build directory)."""
    import shutil

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda.build import BUILD
    from lb_wavenet_tpu_torch.parallel.mesh import make_mesh
    from lb_wavenet_tpu_torch.utils.multihost import init_distributed, shutdown

    work = os.path.join(BUILD, "kernel_ab_tp1")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        init_distributed(device="cuda", init_method=f"file://{work}/store", rank=0,
                         world_size=1)
        fm = G._tp_weights(params, params["layers"], compute_dtype(arch))
        mesh = make_mesh(1, 1)
        CS.tp_step_split(fm, arch, mesh, params, 8)   # warm-up: NCCL's first all-reduce
        return CS.tp_step_split(fm, arch, mesh, params, 64)
    finally:
        shutdown()
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
