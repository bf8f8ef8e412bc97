#!/usr/bin/env python3
"""Split the training stack's forward and backward calls into their kernels
on the card, for one checkout of the repository.

    python3 lb_wavenet_tpu_torch/tools/stack_profile.py --root <checkout> [--tag NAME]

Run it as a file, once per checkout (e.g. parent and change in one call):
it imports `lb_wavenet_tpu_torch` and `chip_smoke.py` from --root, builds
that tree's kernels, runs the stack at the training shape of
configs/wavenet30.json (B=8, W=10240, tapcat) under torch.profiler, and
prints one JSON line: device ms per call of each kernel of the forward and
of the backward (mean over CALLS calls), and the union of their spans (a
programmatic dependent launch's span overlaps the launch before it, so
the kernels' times can add up to more), with the card's name and power
limit.

`--variants no_slot_reads,no_wgrad` also times the tensor-core backward of
patched copies of csrc/train_stack.cu (built under the build directory) in
which `bwd_layer_tc` skips a part of its work: the reads of its gradient
slot (each tile then stores its sums over the last one's) or all its
weight-gradient products. Their gradients are wrong; they say what those
parts cost. The patches work on literal source anchors: after an edit of
the kernel the tool may stop and name an anchor it lost.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

CALLS = 3
VARIANTS = {
    "no_slot_reads": ("w[j][h] = first ? make_float2(0.f, 0.f) : *q[j][h];",
                      "w[j][h] = make_float2(0.f, 0.f);"),
    "no_wgrad": ("const bf16* Bm, int lb, int m0, int n0, bool first) {",
                 "const bf16* Bm, int lb, int m0, int n0, bool first) {\n  return;"),
}


def build_variants(build, names) -> dict:
    """{name: CDLL} of patched copies of train_stack.cu, compiled together."""
    work = os.path.join(build.BUILD, "stack_profile")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(build.CSRC, work)
    src = open(os.path.join(work, "train_stack.cu")).read()
    procs = {}
    for name in names:
        anchor, repl = VARIANTS[name]
        if src.count(anchor) != 1:
            raise RuntimeError(f"train_stack.cu changed; the anchor of {name} is gone: {anchor!r}")
        path = os.path.join(work, f"{name}.cu")
        open(path, "w").write(src.replace(anchor, repl))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
    return {n: ctypes.CDLL(os.path.join(work, f"{n}.so")) for n in names}


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_ms(fn, calls: int):
    """({kernel: device ms per call}, ms per call of the union of the
    kernels' spans) of fn under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms, spans = {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = e.name.split("(")[0][:60]
            ms[k] = ms.get(k, 0.0) + e.time_range.elapsed_us() / 1000.0 / calls
            spans.append((e.time_range.start, e.time_range.end))
    return dict(sorted(ms.items(), key=lambda kv: -kv[1])), union_us(spans) / 1000.0 / calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", default="")
    ap.add_argument("--variants", default="", help="comma-separated: " + ", ".join(VARIANTS))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("stack_profile: needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import build
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    arch = Config.load(os.path.join(root, "configs", "wavenet30.json")).arch
    lp = params_from_jax(CS.numpy_params(arch, 0), device="cuda")["layers"]
    dt, dils = compute_dtype(arch), arch.dilations
    h0, g = CS.train_inputs(arch, 13)
    _, z, x = TS.train_stack_fwd(lp, h0, dils, dt, True)
    TS.train_stack_bwd(lp, dils, dt, True, z, x, g)
    torch.cuda.synchronize()
    out = {"tag": args.tag, "root": root, "gpu": CS.gpu_line()}
    for name, fn in (("forward", lambda: TS.train_stack_fwd(lp, h0, dils, dt, True)),
                     ("backward", lambda: TS.train_stack_bwd(lp, dils, dt, True, z, x, g))):
        out[name], out[f"{name}_busy_ms"] = device_ms(fn, CALLS)
        out[f"{name}_device_ms"] = sum(out[name].values())
    names = [v for v in args.variants.split(",") if v]
    real = build.load("train_stack")
    try:
        for name, lib in build_variants(build, names).items():
            build._libs["train_stack"] = lib
            TS.train_stack_bwd(lp, dils, dt, True, z, x, g)
            out[f"backward[{name}]"], out[f"backward[{name}]_busy_ms"] = device_ms(
                lambda: TS.train_stack_bwd(lp, dils, dt, True, z, x, g), CALLS)
    finally:
        build._libs["train_stack"] = real
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
