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
with CUDA events; the one-rank model-sharded step split into its parts
(chip_smoke.py `tp_step_split`: one NCCL rank, 64 greedy steps after 8 of
warm-up); and the
card's name and power limit.
"""
import argparse
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
    tp_arch, tp_params = CS.tp_setup()
    for s_l, (ms, _, _) in CS.tp_timings(tp_params, tp_arch).items():
        out[f"tp_fused_stack S_l={s_l}"] = ms
    out["tp_step_split_1rank"] = tp_split(CS, tp_arch, tp_params)
    print(json.dumps(out), flush=True)
    return 0


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
