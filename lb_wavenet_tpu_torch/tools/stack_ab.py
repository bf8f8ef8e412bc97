#!/usr/bin/env python3
"""Time the training-stack kernel pair (B3) of one checkout of the
repository on the card, for A/B comparisons of two commits in one call:

    python3 lb_wavenet_tpu_torch/tools/stack_ab.py --root <checkout> [--tag NAME]

Run it as a file, once per checkout (e.g. parent, change, change, parent).
It imports `lb_wavenet_tpu_torch` and `chip_smoke.py` from --root, builds
that tree's kernels into its own build directory, and prints one JSON line:
the forward and backward (ms per call, CUDA events, 10 calls) at the
WaveNet-30 training shape (B=8, W=10240, tapcat), and, where the tree has
the conditioned pair (chip_smoke.py `cond_stack_case`), the conditioned
pair at the mel recipe's shape (B=8, W=6144, Cc'=64) beside the
unconditioned backward at that shape; where it has the masked pair
(chip_smoke.py `mask_case`), the masked conditioned pair at one
sequence-parallel shard (B=8, T_ext = R - 1 + T_l, the first R - 1 rows
masked) beside the same pair unmasked; and the card's name and power
limit."""
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
        print("stack_ab: needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.ops.cuda import build
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    arch = Config.load(os.path.join(root, "configs", "wavenet30.json")).arch
    lp = params_from_jax(CS.numpy_params(arch, 0), device="cuda")["layers"]
    dt, dils = torch.bfloat16, arch.dilations
    out = {"tag": args.tag, "gpu": CS.gpu_line()}
    h0, g = CS.train_inputs(arch, 13)
    _, z, x = TS.train_stack_fwd(lp, h0, dils, dt, True)
    out["fwd_uncond_ms"] = CS.cuda_ms(lambda: TS.train_stack_fwd(lp, h0, dils, dt, True), 10)
    out["bwd_uncond_ms"] = CS.cuda_ms(lambda: TS.train_stack_bwd(lp, dils, dt, True, z, x, g),
                                      10)
    del z, x, h0, g
    if hasattr(CS, "cond_stack_case"):
        march, mp = CS.mel_setup()
        h0, g, cond, mlp = CS.cond_stack_case(march, mp["layers"], 64, 104)
        _, z, x = TS.train_stack_fwd(mlp, h0, dils, dt, True, cond=cond)
        out["fwd_cond_ms"] = CS.cuda_ms(lambda: TS.train_stack_fwd(mlp, h0, dils, dt, True,
                                                                    cond=cond), 10)
        out["bwd_cond_ms"] = CS.cuda_ms(lambda: TS.train_stack_bwd(mlp, dils, dt, True, z, x, g,
                                                                    cond=cond), 10)
        ulp = {k: v for k, v in mlp.items() if k != "w_cond"}
        out["bwd_uncond_mel_shape_ms"] = CS.cuda_ms(lambda: TS.train_stack_bwd(
            ulp, dils, dt, True, z, x, g), 10)
        del z, x, h0, g, cond
    if hasattr(CS, "mask_case"):
        _, _, t = CS.sp_shape(march)
        mask, h0, g, cond, mlp = CS.mask_case(march, mp["layers"], t, 64, 105)
        _, z, x = TS.train_stack_fwd(mlp, h0, dils, dt, True, cond=cond, mask=mask)
        for tag, m in (("mask", mask), ("unmasked_shard", None)):
            out[f"fwd_{tag}_ms"] = CS.cuda_ms(lambda: TS.train_stack_fwd(
                mlp, h0, dils, dt, True, cond=cond, mask=m), 10)
            out[f"bwd_{tag}_ms"] = CS.cuda_ms(lambda: TS.train_stack_bwd(
                mlp, dils, dt, True, z, x, g, cond=cond, mask=m), 10)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
