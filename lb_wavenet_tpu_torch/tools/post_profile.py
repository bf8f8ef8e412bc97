#!/usr/bin/env python3
"""Split the post-loss pair's calls into their kernels and parts on the
card.

    python3 lb_wavenet_tpu_torch/tools/post_profile.py [--variants a,b] [--phases]

At the training shape of configs/wavenet30.json (B=8, W=10240, T=13310)
and at the stress config's S=512, it times the forward and backward calls
(CUDA events, ms per call) and splits them into their kernels under
torch.profiler (device ms per call), then prints one JSON line with the
card's name and power limit.

`--variants` also times patched copies of csrc/post_loss.cu (built under
the build directory) whose tensor-core kernels skip a part of their work:
`no_stage` (relu(skip) is not read: zeros are staged), `no_copy` (the
producer warp copies no weights: the ring turns over empty), `no_mma` (the
row products' mma are left out; their loads stay). Their results are
wrong; they say what those parts cost. `--phases` stamps clock64 at the
phase boundaries of `fwd_tc` (block 0, a thread of the first and of the
last consumer warp) and prints the cycles of each phase per tile. The
patches work on literal source anchors: after an edit of the kernel the
tool may stop and name an anchor it lost.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CALLS = 20
MMA = ("            mma_add(acc[i][rg][0], a[rg], b.x, b.z);\n"
       "            mma_add(acc[i][rg][1], a[rg], b.y, b.w);\n")
COPY = ("          tc::mbar_expect_tx(l.full + s, bytes);\n"
        "          tc::bulk_load(l.slots + (size_t)s * PSLOT, src, bytes, l.full + s);")
STAGE = "      if (i < n && w0 + r < a.W)\n        v[u] ="
VARIANTS = {
    "no_stage": [(STAGE, "      if (false)\n        v[u] =")],
    "no_copy": [(COPY, "          tc::mbar_arrive(l.full + s);")],
    "no_mma": [(MMA, "")],
}
# fwd_tc's phase boundaries: (anchor, stamp index) with the stamp put before
# the anchor; the last stamp follows the tile's partial sum.
STAMP = ("if (blockIdx.x == 0 && (threadIdx.x == 0 || threadIdx.x == NC - 32)) "
         "reinterpret_cast<long long*>(a.dbp)[(threadIdx.x ? 8192 : 0) + "
         "(tile - (int)blockIdx.x) / (int)gridDim.x * 8 + %d] = clock64();\n")
PHASES = ["stage", "u_product", "v_product_and_lse", "target_logit", "tile_sum"]
ANCHORS = ["    csync();\n    stage_tile(l, a, b, w0, nullptr);\n",
           "    hidden(r, l, a, nullptr);\n",
           "    Acc v;\n    float m[RG][2], tot[RG][2];\n    logits_lse(r, l, a, v, m, tot);\n",
           "    // The owner of the row's target logit writes the row's value.\n",
           "    if (threadIdx.x < 32) {  // rows lane and lane + 32",
           "      if (threadIdx.x == 0) a.partial[tile] = s;\n    }\n"]


def patched(src: str, name: str) -> str:
    if name == "phases":
        head, tail = src.split("fwd_tc(PostTc a) {", 1)
        body, rest = tail.split("bwd_rows_tc(PostTc a) {", 1)
        for k, anchor in enumerate(ANCHORS):
            if body.count(anchor) != 1:
                raise RuntimeError(f"post_loss.cu changed; a phase anchor is gone: {anchor!r}")
            body = (body.replace(anchor, STAMP % k + anchor) if k < len(ANCHORS) - 1
                    else body.replace(anchor, anchor + STAMP % k))
        return head + "fwd_tc(PostTc a) {" + body + "bwd_rows_tc(PostTc a) {" + rest
    for anchor, repl in VARIANTS[name]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"post_loss.cu changed; the anchor of {name} is gone: {anchor!r}")
        src = src.replace(anchor, repl)
    return src


def build_patched(build, names) -> dict:
    """{name: CDLL} of patched copies of post_loss.cu, compiled together."""
    work = os.path.join(build.BUILD, "post_profile")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(build.CSRC, work)
    src = open(os.path.join(work, "post_loss.cu")).read()
    procs = {}
    for name in names:
        path = os.path.join(work, f"{name}.cu")
        open(path, "w").write(patched(src, name))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{out}")
    return {name: ctypes.CDLL(os.path.join(work, f"{name}.so")) for name in names}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("post_profile: needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.ops.cuda import build
    from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    build.build_all()
    names = [v for v in args.variants.split(",") if v]
    libs = build_patched(build, names + (["phases"] if args.phases else []))
    out = {"gpu": CS.gpu_line(), "calls": CALLS}
    real_load = build.load
    for config in ("wavenet30", "stress_gen"):
        arch = Config.load(os.path.join(ROOT, "configs", f"{config}.json")).arch
        post = params_from_jax(CS.numpy_params(arch, 0), device="cuda")["post"]
        skip, tgt, mask = CS.post_inputs(arch, 14)
        gbar = torch.tensor(1.0 / CS.TRAIN_B / CS.TRAIN_W, device="cuda")
        w, dt = CS.TRAIN_W, torch.bfloat16
        fwd = lambda: PL.post_loss_fwd(post, skip, tgt, mask, w, dt)  # noqa: E731
        bwd = lambda: PL.post_loss_bwd(post, skip, tgt, mask, w, dt, gbar)  # noqa: E731
        row = {"S": arch.skip_channels, "route": PL.route(arch.skip_channels,
                                                          arch.quant_channels, dt),
               "fwd_ms": CS.cuda_ms(fwd, CALLS), "bwd_ms": CS.cuda_ms(bwd, CALLS)}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fwd()
                bwd()
            torch.cuda.synchronize()
        split = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = e.name.split("(")[0]
                split[k] = split.get(k, 0.0) + e.time_range.elapsed_us() / 3000.0
        row["kernel_ms_per_call"] = split
        for name in names:
            build.load = lambda n, lib=libs[name]: lib if n == "post_loss" else real_load(n)
            try:
                row[name] = {"fwd_ms": CS.cuda_ms(fwd, CALLS), "bwd_ms": CS.cuda_ms(bwd, CALLS)}
            finally:
                build.load = real_load
        if args.phases and config == "wavenet30":
            keep, dims = PL._cuda_args(post, skip, tgt, mask, w)
            b = skip.shape[0]
            stamps = torch.zeros(16384, dtype=torch.int64, device="cuda")
            partial = torch.empty(b * -(-w // PL.TC_TILE), device="cuda")
            num = torch.empty((), device="cuda")
            targs = PL._tc_args(post, keep, dims, PL._tc_blocks(b, w, skip.device),
                                partial=partial, num=num, dbp=stamps)
            build.launch(libs["phases"], "wn_post_loss_fwd_tc", targs, skip.device)
            torch.cuda.synchronize()
            d = stamps.cpu().view(2, -1, 8)
            phases = {}
            for who, st in zip(("first_warp", "last_warp"), d):
                tiles = [t for t in st.tolist() if t[0]]
                phases[who] = {p: sum(t[k + 1] - t[k] for t in tiles) / len(tiles)
                               for k, p in enumerate(PHASES)}
                phases[who]["tile_period"] = (tiles[-1][0] - tiles[0][0]) / (len(tiles) - 1)
            phases["sm_clock"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip()
            row["fwd_tc_cycles_per_tile"] = phases
        out[config] = row
        del post, skip, tgt, mask
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
