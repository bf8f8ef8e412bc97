#!/usr/bin/env python3
"""Where the frontend pair's time goes on the card (B5, `csrc/frontend.cu`).

    python -m lb_wavenet_tpu_torch.tools.front_probe

At WaveNet-30's training shape (configs/wavenet30.json: B=8, W=10240,
T=13310, random weights and inputs from a numpy seed; the classes uniform,
then those of a training batch of the synthetic corpus), on the arch's
route:
  * each kernel's device time by torch.profiler (20 calls of the forward
    and of the backward), and the calls' wall time by CUDA events;
  * the tensor-core backward pass (`ftc::bwd_pass`) split into phases by
    clock64 counters of block 0's thread 0 (the first half: d_e products,
    d_b, half of the G scatters, the d_embed scatter, the next tile's
    split) and thread 256 (the second half: staging, class groups, the other
    half of the G scatters), in device memory (the pass
    leaves no shared memory spare; each stamp costs its thread a global
    load and store), from a copy of `csrc/` patched at literal anchors and
    built into the gitignored build directory; cycles per call by phase
    (`PHASES_A`, `PHASES_B`) beside the probed library's time per call;
  * the backward's kernels again from patched copies that leave out the
    d_e products, the G scatters or the d_embed scatter (`VARIANTS`), to
    price each part.
Prints one JSON line with the card's name and power limit.

A development aid, kept in step with `csrc/frontend.cu` by hand: when an
anchor moves, the probe stops and names it. Nothing in the package or its
tests runs it.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

from ..ops.cuda import build
from ..ops.cuda import frontend as F

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

PROF_DEFS = '''
__device__ unsigned long long wn_prof[2][16];
extern "C" int wn_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, wn_prof, sizeof(wn_prof));
}
extern "C" int wn_prof_zero() {
  unsigned long long z[2][16] = {};
  return (int)cudaMemcpyToSymbol(wn_prof, z, sizeof(z));
}
#define WN_A (blockIdx.x == 0 && threadIdx.x == 0)
#define WN_B (blockIdx.x == 0 && threadIdx.x == NTP / 2)
#define PA(k) if (WN_A) { long long n_ = clock64(); wn_prof[0][k] += n_ - wn_tq; wn_tq = n_; }
#define PB(k) if (WN_B) { long long n_ = clock64(); wn_prof[1][k] += n_ - wn_tq; wn_tq = n_; }
#define P0() long long wn_tq = clock64();
'''
# Phases of thread 0 (the products' half) and of thread NTP/2 (the other
# half), in cycles; counter 15 of the first counts tiles.
PHASES_A = ["zero_tables_and_first_tile", "wait_tile_and_barrier", "d_e_products",
            "d_b_g_scatter_and_barrier", "d_embed_scatter_and_split_next", "last_barrier",
            "write_back"]
PHASES_B = ["zero_tables_and_first_tile", "wait_tile_and_barrier", "class_groups_and_sync",
            "g_scatter_and_barrier", "issue_and_check_next_tiles", "last_barrier", "write_back"]


def _patch(src: str, reps) -> str:
    for a, b in reps:
        if a not in src:
            raise RuntimeError(f"frontend.cu changed; the probe's anchor is gone: {a!r}")
        src = src.replace(a, b, 1)
    return src


def patched(src: str) -> str:
    return _patch(src, [
        ("namespace wn {\n", PROF_DEFS + "namespace wn {\n"),
        ("  for (int i = threadIdx.x; i < cv.tables; i += NTP) tab[i] = 0.f;\n",
         "  P0()\n  for (int i = threadIdx.x; i < cv.tables; i += NTP) tab[i] = 0.f;\n"),
        ("  __syncthreads();  // tile 0 split\n", "  __syncthreads();  // tile 0 split\n  PA(0) PB(0)\n"),
        ("    if (n > 0) __syncthreads();  // tile n split; tile n-1's scatters done\n",
         "    if (n > 0) __syncthreads();  // tile n split; tile n-1's scatters done\n"
         "    PA(1) PB(1) if (WN_A) ++wn_prof[0][15];\n"),
        ("          *reinterpret_cast<float2*>(er + 8 * C) = make_float2(de[h][2], de[h][3]);\n"
         "        }\n",
         "          *reinterpret_cast<float2*>(er + 8 * C) = make_float2(de[h][2], de[h][3]);\n"
         "        }\n        PA(2)\n"),
        ("      half_sync();  // groups ready\n", "      half_sync();  // groups ready\n      PB(2)\n"),
        ("    __syncthreads();  // E and the d_embed table's groups ready; tile n read\n",
         "    __syncthreads();  // E and the d_embed table's groups ready; tile n read\n"
         "    PA(3) PB(3)\n"),
        ("  }  // tiles\n  __syncthreads();\n",
         "    PA(4) PB(4)\n  }  // tiles\n  __syncthreads();\n  PA(5) PB(5)\n"),
        ("    out[i] = reinterpret_cast<const float4*>(tab)[i];\n}\n",
         "    out[i] = reinterpret_cast<const float4*>(tab)[i];\n  PA(6) PB(6)\n}\n"),
    ])


# Patched copies that leave one part of the tensor-core pass out, to price
# it: their gradients are wrong, only their time is read.
VARIANTS = {
    "no_products": [("            tct::lda_rm(ah, hi, ld, strip * 16 + K - 1 - k, ks * 16);\n",
                     "            if (n < 0) tct::lda_rm(ah, hi, ld, strip * 16 + K - 1 - k, ks * 16);\n")],
    "no_g_scatter": [("      add_groups<C, NB>(", "      if (n < 0) add_groups<C, NB>(")],
    "no_embed_scatter": [("      add_groups<C, TP / HW>(", "      if (n < 0) add_groups<C, TP / HW>(")],
}


def build_copies(work: str, texts: dict) -> dict:
    """{name: library} of frontend.cu rewritten by each text function, built
    at once into `work`."""
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(build.CSRC, work)
    with open(os.path.join(work, "frontend.cu")) as f:
        src = f.read()
    procs = {}
    for name, fn in texts.items():
        path = os.path.join(work, f"frontend_{name}.cu")
        with open(path, "w") as f:
            f.write(fn(src))
        so = os.path.join(work, f"frontend_{name}.so")
        procs[name] = (so, subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, path],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on frontend_{name}.cu:\n{out}")
        libs[name] = ctypes.CDLL(so)
    return libs


def kernel_ms(fn, reps: int) -> dict:
    """{kernel name: device ms per call} of fn over reps calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name[:80]] = out.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / reps / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("front_probe: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.tools.kernel_ab import corpus_classes
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    arch = Config.load(os.path.join(ROOT, "configs", "wavenet30.json")).arch
    params = params_from_jax(CS.numpy_params(arch, 0), device="cuda")
    dt = compute_dtype(arch)
    e, w, b = params["embed"], params["input_conv"]["w"], params["input_conv"]["b"]
    x, dh = CS.frontend_inputs(arch, 15)
    out = {"gpu": CS.gpu_line(), "route": F.route(arch.quant_channels, arch.residual_channels,
                                                 arch.input_kernel, dt)}
    libs = build_copies(os.path.join(build.BUILD, "front_probe"), {
        "probe": patched, **{v: (lambda src, r=r: _patch(src, r)) for v, r in VARIANTS.items()},
    }) if out["route"] == "tensor_cores" else {}
    probed = libs.get("probe")
    for name, xs in (("random", x), ("corpus", corpus_classes(CS, ROOT))):
        fwd = lambda: F.frontend_fwd(e, w, b, xs, dt)   # noqa: E731
        bwd = lambda: F.frontend_bwd(e, w, xs, dt, dh)  # noqa: E731
        r = {"fwd_ms_per_call": CS.cuda_ms(fwd, 50), "bwd_ms_per_call": CS.cuda_ms(bwd, 50),
             "fwd_kernels_ms": kernel_ms(fwd, 20), "bwd_kernels_ms": kernel_ms(bwd, 20)}
        if probed is not None:
            real = build._libs["frontend"]
            build._libs["frontend"] = probed
            try:
                probed.wn_prof_zero()
                r["probed_bwd_ms_per_call"] = CS.cuda_ms(bwd, 10)   # 11 calls
                buf = (ctypes.c_ulonglong * 32)()
                if probed.wn_prof_read(buf):
                    raise RuntimeError("could not read the phase counters")
                calls = 11
                r["block0_tiles_per_call"] = buf[15] / calls
                for h, names in enumerate((PHASES_A, PHASES_B)):
                    ph = {k: buf[16 * h + i] / calls for i, k in enumerate(names)}
                    ph["total"] = sum(buf[16 * h + i] for i in range(len(names))) / calls
                    r[f"block0_cycles_per_call_thread{h * 256}"] = ph
            finally:
                build._libs["frontend"] = real
            for v in VARIANTS:
                build._libs["frontend"] = libs[v]
                try:
                    r[f"bwd_kernels_ms_{v}"] = kernel_ms(bwd, 20)
                finally:
                    build._libs["frontend"] = real
        out[f"{name}_classes"] = r
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
