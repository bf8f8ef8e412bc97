#!/usr/bin/env python3
"""Where the bf16 tensor-core sampling kernels' time goes, by phase, on the
card: mega (B2) and the one-step stack kernels B1 and B7.

    python -m lb_wavenet_tpu_torch.tools.tc_phase_probe

Builds a copy of `csrc/` (into the gitignored build directory) whose layer
loops (mega's own, and `tc::layer` in ar_tc.cuh, B1's and B7's) and mega's
finale add clock64 counters at their phase boundaries (thread 0 of block
0: stage, pre product with its gate, res+skip product, then mega's post
network, sampling and frontend, and the time spent waiting for weight
slots). It runs mega on WaveNet-30 (configs/wavenet30.json, random
weights) for 256 teacher-forced steps at B=64 and B=512, B1 (fused_stack)
on WaveNet-30 at B=512 and B=64, and B7 (tp_fused_stack) on
configs/stress_gen.json at B=256 with S_l = 512 and 256, each with the
real and the probed library, and prints one JSON line: microseconds per
step of each, and cycles per step by phase. It stands in for ncu where ncu
cannot run.

A development aid, kept in step with `csrc/ar_mega.cu` and `csrc/ar_tc.cuh`
by hand: it patches them at literal source anchors, so an edit to those
sources may move an anchor, and the probe then stops and names it. Nothing
in the package or its tests runs it.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

from ..ops.cuda import ar_mega, ar_step, ar_tp, build

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

# Counters of thread 0 of block 0 in device globals: P(k) adds the cycles
# since the last mark to phase k, P0() starts a launch's count.
PROF_DEFS = '''
__device__ unsigned long long wn_prof[16];
__device__ long long wn_tq;
extern "C" int wn_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, wn_prof, sizeof(wn_prof));
}
#define WN_ME (blockIdx.x == 0 && threadIdx.x == 0)
#define P(k) if (WN_ME) { long long n_ = clock64(); wn_prof[k] += n_ - wn_tq; wn_tq = n_; }
#define P0() if (WN_ME) { for (int k_ = 0; k_ < 16; ++k_) wn_prof[k_] = 0; wn_tq = clock64(); }
'''
WAIT = 6   # the counter of the weight-slot waits
PHASES = ["stage", "pre_and_gate", "res_skip", "post", "sample", "frontend"]


def _patch(src: str, name: str, reps) -> str:
    for a, b in reps:
        if a not in src:
            raise RuntimeError(f"{name} changed; the probe's anchor is gone: {a!r}")
        src = src.replace(a, b, 1)
    return src


def patched_tc(tcu: str) -> str:
    """ar_tc.cuh with the counters in tc::layer (B1's and B7's layer loop)
    and stack_tc_kernel, and the slot waits."""
    return _patch(tcu, "ar_tc.cuh", [
        ("namespace wn {\nnamespace tc {\n", PROF_DEFS + "namespace wn {\nnamespace tc {\n"),
        ("    mbar_wait(full + s, (i / n) & 1);\n",
         "    const long long w0 = clock64();\n    mbar_wait(full + s, (i / n) & 1);\n"
         "    if (WN_ME) wn_prof[6] += clock64() - w0;\n"),
        ("  if (next_row) prefetch_taps<FM>(next_row, next, B, b0, C);\n  csync();\n",
         "  if (next_row) prefetch_taps<FM>(next_row, next, B, b0, C);\n  csync();\n  P(0)\n"),
        ("      C / 16);\n  csync();\n  mm<TPW>(r, C + S",
         "      C / 16);\n  csync();\n  P(1)\n  mm<TPW>(r, C + S"),
        ("  cp_async_wait_all();\n  csync();\n}\n", "  cp_async_wait_all();\n  csync();\n  P(2)\n}\n"),
        ("  cp_async_wait_all();\n  csync();\n\n  int off = 0;\n",
         "  cp_async_wait_all();\n  csync();\n  P0()\n\n  int off = 0;\n"),
    ])


def patched_mega(mega: str) -> str:
    """ar_mega.cu with the counters of its layer loop and its finale."""
    return _patch(mega, "ar_mega.cu", [
        ("  tc::csync();\n\n  for (int t = 0, q = 0; t < a.T; ++t) {",
         "  tc::csync();\n  P0()\n  for (int t = 0, q = 0; t < a.T; ++t) {"),
        ("      tc::csync();\n      // pre = [h ; tap", "      tc::csync(); P(0)\n      // pre = [h ; tap"),
        ("      tc::csync();\n      // One z @", "      tc::csync(); P(1)\n      // One z @"),
        ("      tc::csync();\n      off += d;", "      tc::csync(); P(2)\n      off += d;"),
        ("    tc::sample(", "    P(3) tc::sample("),
        ("    tc::next_frontend<TPW>(", "    P(4) tc::next_frontend<TPW>("),
        ("                      a.b_in, C, K);\n  }", "                      a.b_in, C, K);\n  P(5) }"),
    ])


def build_probe(work: str) -> dict:
    """{source: the probed library} of ar_mega, ar_step and ar_tp."""
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(build.CSRC, work)

    def rewrite(name, fn):
        path = os.path.join(work, name)
        with open(path) as f:
            text = fn(f.read())
        with open(path, "w") as f:
            f.write(text)

    rewrite("ar_tc.cuh", patched_tc)
    rewrite("ar_mega.cu", patched_mega)
    procs = {}
    for src in ("ar_mega", "ar_step", "ar_tp"):
        so = os.path.join(work, f"{src}.so")
        procs[src] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, os.path.join(work, f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the probed {src}.cu:\n{out}")
        libs[src] = ctypes.CDLL(so)
    return libs


def counters(lib, steps: int, names) -> dict:
    buf = (ctypes.c_ulonglong * 16)()
    if lib.wn_prof_read(buf):
        raise RuntimeError("could not read the phase counters")
    return {**{k: buf[i] / steps for i, k in enumerate(names)},
            "of_which_waiting_for_weights": buf[WAIT] / steps}


def main() -> int:
    if not torch.cuda.is_available():
        print("tc_phase_probe: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    real = {src: build.load(src) for src in ("ar_mega", "ar_step", "ar_tp")}
    probe = build_probe(os.path.join(build.BUILD, "tc_phase_probe"))
    arch = Config.load(os.path.join(ROOT, "configs", "wavenet30.json")).arch
    params = params_from_jax(CS.numpy_params(arch, 0), device="cuda")
    lp, steps = params["layers"], 256
    out = {"gpu": CS.gpu_line()}
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    out["clocks.max.sm"] = clock

    def run(src, key, fn, per_launch, names):
        for name, lib in (("real", real[src]), ("probed", probe[src])):
            build._libs[src] = lib
            out[f"{key} {name}_us_per_step"] = 1000.0 * CS.cuda_ms(fn, 20) / per_launch
        build._libs[src] = real[src]
        out[f"{key} cycles_per_step"] = counters(probe[src], per_launch, names)

    for b in (64, 512):
        h0, e0 = G._fused_frontend_zero(params, arch, b)
        forced = torch.randint(0, arch.quant_channels, (steps, b), device="cuda",
                               dtype=torch.int32)
        lane = torch.stack([torch.arange(b, device="cuda", dtype=torch.int32),
                            torch.zeros(b, device="cuda", dtype=torch.int32)])
        carry = ar_mega.mega_zero_carry(arch, h0, e0)
        run("ar_mega", f"mega B={b}", lambda: ar_mega.mega_generate_cuda(
            params, lp, arch, carry, 0, forced, 1.0, False, lane, 0), steps, PHASES)
    # The stack kernels: one launch per step, the layer phases only.
    g = torch.Generator(device="cuda").manual_seed(3)
    for b in (512, 64):
        ring = torch.randn((sum(arch.dilations), b, arch.residual_channels), device="cuda",
                           generator=g)
        h = torch.randn((b, arch.residual_channels), device="cuda", generator=g)
        run("ar_step", f"fused_stack B={b}",
            lambda: ar_step.fused_stack(lp, arch, h, ring, 700), 1, PHASES[:3])
    tp_arch, tp_params = CS.tp_setup()
    h0 = torch.randn((tp_arch.residual_channels, CS.TP_B), device="cuda", generator=g)
    ring = torch.randn((sum(tp_arch.dilations), tp_arch.residual_channels, CS.TP_B),
                       device="cuda", generator=g)
    for s_l, layers in ((tp_arch.skip_channels, tp_params["layers"]),
                        (tp_arch.skip_channels // 2, CS.skip_half(tp_params["layers"], tp_arch,
                                                                  0))):
        fm = G._tp_weights(tp_params, layers, torch.bfloat16)
        run("ar_tp", f"tp_fused_stack S_l={s_l}",
            lambda: ar_tp.tp_fused_stack(fm, tp_arch, h0, ring, 700), 1, PHASES[:3])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
