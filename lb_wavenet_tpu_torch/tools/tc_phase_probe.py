#!/usr/bin/env python3
"""Where the bf16 mega kernel's time goes, by phase, on the card.

    python -m lb_wavenet_tpu_torch.tools.tc_phase_probe

Builds a copy of `csrc/` (into the gitignored build directory) whose
`mega_tc_kernel` adds clock64 counters at its phase boundaries (thread 0 of
block 0: stage, pre product with its gate, res+skip product, post network,
sampling, frontend, and the time spent waiting for weight slots), runs
WaveNet-30 (configs/wavenet30.json, random weights) for 256 teacher-forced
steps at B=64 and B=512 with the real and the probed library, and prints
one JSON line: microseconds per step of each, and cycles per step by
phase. It stands in for ncu where ncu cannot run.

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

from ..ops.cuda import ar_mega, build

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

PROF_DEFS = '''
__device__ unsigned long long wn_prof[16];
extern "C" int wn_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, wn_prof, sizeof(wn_prof));
}
#define P(k) { long long n_ = clock64(); pf[k] += n_ - tq; tq = n_; }
'''
PHASES = ["stage", "pre_and_gate", "res_skip", "post", "sample", "frontend"]


def patched(mega: str, tcu: str):
    """ar_mega.cu and ar_tc.cuh with the phase counters."""
    mega = mega.replace("namespace wn {\n", "namespace wn {\n" + PROF_DEFS, 1)
    reps = [
        ("  tc::csync();\n\n  for (int t = 0, q = 0; t < a.T; ++t) {",
         "  tc::csync();\n  long long pf[8] = {0, 0, 0, 0, 0, 0, 0, 0};"
         " long long tq = clock64();\n  for (int t = 0, q = 0; t < a.T; ++t) {"),
        ("      tc::csync();\n      // pre = [h ; tap]",
         "      tc::csync(); P(0)\n      // pre = [h ; tap]"),
        ("      tc::csync();\n      // One z @", "      tc::csync(); P(1)\n      // One z @"),
        ("      tc::csync();\n      off += d;", "      tc::csync(); P(2)\n      off += d;"),
        ("    tc::sample(", "    P(3) tc::sample("),
        ("    tc::next_frontend<TPW>(", "    P(4) tc::next_frontend<TPW>("),
        ("                      a.b_in, C, K);\n  }",
         "                      a.b_in, C, K);\n  P(5) }\n"
         "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
         "    for (int k = 0; k < 6; ++k) wn_prof[k] = pf[k];\n"
         "    wn_prof[6] = ring.waited;\n  }\n"),
        ("  s.ring.i = 0;\n", "  s.ring.i = 0;\n  s.ring.waited = 0;\n"),
    ]
    for a, b in reps:
        if a not in mega:
            raise RuntimeError(f"ar_mega.cu changed; the probe's anchor is gone: {a!r}")
        mega = mega.replace(a, b, 1)
    for a, b in (("  int n;\n  int i;\n", "  int n;\n  int i;\n  long long waited;\n"),
                 ("    mbar_wait(full + s, (i / n) & 1);\n",
                  "    const long long w0 = clock64();\n    mbar_wait(full + s, (i / n) & 1);\n"
                  "    waited += clock64() - w0;\n")):
        if a not in tcu:
            raise RuntimeError(f"ar_tc.cuh changed; the probe's anchor is gone: {a!r}")
        tcu = tcu.replace(a, b, 1)
    return mega, tcu


def main() -> int:
    if not torch.cuda.is_available():
        print("tc_phase_probe: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.generate import _fused_frontend_zero
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    real = build.load("ar_mega")
    work = os.path.join(build.BUILD, "tc_phase_probe")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(build.CSRC, work)
    mega, tcu = patched(open(os.path.join(work, "ar_mega.cu")).read(),
                        open(os.path.join(work, "ar_tc.cuh")).read())
    open(os.path.join(work, "ar_mega.cu"), "w").write(mega)
    open(os.path.join(work, "ar_tc.cuh"), "w").write(tcu)
    so = os.path.join(work, "probe.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so,
                    os.path.join(work, "ar_mega.cu")], check=True, capture_output=True)
    probe = ctypes.CDLL(so)
    arch = Config.load(os.path.join(ROOT, "configs", "wavenet30.json")).arch
    params = params_from_jax(CS.numpy_params(arch, 0), device="cuda")
    lp, steps = params["layers"], 256
    out = {"gpu": CS.gpu_line(), "steps": steps}
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    out["clocks.max.sm"] = clock
    for b in (64, 512):
        h0, e0 = _fused_frontend_zero(params, arch, b)
        forced = torch.randint(0, arch.quant_channels, (steps, b), device="cuda",
                               dtype=torch.int32)
        lane = torch.stack([torch.arange(b, device="cuda", dtype=torch.int32),
                            torch.zeros(b, device="cuda", dtype=torch.int32)])
        for name, lib in (("real", real), ("probed", probe)):
            build._libs["ar_mega"] = lib
            carry = ar_mega.mega_zero_carry(arch, h0, e0)
            ms = CS.cuda_ms(lambda: ar_mega.mega_generate_cuda(
                params, lp, arch, carry, 0, forced, 1.0, False, lane, 0), 2)
            out[f"{name}_us_per_step B={b}"] = 1000.0 * ms / steps
        build._libs["ar_mega"] = real
        buf = (ctypes.c_ulonglong * 16)()
        if probe.wn_prof_read(buf):
            raise RuntimeError("could not read the phase counters")
        out[f"cycles_per_step B={b}"] = {
            **{k: buf[i] / steps for i, k in enumerate(PHASES)},
            "of_which_waiting_for_weights": buf[6] / steps}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
