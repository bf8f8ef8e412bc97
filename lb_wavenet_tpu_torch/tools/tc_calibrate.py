#!/usr/bin/env python3
"""Check the tensor-core rounding model of the bf16 sampling kernels on the
card, and optionally record a golden sample for the CPU tests.

    python -m lb_wavenet_tpu_torch.tools.tc_calibrate \
        [--golden tests/torch_goldens/tc_mma_h100.npz] [--dump misses.npz]

Runs one mma.sync.m16n8k16 (bf16 x bf16 -> fp32) per tile on 8192 random
tiles (half of them with exponents spread over 2^-12..2^12), from a zero
and from a random accumulator, and compares every result with
`ar_tc.tc_sum16` (zero accumulator) and with the same model that also
aligns the accumulator. Prints one JSON line; exits 1 on any mismatch.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops.cuda import ar_tc, build

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
N = 8192


def tiles():
    """(A (N,16,16) [m][k], B (N,16,8) [k][n], C (N,16,8)) float32 arrays;
    A and B hold bf16 values."""
    rng = np.random.default_rng(0)

    def vals(shape, wide):
        v = rng.standard_normal(shape)
        return v * 2.0 ** rng.integers(-12, 12, shape) if wide else v

    half = N // 2
    a = np.concatenate([vals((half, 16, 16), False) / 8, vals((half, 16, 16), True)])
    b = np.concatenate([vals((half, 16, 8), False), vals((half, 16, 8), True)])
    c = np.concatenate([vals((half, 16, 8), False), vals((half, 16, 8), True)])
    bf = [torch.tensor(x, dtype=torch.float32).to(torch.bfloat16) for x in (a, b)]
    return bf[0], bf[1], torch.tensor(c, dtype=torch.float32)


def with_accumulator(a, b, c):
    """The model with the accumulator as a 17th term aligned by its own
    exponent: (N, 16, 8) fp32."""
    prod = a.double()[:, :, None, :] * b.double().transpose(1, 2)[:, None, :, :]
    e = ar_tc._exponent(a.double())[:, :, None, :] + \
        ar_tc._exponent(b.double()).transpose(1, 2)[:, None, :, :]
    terms = torch.cat([prod, c.double()[..., None]], -1)
    e = torch.cat([e, ar_tc._exponent(c.double())[..., None]], -1)
    q = ar_tc._pow2(e.max(dim=-1, keepdim=True).values - ar_tc.TC_BITS)
    s = (torch.trunc(terms / q) * q).sum(-1)
    f = s.float()
    return torch.where(f.double().abs() > s.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def production_tiles(batch: int = 64, steps: int = 10):
    """(A, B) bf16 tiles, on the card, of every product of `steps` steps of
    the plain mega version (WaveNet-30, random weights and carry, `batch`
    lanes, in the tensor-core order), as the kernel feeds them to mma.sync:
    A a 16x16 weight tile, B a 16-deep slice of 8 lanes' activations."""
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.generate import _fused_frontend_zero
    from lb_wavenet_tpu_torch.ops.cuda import ar_mega
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    arch = Config.load(os.path.join(ROOT, "configs", "wavenet30.json")).arch
    params = params_from_jax(CS.numpy_params(arch, 0), device="cuda")
    h0, e0 = _fused_frontend_zero(params, arch, batch)
    carry = ar_mega.mega_zero_carry(arch, h0, e0)
    g = torch.Generator(device="cuda").manual_seed(2)
    for k in ("bufs", "hstate"):
        carry[k].normal_(generator=g)
    tiles_a, tiles_b = [], []
    plain = ar_tc.tc_sum16

    def record(a, b):   # a (M, KS, 16), b (KS, 16, N)
        m, ks, n = a.shape[0] // 16, a.shape[1], b.shape[2] // 8
        ta = a.reshape(m, 16, ks, 16).permute(0, 2, 1, 3)              # (m, ks, 16, 16)
        tb = b.reshape(ks, 16, n, 8).permute(2, 0, 1, 3)               # (n, ks, 16, 8)
        tiles_a.append(ta[None].expand(n, -1, -1, -1, -1).reshape(-1, 16, 16)
                       .to(torch.bfloat16))
        tiles_b.append(tb[:, None].expand(-1, m, -1, -1, -1).reshape(-1, 16, 8)
                       .to(torch.bfloat16))
        return plain(a, b)

    ar_tc.tc_sum16 = record
    try:
        forced = torch.randint(0, arch.quant_channels, (steps, batch), device="cuda",
                               dtype=torch.int32, generator=g)
        ar_mega.mega_generate_plain(params, params["layers"], arch, carry, 100, forced, 1.0,
                                    False, None, 0)
    finally:
        ar_tc.tc_sum16 = plain
    return torch.cat(tiles_a), torch.cat(tiles_b)


def run_tiles(lib, a, b, c):
    """D = A B + C on the card, one mma per tile (on the host)."""
    n = a.shape[0]
    ag, bg, cg = a.cuda().contiguous(), b.cuda().contiguous(), c.cuda().contiguous()
    d = torch.empty((n, 16, 8), device="cuda")
    err = lib.run_calib(ag.data_ptr(), bg.data_ptr(), cg.data_ptr(), d.data_ptr(), n,
                        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"calibration kernel: CUDA error {err}")
    return d.cpu()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--golden", help="write 64 zero-accumulator tiles here")
    ap.add_argument("--dump", help="write the production tiles the model misses here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tc_calibrate: needs a GPU", file=sys.stderr)
        return 1
    os.makedirs(build.BUILD, exist_ok=True)
    so = os.path.join(build.BUILD, "tc_calibrate.so")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([build.nvcc_path(), *flags, "-o", so,
                    os.path.join(HERE, "tc_calibrate.cu")], check=True)
    lib = ctypes.CDLL(so)
    lib.run_calib.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    lib.run_calib.restype = ctypes.c_int
    a, b, c = tiles()
    ag, bg = a.cuda(), b.cuda()
    out = {}
    for name, acc in (("zero", torch.zeros_like(c)), ("random", c)):
        d = torch.empty((N, 16, 8), device="cuda")
        accg = acc.cuda()
        err = lib.run_calib(ag.data_ptr(), bg.data_ptr(), accg.data_ptr(), d.data_ptr(), N,
                            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"calibration kernel: CUDA error {err}")
        out[name] = d.cpu()
    model0 = ar_tc.tc_sum16(a.float().transpose(0, 1), b.float()).transpose(0, 1)
    model1 = with_accumulator(a.float(), b.float(), c)
    match = {"zero": int((model0 == out["zero"]).sum()),
             "random": int((model1 == out["random"]).sum()), "of": N * 128}
    pa, pb = production_tiles()
    missed, chunk, keep = 0, 20000, []
    for i in range(0, pa.shape[0], chunk):
        a_, b_ = pa[i:i + chunk], pb[i:i + chunk]
        got = run_tiles(lib, a_, b_, torch.zeros((a_.shape[0], 16, 8), device="cuda"))
        # Tiles as the k-steps of one product: (16, n, 16) x (n, 16, 8).
        want = ar_tc.tc_sum16(a_.float().transpose(0, 1), b_.float()).transpose(0, 1).cpu()
        bad = (got != want).reshape(a_.shape[0], -1).any(1)
        missed += int((got != want).sum())
        if bad.any() and sum(len(k[0]) for k in keep) < 2000:
            keep.append((a_[bad.cuda()].float().cpu(), b_[bad.cuda()].float().cpu(), got[bad],
                         want[bad]))
    match["production_tiles"] = {"tiles": int(pa.shape[0]), "outputs": int(pa.shape[0]) * 128,
                                 "outputs_missed": missed}
    if args.dump and keep:
        np.savez_compressed(args.dump, a=torch.cat([k[0] for k in keep]).numpy(),
                            b=torch.cat([k[1] for k in keep]).numpy(),
                            d=torch.cat([k[2] for k in keep]).numpy(),
                            model=torch.cat([k[3] for k in keep]).numpy())
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tc_model_matches": match, "tc_bits": ar_tc.TC_BITS, "gpu": gpu}))
    if args.golden:
        keep = np.r_[0:32, N // 2:N // 2 + 32]
        np.savez_compressed(args.golden, a=a.float().numpy()[keep], b=b.float().numpy()[keep],
                            d=out["zero"].numpy()[keep])
    return 0 if (match["zero"] == match["random"] == match["of"]
                 and match["production_tiles"]["outputs_missed"] == 0) else 1


if __name__ == "__main__":
    sys.exit(main())
