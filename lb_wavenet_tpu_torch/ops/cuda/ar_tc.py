"""Host side of the tensor-core sampling kernels (`csrc/ar_tc.cuh`, the
bf16 instantiations of `ar_mega.cu` and `ar_turbo.cu`): the weight packing,
its plain reading, the launch shape and the per-step weight streams.

A weight W (K, M) (input k, output m, as the JAX package stores it) is
packed as the A operand of `mma.sync.m16n8k16` (A = W^T, M x K, row-major):
(K/16, M/16, 32, 8), k-step by k-step, each 16x16 tile as the 32 lanes'
fragments of 8 bf16 values. Lane l = 4 g + t holds, in order, A[g][2t],
A[g][2t+1], A[g+8][2t], A[g+8][2t+1], A[g][2t+8], A[g][2t+9], A[g+8][2t+8],
A[g+8][2t+9] of its tile: one 16-byte load per lane and tile. The kernels
consume a sample step's matrices as one stream, packed back to back in the
order of use, with a table of their (M, K).

The kernels sum each product k-step by k-step: one mma from zero per 16-deep
k-step, its result added to an fp32 sum in order. `tc_product` reproduces
that sum bit for bit: the tensor core adds the 16 exact products aligned to
the largest exponent sum of the operand pairs (e_a + e_b), each truncated
toward zero to TC_BITS bits below it, and rounds the total toward zero to
fp32. That model matched every one of 2,097,152 mma results on an H100 (a
calibration run of random tiles with exponents spread over 2^-12..2^12);
the sampling network is chaotic enough that any other order moves logits by
a few hundredths within a few steps (PERF.md, Findings).
"""
from __future__ import annotations

import torch

TB = 8                  # lanes per block (wn::TB): one n8 fragment
MAX_M = 768             # widest product: 6 tiles of 16 outputs per consumer warp
MAX_GATES = 384         # widest gate: 3 (tanh, sigmoid) tile pairs per consumer warp
TC_BITS = 25            # aligned bits of the tensor core's 16-term sum


def pack_mma(w: torch.Tensor) -> torch.Tensor:
    """(K, M) -> (K/16, M/16, 32, 8) in the A-fragment register order."""
    k, m = w.shape
    a = w.t().reshape(m // 16, 2, 8, k // 16, 2, 4, 2)   # (mt, hi, g, ks, khi, t, kl)
    return a.permute(3, 0, 2, 5, 4, 1, 6).reshape(k // 16, m // 16, 32, 8)


def unpack_mma(p: torch.Tensor) -> torch.Tensor:
    """The inverse of pack_mma: (K/16, M/16, 32, 8) -> (K, M)."""
    ks, mt = p.shape[:2]
    a = p.reshape(ks, mt, 8, 4, 2, 2, 2).permute(1, 5, 2, 0, 4, 3, 6)
    return a.reshape(mt * 16, ks * 16).t()


def _fragment_index():
    """(rows, cols) of the (32, 8) fragment elements in their 16x16 tile,
    from the register layout of mma.sync.m16n8k16 (row-major bf16 A)."""
    lane = torch.arange(32)[:, None]
    e = torch.arange(8)[None, :]
    g, t = lane // 4, lane % 4
    reg, kl = e // 2, e % 2
    return g + 8 * (reg % 2), 2 * t + 8 * (reg // 2) + kl


def mma_product_plain(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """W^T @ x for x (K, N), read from the packed W as the kernel reads it:
    k-step by k-step, each tile rebuilt from its lanes' fragments, fp32
    sums in k-step order."""
    ks, mt = p.shape[:2]
    rows, cols = _fragment_index()
    out = torch.zeros((mt * 16, x.shape[1]), dtype=torch.float32)
    for k in range(ks):
        xk = x[16 * k: 16 * (k + 1)].float()
        for m in range(mt):
            tile = torch.zeros((16, 16), dtype=torch.float32)
            tile[rows, cols] = p[k, m].float()
            out[16 * m: 16 * (m + 1)] += tile @ xk
    return out


def launch_shape(batch: int) -> tuple:
    """(blocks, lanes per block) of a launch at `batch`: one block per tile
    of TB lanes, the last tile masked where TB does not divide the batch.
    More lanes per block would divide the weight bytes the card moves per
    step but idle more SMs at the served batches (PERF.md, Findings)."""
    if batch < 1:
        raise ValueError(f"batch must be positive, got {batch}")
    return -(-batch // TB), TB


def lane_tiles(batch: int) -> list:
    """[(first lane, lanes)] of each block of launch_shape(batch)."""
    blocks, lanes = launch_shape(batch)
    return [(i * lanes, min(lanes, batch - i * lanes)) for i in range(blocks)]


def unsupported(arch):
    """Why the tensor-core kernels do not take the arch's widths, or None."""
    widths = {"residual_channels": arch.residual_channels, "gate_channels": arch.gate_channels,
              "skip_channels": arch.skip_channels, "quant_channels": arch.quant_channels}
    for name, v in widths.items():
        if v % 16:
            return (f"the bf16 sampling kernels need {name} % 16 == 0 (mma.sync tiles "
                    f"of 16), got {v}")
    widest = max(arch.residual_channels + arch.skip_channels, arch.skip_channels,
                 arch.quant_channels)
    if widest > MAX_M:
        return (f"the bf16 sampling kernels take products up to {MAX_M} outputs wide "
                f"(6 tiles of 16 per consumer warp), got {widest}")
    if arch.gate_channels > MAX_GATES:
        return (f"the bf16 sampling kernels take up to {MAX_GATES} gate channels "
                f"(3 tile pairs per consumer warp), got {arch.gate_channels}")
    return None


def route(arch, dt) -> str:
    """Which instantiation of the mega and turbo kernels runs the arch in
    compute dtype `dt`, decided before launch from the widths alone:
    "tensor_cores" for bf16 at widths `unsupported` accepts, "cuda_cores"
    (the in-order fp32-FMA instantiation of common.cuh, any width) for
    fp32 and for bf16 at any other width."""
    if dt == torch.bfloat16 and unsupported(arch) is None:
        return "tensor_cores"
    return "cuda_cores"


def default_order(arch, dt, device) -> bool:
    """Whether a plain version sums as the tensor-core kernels do: on a CUDA
    tensor, where it is the kernels' reference, on the tensor-core route.
    On the CPU it sums each product in one fp32 product: the float64
    emulation of tc_product is several times slower and only a bit-for-bit
    comparison with the kernels needs it."""
    return torch.device(device).type == "cuda" and route(arch, dt) == "tensor_cores"


def _finale(params: dict, arch) -> list:
    """w1, w2, then the input conv's newest tap and its past taps in order."""
    w_in, k = params["input_conv"]["w"], arch.input_kernel
    return [params["post"]["w1"], params["post"]["w2"], w_in[k - 1],
            *(w_in[j] for j in range(k - 1))]


def step_stream(params: dict, lp: dict, arch) -> list:
    """The (K, M) matrices of one sample step in the order the kernels use
    them (mega and turbo alike): per layer [w_cur ; w_prev] (2C, 2G) and
    [w_res | w_skip] (G, C+S), then the finale."""
    mats = []
    for l in range(len(arch.dilations)):
        mats.append(torch.cat([lp["w_cur"][l], lp["w_prev"][l]], 0))
        mats.append(torch.cat([lp["w_res"][l], lp["w_skip"][l]], 1))
    return mats + _finale(params, arch)


def pack_stream(mats: list, device) -> dict:
    """{"wpk": the packed bf16 stream, "prods": (n, 2) int32 (M, K) table}."""
    packed = [pack_mma(w.to(device, torch.bfloat16)).reshape(-1) for w in mats]
    table = [(w.shape[1], w.shape[0]) for w in mats]
    return {"wpk": torch.cat(packed).contiguous(),
            "prods": torch.tensor(table, dtype=torch.int32, device=device)}


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) as int32; -1000 for zero (below every bf16 product)."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.full_like(e, -1000), e - 1)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2.0 ** e in float64, exactly, from the exponent bits (a device's
    pow() may miss a power of two by an ulp); e below -1022 (a group of
    zero products, where any quantum does) is raised to it."""
    bits = (e.to(torch.int64).clamp(min=-1022) + 1023) << 52
    return bits.view(torch.float64)


def tc_sum16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, KS, 16), b (KS, 16, N) holding bf16 values -> (M, KS, N) fp32:
    each 16-deep dot product as mma.sync.m16n8k16 computes it from a zero
    accumulator."""
    a, b = a.double(), b.double()
    prod = a[..., None] * b[None]                                  # exact
    e = _exponent(a)[..., None] + _exponent(b)[None]
    q = _pow2(e.max(dim=2, keepdim=True).values - TC_BITS)
    s = (torch.trunc(prod / q) * q).sum(dim=2)                    # exact
    f = s.float()
    over = f.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def tc_product(w_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w_t (M, K) @ x (K, N), both holding bf16 values, summed as the
    kernels' `mm` sums it: fp32 (M, N)."""
    m, k = w_t.shape
    s = tc_sum16(w_t.reshape(m, k // 16, 16), x.reshape(k // 16, 16, x.shape[1]))
    acc = torch.zeros((m, x.shape[1]), dtype=torch.float32, device=x.device)
    for i in range(k // 16):
        acc = acc + s[:, i]
    return acc


def tc_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batch-major x (N, K) @ w (K, M) as tc_product sums it: (N, M)."""
    return tc_product(w.t(), x.t()).t()
