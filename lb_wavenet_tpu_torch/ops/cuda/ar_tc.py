"""Host side of the tensor-core sampling kernels (`csrc/ar_tc.cuh`, the
bf16 instantiations of `ar_mega.cu` and `ar_turbo.cu`) and of the
tensor-core route of the one-step stack kernels B1 (`ar_step.cu`) and B7
(`ar_tp.cu`): the weight packing, its plain reading, the launch shape, the
per-step weight streams, the stack kernels' route, shared memory and
launch.

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

Conditioning (mel and/or speaker, folded into one row of Cc' channels a
lane, generate._fold_gcond): w_cond[l] (Cc', 2G) joins the gate product as
its last k-steps, [w_cur ; w_prev ; w_cond] ((2C + Cc') x 2G) against [h |
tap | cond]. mega and B7 sum that one chain, then add b; turbo and B1 sum
h's k-steps and [tap | cond]'s apart, then add, then add b. The plain
versions on the card sum the same way; on the CPU they keep the JAX order,
((h @ w_cur + tap @ w_prev) + b) + cond @ w_cond, one fp32 sum per product.

The CUDA-core route (fp32, and bf16 at widths the tensor-core kernels do
not take) sums each product as one fp32 FMA chain per output, k in order
(common.cuh `block_mm`); on the card its plain versions sum the same way
(`fma_product`), on the CPU in one fp32 product (`core_product`).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

TB = 8                  # lanes per block (wn::TB): one n8 fragment
MAX_M = 768             # widest product: 6 tiles of 16 outputs per consumer warp
MAX_GATES = 384         # widest gate: 3 (tanh, sigmoid) tile pairs per consumer warp
TC_BITS = 25            # aligned bits of the tensor core's 16-term sum
SLOT, MAX_SLOTS = 32768, 6   # bytes of a weight-ring slot, slots at most (tc::SLOT)
SMEM_MAX = 232448       # dynamic shared memory a block may use on an H100


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


def unsupported(arch, cc: int = 0):
    """Why the tensor-core kernels do not take the arch's widths (and a
    folded conditioning row of `cc` channels), or None."""
    widths = {"residual_channels": arch.residual_channels, "gate_channels": arch.gate_channels,
              "skip_channels": arch.skip_channels, "quant_channels": arch.quant_channels,
              "conditioning channels": cc}
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


def route(arch, dt, cc: int = 0) -> str:
    """Which instantiation of the mega and turbo kernels runs the arch in
    compute dtype `dt` with `cc` folded conditioning channels (0:
    unconditioned), decided before launch from the widths alone:
    "tensor_cores" for bf16 at widths `unsupported` accepts, "cuda_cores"
    (the in-order fp32-FMA instantiation of common.cuh, any width) for
    fp32 and for bf16 at any other width."""
    if dt == torch.bfloat16 and unsupported(arch, cc) is None:
        return "tensor_cores"
    return "cuda_cores"


def default_order(arch, dt, device, cc: int = 0) -> bool:
    """Whether a plain version sums as the tensor-core kernels do: on a CUDA
    tensor, where it is the kernels' reference, on the tensor-core route.
    On the CPU it sums each product in one fp32 product: the float64
    emulation of tc_product is several times slower and only a bit-for-bit
    comparison with the kernels needs it."""
    return torch.device(device).type == "cuda" and route(arch, dt, cc) == "tensor_cores"


def _finale(params: dict, arch) -> list:
    """w1, w2, then the input conv's newest tap and its past taps in order."""
    w_in, k = params["input_conv"]["w"], arch.input_kernel
    return [params["post"]["w1"], params["post"]["w2"], w_in[k - 1],
            *(w_in[j] for j in range(k - 1))]


def layer_stream(lp: dict, w_cond=None) -> list:
    """The (K, M) matrices of the L layers in the order the kernels use
    them: per layer [w_cur ; w_prev] (2C, 2G), or [w_cur ; w_prev ; w_cond]
    (2C + Cc', 2G) with the folded w_cond (L, Cc', 2G), and [w_res | w_skip]
    (G, C+S), S the width of the w_skip given (a rank's slice, for B1 under
    a model axis). The stream of the stack kernels B1 and B7."""
    mats = []
    for l in range(lp["w_cur"].shape[0]):
        gate = [lp["w_cur"][l], lp["w_prev"][l]]
        mats.append(torch.cat(gate if w_cond is None else gate + [w_cond[l]], 0))
        mats.append(torch.cat([lp["w_res"][l], lp["w_skip"][l]], 1))
    return mats


def fm_layer_stream(fm: dict) -> list:
    """layer_stream from B7's feature-major views (`generate._tp_weights`):
    per layer wcat^T (2C, 2G), or [wcat | wcond]^T (2C + Cc', 2G) when the
    views hold the folded wcond (L, 2G, Cc'), and wrs^T (G, C+S_l), the same
    matrices as layer_stream of the layer params cut to the same skip
    slice."""
    mats = []
    for l in range(fm["wcat"].shape[0]):
        gate = fm["wcat"][l] if "wcond" not in fm else torch.cat(
            [fm["wcat"][l], fm["wcond"][l]], 1)
        mats.append(gate.t())
        mats.append(fm["wrs"][l].t())
    return mats


def step_stream(params: dict, lp: dict, arch, w_cond=None) -> list:
    """The (K, M) matrices of one sample step in the order the kernels use
    them (mega and turbo alike): the layer stream, then the finale."""
    return layer_stream(lp, w_cond) + _finale(params, arch)


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


def fma_product(w_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w_t (M, K) @ x (K, N), fp32 values, summed as the CUDA-core kernels
    sum every product (common.cuh `block_mm`): per output one fp32 FMA
    chain from zero, k in order. Each step is one float64 addcmul stored
    to fp32: the product of two fp32 values is exact in float64, so the
    only rounding besides the FMA's own is float64's, before the store's.
    That second rounding cannot change the result when the operands hold
    bf16 values (the exact sum then fits in float64, or the smaller term
    lies below the fp32 result's rounding threshold); with fp32 operands it
    can, when the float64 sum falls exactly on an fp32 midpoint
    (`fma_double_roundings` counts it)."""
    acc = torch.zeros((w_t.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    cols = w_t.t().double()[:, :, None].unbind(0)       # K views (M, 1)
    rows = x.double()[:, None, :].unbind(0)             # K views (1, N)
    for wk, xk in zip(cols, rows):
        torch.addcmul(acc, wk, xk, out=acc)
    return acc


def fma_double_roundings(w_t: torch.Tensor, x: torch.Tensor) -> tuple:
    """(FMAs whose fp32 result fma_product's double rounding changed,
    FMAs) of w_t @ x: each step's exact sum (TwoSum of the float64 sum)
    rounded once to fp32, against the float64 sum rounded to fp32."""
    w64, x64 = w_t.double(), x.double()
    acc = torch.zeros((w_t.shape[0], x.shape[1]), dtype=torch.float64, device=x.device)
    wrong = 0
    for k in range(w_t.shape[1]):
        p = w64[:, k: k + 1] * x64[k: k + 1]                       # exact
        s = acc + p
        bb = s - acc
        err = (acc - (s - bb)) + (p - bb)                          # s + err = acc + p
        # An fp32 midpoint (normal range): the 29 bits float64 keeps below
        # fp32's mantissa read 1000...0. Off it, float(s) is already right.
        mid = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
        toward = torch.where(err > 0, torch.full_like(s, torch.inf), torch.full_like(s, -torch.inf))
        nudged = torch.where(mid & (err != 0), torch.nextafter(s, toward), s)
        exact, fast = nudged.float(), s.float()
        wrong += int((exact != fast).sum())
        acc = exact.double()
    return wrong, w_t.shape[0] * w_t.shape[1] * x.shape[1]


def plain_product(tensor_cores: bool, cuda_core_route: bool):
    """The (M, K) @ (K, N) product of a plain version: the tensor-core
    model where it reproduces the tensor-core kernels; for widths on the
    CUDA-core route that route's order (core_product); else (a plain
    version asked for another order than its kernel's) one fp32 product."""
    return tc_product if tensor_cores else core_product if cuda_core_route else torch.matmul


def plain_mm(tensor_cores: bool, cuda_core_route: bool):
    """plain_product for batch-major (N, K) @ (K, M)."""
    return tc_mm if tensor_cores else core_mm if cuda_core_route else torch.matmul


def core_product(w_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w_t (M, K) @ x (K, N) in the order of the CUDA-core route: on a CUDA
    tensor the kernels' in-order FMA chains (fma_product), on the CPU one
    fp32 product (the order the CPU tests hold against JAX)."""
    return fma_product(w_t, x) if x.device.type == "cuda" else w_t @ x


def core_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batch-major x (N, K) @ w (K, M) as core_product sums it: (N, M)."""
    return core_product(w.t(), x.t()).t() if x.device.type == "cuda" else x @ w


# ---------------------------------------------------------------------------
# The stack kernels B1 and B7 (`tc::stack_tc_kernel`).

def stack_smem(c: int, g: int, s: int, n_layers: int, cc: int = 0) -> tuple:
    """(bytes, weight slots) of the stack kernels' dynamic shared memory, as
    tc::stack_carve carves it on an H100: the ring's barriers and slots, h,
    the skip sum, two tap buffers, the dilations, the bf16 [h | tap (|
    cond)] and gate tiles, each start aligned to 16 bytes; as many slots as
    fit, at most MAX_SLOTS. `cc`: the folded conditioning channels (0:
    unconditioned). The library's `wn_*_tc_smem` must agree (checked before
    every launch)."""
    def carve(slots):
        off = 0
        for n in (8 * MAX_SLOTS, 8 * MAX_SLOTS, slots * SLOT, 4 * c * TB, 4 * s * TB,
                  4 * c * TB, 4 * c * TB, 4 * n_layers, 2 * TB * (2 * c + cc + 8),
                  2 * TB * (g + 8)):
            off = -(-off // 16) * 16 + n
        return off

    slots = min(MAX_SLOTS, max(0, SMEM_MAX - carve(0)) // SLOT)
    return carve(slots), slots


def stack_route(c: int, g: int, s: int, n_layers: int, dt, cc: int = 0) -> str:
    """Which kernel runs a stack step (B1 or B7) of widths (C, G, S) with S
    the skip slice it is given and `cc` folded conditioning channels (0:
    unconditioned), decided before the launch from the compute dtype and
    the widths: "tensor_cores" (tc::stack_tc_kernel) for bf16 with C, G, S
    and cc multiples of 16 (mma.sync tiles), C+S <= MAX_M, G <= MAX_GATES
    (the instantiated tiles per warp) and two weight slots beside the tile
    in shared memory; else "cuda_cores" (the first version's in-order fp32
    FMAs, any width)."""
    tiles = all(v >= 16 and v % 16 == 0 for v in (c, g, s)) and cc % 16 == 0
    if (dt == torch.bfloat16 and tiles and c + s <= MAX_M and g <= MAX_GATES
            and stack_smem(c, g, s, n_layers, cc)[1] >= 2):
        return "tensor_cores"
    return "cuda_cores"


def stack_default_order(c: int, g: int, s: int, n_layers: int, dt, device,
                        cc: int = 0) -> bool:
    """Whether the stack kernels' plain versions sum as the tensor-core
    route does: on a CUDA tensor (where they are the kernels' reference) on
    that route; on the CPU one fp32 sum per product."""
    return (torch.device(device).type == "cuda"
            and stack_route(c, g, s, n_layers, dt, cc) == "tensor_cores")


def pack_layers(mats: list, bg: torch.Tensor, brs: torch.Tensor, device) -> dict:
    """The stack kernels' operands, once per weight set: the packed stream
    of `mats` (layer_stream or fm_layer_stream), the gate biases bg (L, 2G)
    and [b_res | b_skip] brs (L, C+S) in fp32."""
    out = pack_stream(mats, device)
    out["bg"] = bg.to(device, torch.float32).contiguous()
    out["brs"] = brs.to(device, torch.float32).contiguous()
    return out


class StackArgs(ctypes.Structure):
    """tc::StackArgs."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "h0", "bufs", "dils", "wpk", "prods", "bg", "brs", "skip",
    )] + [(n, ctypes.c_int) for n in ("B", "L", "C", "G", "S", "t", "grid")] + [
        ("cond", ctypes.c_void_p), ("Cc", ctypes.c_int)]


def lib_stack_smem(lib, name: str, c: int, g: int, s: int, n_layers: int, cc: int = 0) -> int:
    """The built library's own count of stack_smem's bytes (`name`:
    "fused_stack" or "tp_fused_stack")."""
    f = build.entry(lib, f"wn_{name}_tc_smem", [ctypes.c_int] * 5, ctypes.c_longlong)
    return int(f(n_layers, c, g, s, cc))


def launch_stack(name: str, ops: dict, h0, bufs, dils, skip, dims: tuple, t: int,
                 device, cond=None) -> int:
    """One launch of the tensor-core stack kernel of csrc/ar_step.cu (name
    "fused_stack") or csrc/ar_tp.cu ("tp_fused_stack") on the current
    stream, after checking that the library carves shared memory as
    stack_smem reckons it. dims (B, L, C, G, S); `cond` the step's bf16
    conditioning, (B, Cc') lane-major for B1, (Cc', B) feature-major for
    B7, or None. Returns the launches."""
    b, n_layers, c, g, s = dims
    cc = 0 if cond is None else cond.shape[1 if name == "fused_stack" else 0]
    lib = build.load("ar_step" if name == "fused_stack" else "ar_tp")
    got = lib_stack_smem(lib, name, c, g, s, n_layers, cc)
    want = stack_smem(c, g, s, n_layers, cc)[0]
    if got != want:
        raise RuntimeError(f"the {name} library carves {got} bytes of shared memory at "
                           f"L={n_layers}, C={c}, G={g}, S={s}, Cc={cc}; ar_tc.stack_smem "
                           f"reckons {want}")
    args = StackArgs(build.ptr(h0), build.ptr(bufs), build.ptr(dils), build.ptr(ops["wpk"]),
                     build.ptr(ops["prods"]), build.ptr(ops["bg"]), build.ptr(ops["brs"]),
                     build.ptr(skip), b, n_layers, c, g, s, int(t), launch_shape(b)[0],
                     build.ptr(cond), cc)
    return build.launch(lib, f"wn_{name}_tc", args, device)
