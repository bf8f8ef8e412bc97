"""The host side of the tensor-core sampling kernels (bf16 mega and turbo,
`lb_wavenet_tpu_torch/ops/cuda/ar_tc.py`) on the CPU: the weight packing is
a permutation, a product read through the packed layout equals the plain
product, the launch shape covers every lane once, and `tc_product` (the
plain versions' model of the kernels' sums) reproduces mma results
recorded on an H100 and sums within fp32 rounding of the exact product;
at widths the kernels take, the bf16 plain versions in both summation
orders against the JAX package's mega and turbo kernels (interpret mode).
The sampling kernels themselves run in `tests/test_torch_cuda.py`."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from lb_wavenet_tpu_torch.config import ArchConfig
from lb_wavenet_tpu_torch.ops.cuda import ar_tc

SMALL = ArchConfig(n_blocks=2, n_layers_per_block=4, residual_channels=16,
                   skip_channels=32, gate_channels=16, compute_dtype="bfloat16")
WAVENET30 = ArchConfig(n_blocks=3, n_layers_per_block=10, residual_channels=64,
                       skip_channels=256, gate_channels=64, compute_dtype="bfloat16")
GOLDEN = os.path.join(os.path.dirname(__file__), "torch_goldens", "tc_mma_h100.npz")


def _stream_shapes(arch):
    """(K, M) of every matrix of a sample step at `arch`, and of the
    per-layer weights they are made of."""
    c, g, s, q, k = (arch.residual_channels, arch.gate_channels, arch.skip_channels,
                     arch.quant_channels, arch.input_kernel)
    finale = [(s, s), (s, q)] + [(c, c)] * k
    return sorted({(2 * c, 2 * g), (g, c + s), (c, 2 * g), (g, c), (g, s), *finale})


CASES = [(name, k, m) for name, arch in (("small", SMALL), ("wavenet30", WAVENET30))
         for k, m in _stream_shapes(arch)]


@pytest.mark.parametrize("name,k,m", CASES)
def test_pack_is_a_permutation(name, k, m):
    """unpack(pack(w)) == w, and the packed tensor holds each element once."""
    w = torch.arange(k * m, dtype=torch.float32).reshape(k, m)
    p = ar_tc.pack_mma(w)
    assert p.shape == (k // 16, m // 16, 32, 8)
    assert torch.equal(ar_tc.unpack_mma(p), w)
    assert torch.equal(p.reshape(-1).sort().values, w.reshape(-1))


@pytest.mark.parametrize("name,k,m", CASES)
def test_product_through_packed_layout(name, k, m):
    """The product read tile by tile from the lanes' fragments (the
    register layout of mma.sync.m16n8k16) equals W^T x; fp32 sums in
    another order, so within 1e-5 of the largest |entry|."""
    g = np.random.default_rng(k * 1000 + m)
    w = torch.tensor(g.standard_normal((k, m)) / np.sqrt(k), dtype=torch.float32)
    x = torch.tensor(g.standard_normal((k, 8)), dtype=torch.float32)
    got = ar_tc.mma_product_plain(ar_tc.pack_mma(w), x)
    want = (w.double().t() @ x.double()).float()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("batch", [1, 5, 8, 64, 100, 256, 512])
def test_launch_shape_covers_every_lane_once(batch):
    blocks, lanes = ar_tc.launch_shape(batch)
    tiles = ar_tc.lane_tiles(batch)
    assert len(tiles) == blocks == -(-batch // lanes) and lanes == ar_tc.TB
    covered = [b for first, n in tiles for b in range(first, first + n)]
    assert covered == list(range(batch))
    assert all(0 < n <= lanes and first == i * lanes for i, (first, n) in enumerate(tiles))


def test_tc_model_reproduces_recorded_mma():
    """tc_sum16 equals, bit for bit, mma.sync.m16n8k16 bf16 -> fp32 results
    from a zero accumulator recorded on an H100 by `python -m
    lb_wavenet_tpu_torch.tools.tc_calibrate` (half of the tiles with
    exponents spread over 2^-12..2^12)."""
    d = np.load(GOLDEN)
    a, b, want = (torch.tensor(d[k]) for k in ("a", "b", "d"))
    for i in range(len(a)):
        got = ar_tc.tc_sum16(a[i].reshape(16, 1, 16), b[i].reshape(1, 16, 8))[:, 0]
        assert torch.equal(got, want[i]), i


@pytest.mark.parametrize("k", [16, 64, 256])
def test_tc_product_is_an_fp32_sum(k):
    """tc_product rounds at most one fp32 step per k-step away from the
    exact product of the same bf16 values."""
    g = np.random.default_rng(k)
    w = torch.tensor(g.standard_normal((48, k)), dtype=torch.bfloat16).float()
    x = torch.tensor(g.standard_normal((k, 8)), dtype=torch.bfloat16).float()
    exact = w.double() @ x.double()
    scale = (w.double().abs() @ x.double().abs()).max()
    err = (ar_tc.tc_product(w, x).double() - exact).abs().max()
    assert float(err) <= 2 * (k // 16) * 2.0 ** -23 * float(scale)
    assert torch.equal(ar_tc.tc_mm(x.t(), w.t()), ar_tc.tc_product(w, x).t())


def test_unsupported_widths_raise_with_the_reason():
    """unsupported() names why a width leaves the tensor cores; those
    widths take the CUDA-core route instead of raising."""
    assert ar_tc.unsupported(SMALL) is None and ar_tc.unsupported(WAVENET30) is None
    odd = dataclasses.replace(SMALL, residual_channels=24)
    assert "residual_channels % 16" in ar_tc.unsupported(odd)
    wide = dataclasses.replace(WAVENET30, skip_channels=1024)
    assert "768 outputs" in ar_tc.unsupported(wide)
    gates = dataclasses.replace(WAVENET30, gate_channels=400)
    assert "384 gate channels" in ar_tc.unsupported(gates)
    for arch in (odd, wide, gates):
        assert ar_tc.route(arch, torch.bfloat16) == "cuda_cores"
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert not ar_tc.default_order(odd, torch.bfloat16, cuda)
    assert not ar_tc.default_order(SMALL, torch.float32, cuda)
    assert ar_tc.default_order(SMALL, torch.bfloat16, cuda)
    assert not ar_tc.default_order(SMALL, torch.bfloat16, cpu)


MICRO_BF16 = ArchConfig(n_blocks=1, n_layers_per_block=3, residual_channels=8,
                        skip_channels=16, gate_channels=8, compute_dtype="bfloat16")
ROUTES = [
    ("small", SMALL, {}, "tensor_cores"),
    ("wavenet30", WAVENET30, {}, "tensor_cores"),
    ("stress_s512", WAVENET30, {"skip_channels": 512}, "tensor_cores"),
    ("c24", SMALL, {"residual_channels": 24}, "cuda_cores"),
    ("s1024", WAVENET30, {"skip_channels": 1024}, "cuda_cores"),
    ("g400", WAVENET30, {"gate_channels": 400}, "cuda_cores"),
    ("q200", WAVENET30, {"quant_channels": 200}, "cuda_cores"),
    ("micro", MICRO_BF16, {}, "cuda_cores"),
]


@pytest.mark.parametrize("name,arch,change,want", ROUTES, ids=[r[0] for r in ROUTES])
def test_sampling_route_from_dtype_and_widths(name, arch, change, want):
    """ar_tc.route: bf16 at the widths the tensor-core kernels take goes to
    them, bf16 at any other width to the CUDA-core kernels; fp32 never
    goes to the tensor cores."""
    arch = dataclasses.replace(arch, **change)
    assert ar_tc.route(arch, torch.bfloat16) == want
    assert ar_tc.route(dataclasses.replace(arch, compute_dtype="float32"),
                       torch.float32) == "cuda_cores"
    assert (ar_tc.unsupported(arch) is None) == (want == "tensor_cores")


def _jax_pair(arch):
    import jax

    from lb_wavenet_tpu.config import ArchConfig as JArch
    from lb_wavenet_tpu.models.wavenet import init_params as jinit
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    jarch = JArch(**dataclasses.asdict(arch))
    jp = jinit(jax.random.key(5), jarch)
    return jp, jarch, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("engine", ["mega", "turbo"])
@pytest.mark.parametrize("order", ["tensor_cores", "cpu_default"])
def test_bf16_sampling_at_tensor_core_widths_matches_jax(engine, order):
    """bf16 at widths the tensor-core kernels take (SMALL: C = G = 16,
    S = 32, Q = 256): teacher-forced logits of the plain versions, summed as
    the kernels sum on the card (tensor_cores=True) or as the CPU entry
    point sums by default (one fp32 product), against JAX's generate_classes
    (its Pallas kernel in interpret mode) on the same weights, within 2e-2:
    the same bf16-rounded operands, fp32 sums in another order."""
    import jax
    import jax.numpy as jnp

    from lb_wavenet_tpu import generate as JG
    from lb_wavenet_tpu_torch import generate as PG
    from lb_wavenet_tpu_torch.ops.cuda import ar_mega, ar_turbo

    jp, jarch, pp = _jax_pair(SMALL)
    b, t = 8, 24
    forced = np.random.default_rng(6).integers(0, 256, (b, t)).astype(np.int32)
    _, jl = JG.generate_classes(jp, jarch, jax.random.key(0), b, t, forced=jnp.asarray(forced),
                                return_logits=True, engine=engine)
    if order == "cpu_default":
        assert not ar_tc.default_order(SMALL, torch.bfloat16, torch.device("cpu"))
        _, pl = PG.generate_classes(pp, SMALL, 0, b, t, forced=forced, return_logits=True,
                                    engine=engine, device="cpu")
    else:
        assert ar_tc.default_order(SMALL, torch.bfloat16, torch.device("cuda"))
        h0, e0 = PG._fused_frontend_zero(pp, SMALL, b)
        ft = torch.from_numpy(forced.T.copy())
        if engine == "mega":
            carry = ar_mega.mega_zero_carry(SMALL, h0, e0)
            _, pl = ar_mega.mega_generate_plain(pp, pp["layers"], SMALL, carry, 0, ft, 1.0,
                                                True, None, 0, tensor_cores=True)
            pl = pl.permute(2, 0, 1)
        else:
            state = {"bufs": torch.zeros((sum(SMALL.dilations), b, 16)), "h": h0, "e": e0}
            _, pl = ar_turbo.turbo_generate_plain(pp, pp["layers"], SMALL, state, 0, ft, 1.0,
                                                  True, None, 0, tensor_cores=True)
            pl = pl.transpose(0, 1)
    assert pl.shape == (b, t, 256)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=2e-2)


def _fma32(acc: float, w: float, x: float) -> float:
    """fmaf: acc + w * x computed exactly, rounded once to the nearest fp32
    (ties to even)."""
    from fractions import Fraction

    exact = Fraction(acc) + Fraction(w) * Fraction(x)
    f = np.float32(float(exact))
    lo, hi = (np.nextafter(f, np.float32(-np.inf)), f) if Fraction(float(f)) > exact \
        else (f, np.nextafter(f, np.float32(np.inf)))
    dlo, dhi = exact - Fraction(float(lo)), Fraction(float(hi)) - exact
    if dlo != dhi:
        return float(lo if dlo < dhi else hi)
    return float(lo if int(np.float32(lo).view(np.int32)) % 2 == 0 else hi)


def test_fma_product_is_the_in_order_fma_chain():
    """ar_tc.fma_product (the CUDA-core route's order on the card) equals
    an exact per-output chain of correctly rounded fp32 FMAs, k in order
    from zero, on fp32 and on bf16-valued operands; core_product keeps
    one fp32 product on the CPU."""
    rng = np.random.default_rng(3)
    w = torch.tensor(rng.standard_normal((3, 40)) * 4.0 ** rng.integers(-3, 4, (3, 40)),
                     dtype=torch.float32)
    x = torch.tensor(rng.standard_normal((40, 5)), dtype=torch.float32)
    for a, b in ((w, x), (w.bfloat16().float(), x.bfloat16().float())):
        got = ar_tc.fma_product(a, b)
        for i in range(a.shape[0]):
            for j in range(b.shape[1]):
                acc = 0.0
                for k in range(a.shape[1]):
                    acc = _fma32(acc, float(a[i, k]), float(b[k, j]))
                assert float(got[i, j]) == acc, (i, j)
    assert torch.equal(ar_tc.core_product(w, x), w @ x)
    assert torch.equal(ar_tc.core_mm(x.t(), w.t()), x.t() @ w.t())


def test_fma_double_roundings_are_counted():
    """fma_product's float64 step can round twice only on an fp32 midpoint:
    a constructed tie is caught (acc = 1 + 2^-23 plus a product just under
    half an ulp: float64 lands on the midpoint and ties to even, fmaf does
    not), and over 1,048,576 FMAs of random fp32 and of bf16-valued
    operands none occurs (bf16 operands cannot: the exact sum fits in
    float64 or the smaller term lies below the fp32 rounding threshold)."""
    w = torch.tensor([[1.0 + 2.0 ** -23, 1.0 + 2.0 ** -23]], dtype=torch.float32)
    x = torch.tensor([[1.0], [2.0 ** -24 * (1.0 - 2.0 ** -23)]], dtype=torch.float32)
    assert ar_tc.fma_double_roundings(w, x) == (1, 2)
    assert float(ar_tc.fma_product(w, x)) == 1.0 + 2.0 ** -22 != _fma32(
        1.0 + 2.0 ** -23, float(w[0, 1]), float(x[1, 0]))
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((64, 1024)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((1024, 16)), dtype=torch.float32)
    assert ar_tc.fma_double_roundings(a, b) == (0, 1048576)
    assert ar_tc.fma_double_roundings(a.bfloat16().float(), b.bfloat16().float()) == (0, 1048576)
