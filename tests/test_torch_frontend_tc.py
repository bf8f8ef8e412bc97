"""The frontend pair's redesign on the CPU (`lb_wavenet_tpu_torch/ops/cuda/
frontend.py`): the route of the kernels, the shared-memory count it rests
on, and the plain versions that are the kernels' references (the per-class
tap table and its gather, d_e from dh split into bf16 hi + lo, d_w regrouped
by class) in both summation orders against the JAX package's Pallas
frontend (interpret mode) and its XLA `input_frontend`. The kernels
themselves run in `tests/test_torch_cuda.py`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu.config import ArchConfig as JArch
from lb_wavenet_tpu.models.wavenet import input_frontend as jfront
from lb_wavenet_tpu.ops.pallas.frontend import fused_frontend as jfused
from lb_wavenet_tpu_torch.models.wavenet import rnd
from lb_wavenet_tpu_torch.ops.cuda import frontend as F

from .test_torch_frontend import TOL, C, Q, _inputs, _jax, _rel

torch.set_num_threads(1)
BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("q,c,k,dt,want", [
    (256, 64, 2, BF16, "tensor_cores"),   # WaveNet-30 (every config in configs/)
    (256, 64, 1, BF16, "tensor_cores"),
    (256, 16, 3, BF16, "tensor_cores"),   # the tests' width
    (256, 64, 3, BF16, "cuda_cores"),     # four tables do not fit
    (256, 128, 2, BF16, "cuda_cores"),    # neither do three at C = 128
    (64, 128, 2, BF16, "cuda_cores"),     # they would; C is above 64
    (256, 32, 5, BF16, "cuda_cores"),     # 10 B fragments a warp, not 8
    (256, 32, 4, BF16, "tensor_cores"),   # 8
    (64, 16, 7, BF16, "tensor_cores"),    # 8 tables: a warp of the second half each
    (64, 16, 8, BF16, "cuda_cores"),      # 9 tables
    (256, 64, 2, FP32, "cuda_cores"),     # fp32: tensor cores would be TF32
    (256, 24, 2, BF16, "cuda_cores"),     # C not a multiple of 16
])
def test_route_and_default_order(q, c, k, dt, want):
    assert F.route(q, c, k, dt) == want
    assert F.default_order(torch.device("cuda"), q, c, k, dt) == (want == "tensor_cores")
    assert not F.default_order(torch.device("cpu"), q, c, k, dt)


@pytest.mark.parametrize("k,want", [
    # d_embed, G_0, G_1 tables and d_b; the bf16 hi and lo tiles (33 rows of
    # 72) and two fp32 landing tiles (33 rows of 64); the d_e tile (32 rows
    # of 64); two class rows of 36 ints; 3 x 32 group masks and 32 classes;
    # two 8-byte mbarriers
    (2, 4 * (3 * 256 * 64 + 64 + 33 * 72 + 2 * 33 * 64 + 32 * 64 + 2 * 36 + 96 + 32 + 4)),
    # K = 3: four tables and 34-row tiles, over a block's 232,448 bytes
    (3, 4 * (4 * 256 * 64 + 64 + 34 * 72 + 2 * 34 * 64 + 32 * 64 + 2 * 36 + 128 + 32 + 4)),
])
def test_tc_smem_arithmetic(k, want):
    assert F.tc_smem(256, 64, k) == want
    assert (want <= F.TC_SMEM_MAX) == (k == 2)
    assert F.tc_smem(256, 64, 2) == 232272


def _plain(emb, w, bias, x, dh, dt, tensor_cores):
    e, wt, b = (torch.from_numpy(a) for a in (emb, w, bias))
    h = F.frontend_fwd_plain(e, wt, b, torch.from_numpy(x), dt, tensor_cores)
    g = F.frontend_bwd_plain(e, wt, torch.from_numpy(x), dt, torch.from_numpy(dh), tensor_cores)
    return (h.numpy(), *(a.numpy() for a in g))


def _references(emb, w, bias, x, dh, dtype):
    fused = _jax(lambda e, c: jfused(e, c, jnp.asarray(x), compute_dtype=dtype,
                                     interpret=True), emb, w, bias, dh)
    arch = JArch(n_blocks=1, n_layers_per_block=2, residual_channels=C, skip_channels=C,
                 gate_channels=C, input_kernel=w.shape[0], compute_dtype=dtype)
    xla = _jax(lambda e, c: jfront({"embed": e, "input_conv": c}, arch, jnp.asarray(x),
                                   jnp.dtype(dtype)), emb, w, bias, dh)
    return fused, xla


def _check(got, fused, xla, dtype):
    """Each leaf against JAX's Pallas frontend and (unless None) its XLA one."""
    tol = TOL[dtype]
    for i, name in enumerate(("h", "embed", "w", "b")):
        assert _rel(got[i], fused[i]) <= tol[name], (name, _rel(got[i], fused[i]))
        if xla is not None:
            lim = tol["w_xla" if name == "w" else name]
            assert _rel(got[i], xla[i]) <= lim, (name, _rel(got[i], xla[i]))


@pytest.mark.parametrize("k_taps", [1, 2, 3])
@pytest.mark.parametrize("dtype,tensor_cores", [
    ("bfloat16", True), ("bfloat16", False), ("float32", False)])
def test_plain_versions_match_jax(dtype, tensor_cores, k_taps):
    """The table forward, the (split) d_e and the regrouped d_w against JAX's
    Pallas frontend and its XLA frontend, at the tolerances of
    test_torch_frontend.py."""
    emb, w, bias, x, dh = _inputs(20 + k_taps, k_taps)
    dt = {"bfloat16": BF16, "float32": FP32}[dtype]
    got = _plain(emb, w, bias, x, dh, dt, tensor_cores)
    _check(got, *_references(emb, w, bias, x, dh, dtype), dtype)


@pytest.mark.parametrize("tensor_cores", [True, False])
def test_no_leak_across_batch_rows(tensor_cores):
    """B = 3 and T = 45 (a multiple of no tile): each row's h0 is the row
    computed alone, bit for bit, and the gradients of the batch are the sums
    of the rows' gradients (only the order of an fp32 sum differs); the
    batch also matches JAX."""
    emb, w, bias, x, dh = _inputs(31, 2, b=3, t=45)
    got = _plain(emb, w, bias, x, dh, BF16, tensor_cores)
    rows = [_plain(emb, w, bias, x[i:i + 1], dh[i:i + 1], BF16, tensor_cores) for i in range(3)]
    np.testing.assert_array_equal(got[0], np.concatenate([r[0] for r in rows]))
    for j in (1, 2, 3):
        want = sum(r[j] for r in rows)
        np.testing.assert_allclose(got[j], want, rtol=0, atol=1e-6 * np.abs(want).max())
    _check(got, *_references(emb, w, bias, x, dh, "bfloat16"), "bfloat16")


@pytest.mark.parametrize("tensor_cores", [True, False])
def test_invalid_classes_give_zero_rows_and_no_gradient(tensor_cores):
    """Classes outside [0, Q) (Q, -1, 1000) give a zero tap and add to no
    gradient: at K = 1 their h0 row is the bias exactly, and d_embed and d_w
    equal those of the same batch with their dh rows zeroed; JAX's Pallas
    frontend (whose one-hot of such a class is all zero) agrees."""
    emb, w, bias, x, dh = _inputs(41, 1, b=2, t=50)
    bad = [(0, 3), (0, 17), (1, 0), (1, 49)]
    for (i, t), v in zip(bad, (Q, -1, 1000, Q)):
        x[i, t] = v
    got = _plain(emb, w, bias, x, dh, BF16, tensor_cores)
    for i, t in bad:
        np.testing.assert_array_equal(got[0][i, t], bias)
    dz = dh.copy()
    for i, t in bad:
        dz[i, t] = 0.0
    zeroed = _plain(emb, w, bias, x, dz, BF16, tensor_cores)
    np.testing.assert_array_equal(got[1], zeroed[1])
    np.testing.assert_allclose(got[2], zeroed[2], rtol=0, atol=1e-6 * np.abs(got[2]).max())
    _check(got, _references(emb, w, bias, x, dh, "bfloat16")[0], None, "bfloat16")


def test_split_d_e_carries_dh_to_bf16_squared():
    """hi + lo of dh is within 2^-16 of dh, relative to each element (the
    kernel's two exact bf16 products carry no more than that error), and a
    d_e piece summed as the tensor cores sum hi and lo equals the one-fp32-sum
    piece before rounding within 2^-15 of its largest element."""
    rng = np.random.default_rng(5)
    dh = torch.from_numpy(rng.standard_normal((4, 64, C)).astype(np.float32))
    w = rnd(torch.from_numpy((rng.standard_normal((C, C)) / 4).astype(np.float32)), BF16)
    hi, lo = F._split_bf16(dh)
    assert float(((hi + lo - dh).abs() / dh.abs()).max()) <= 2.0 ** -16
    split = F.tc_mm(hi, w.T) + F.tc_mm(lo, w.T)
    one = dh @ w.T
    assert float((split - one).abs().max()) <= 2.0 ** -15 * float(one.abs().max())


def test_tc_slots_one_per_sm_at_most_one_per_tile():
    assert F.tc_slots(8, 13310, 132) == 132
    assert F.tc_slots(1, 45, 132) == 2
    assert F.tc_slots(3, 32, 132) == 3
