"""Port tests: the frontend kernel pair's plain version (the CPU path of
`ops/cuda/frontend.fused_frontend`) against the JAX Pallas frontend in
interpret mode and against the JAX XLA `input_frontend`, values and every
gradient through autograd / jax.vjp."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu.config import ArchConfig as JArch
from lb_wavenet_tpu.models.wavenet import input_frontend as jfront
from lb_wavenet_tpu.ops.pallas.frontend import fused_frontend as jfused
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.models.wavenet import forward, init_params, rnd
from lb_wavenet_tpu_torch.ops.cuda import frontend as F
from lb_wavenet_tpu_torch.ops.cuda.train_stack import _shift_left

torch.set_num_threads(1)
Q, C = 256, 16
# Tolerances, as max |port - ref| over the leaf's max |ref|:
#  fp32: the same products summed in another order (1e-5 of h0, 1e-4 of
#  each gradient). bf16: the same bf16 operands; an fp32 sum in another
#  order can flip the bf16 rounding of one d_e piece (d_embed 4e-3, one
#  bf16 ulp, 2^-8, of the largest piece); the XLA
#  VJP rounds d_w and its embedding operand to bf16, the kernels do not
#  (d_w 1e-2 against XLA only).
TOL = {"float32": dict(h=1e-5, embed=1e-4, w=1e-4, b=1e-4, w_xla=1e-4),
       "bfloat16": dict(h=1e-5, embed=4e-3, w=1e-4, b=1e-4, w_xla=1e-2)}


def _inputs(seed, k_taps, b=2, t=300):
    """Numpy-seeded table, taps, bias, classes (0 and Q-1 at the head of
    the two rows) and a cotangent; T = 300 is a multiple of no tile."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((Q, C)).astype(np.float32)
    w = (rng.standard_normal((k_taps, C, C)) / 4).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    x = rng.integers(0, Q, (b, t)).astype(np.int32)
    x[0, 0], x[1 % b, 0] = 0, Q - 1
    dh = rng.standard_normal((b, t, C)).astype(np.float32)
    return emb, w, bias, x, dh


def _port(emb, w, bias, x, dh, dtype):
    pe, pw, pb = (torch.tensor(a, requires_grad=True) for a in (emb, w, bias))
    h = F.fused_frontend(pe, {"w": pw, "b": pb}, torch.from_numpy(x), compute_dtype=dtype)
    (h * torch.from_numpy(dh)).sum().backward()
    return h.detach().numpy(), pe.grad.numpy(), pw.grad.numpy(), pb.grad.numpy()


def _jax(fn, emb, w, bias, dh):
    h, vjp = jax.vjp(fn, jnp.asarray(emb), {"w": jnp.asarray(w), "b": jnp.asarray(bias)})
    d_emb, d_conv = vjp(jnp.asarray(dh))
    return tuple(np.asarray(a) for a in (h, d_emb, d_conv["w"], d_conv["b"]))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("k_taps", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontend_matches_jax_fused_and_xla(dtype, k_taps):
    emb, w, bias, x, dh = _inputs(k_taps, k_taps)
    got = _port(emb, w, bias, x, dh, dtype)
    fused = _jax(lambda e, c: jfused(e, c, jnp.asarray(x), compute_dtype=dtype,
                                     interpret=True), emb, w, bias, dh)
    arch = JArch(n_blocks=1, n_layers_per_block=2, residual_channels=C, skip_channels=C,
                 gate_channels=C, input_kernel=k_taps, compute_dtype=dtype)
    xla = _jax(lambda e, c: jfront({"embed": e, "input_conv": c}, arch, jnp.asarray(x),
                                   jnp.dtype(dtype)), emb, w, bias, dh)
    tol = TOL[dtype]
    for name, a, f, xl in zip(("h", "embed", "w", "b"), got, fused, xla):
        assert _rel(a, f) <= tol[name], (name, _rel(a, f))
        assert _rel(a, xl) <= tol["w_xla" if name == "w" else name], (name, _rel(a, xl))


def test_bf16_d_embed_needs_rounded_pieces():
    """Each class once (a permutation), so d_embed rows are single d_e rows.
    Against JAX's kernel, under 2% of the port's d_embed elements differ by
    more than 1e-6 of the largest (an fp32 sum in another order can flip the
    bf16 rounding of a piece); the same sum without the bf16 rounding of
    each tap's piece differs in most elements."""
    for seed in range(3):
        rng = np.random.default_rng(seed)
        emb, w, bias, _, dh = _inputs(10 + seed, 2, b=1, t=Q)
        x = rng.permutation(Q)[None].astype(np.int32)
        _, d_emb, _, _ = _port(emb, w, bias, x, dh, "bfloat16")
        _, want, _, _ = _jax(lambda e, c: jfused(e, c, jnp.asarray(x), interpret=True),
                             emb, w, bias, dh)
        dht, wt = torch.from_numpy(dh), torch.from_numpy(w)
        de = sum(_shift_left(dht @ rnd(wt[k], torch.bfloat16).T, 1 - k) for k in range(2))
        unrounded = torch.zeros(Q, C).index_add_(0, torch.from_numpy(x[0]).long(), de[0])

        def differ(a):
            return float(np.mean(np.abs(a - want) > 1e-6 * np.abs(want).max()))

        assert _rel(d_emb, want) <= TOL["bfloat16"]["embed"]
        assert differ(d_emb) < 0.02
        assert differ(unrounded.numpy()) > 0.5


def test_forward_with_fused_frontend_flag():
    """forward(fused_frontend=True) equals the unfused forward in fp32, and
    its frontend gradients equal autograd of the gather + conv; the
    sequence-parallel mask is ported: an all-ones mask changes nothing."""
    arch = PArch(n_blocks=1, n_layers_per_block=3, residual_channels=8, skip_channels=8,
                 gate_channels=8, compute_dtype="float32")
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 40)).astype(np.int32))
    outs = []
    for ff in (False, True):
        p = init_params(4, arch)
        for leaf in (p["embed"], p["input_conv"]["w"], p["input_conv"]["b"]):
            leaf.requires_grad_(True)
        logits = forward(p, arch, x, fused_frontend=ff)
        logits.square().mean().backward()
        outs.append((logits.detach(), p["embed"].grad, p["input_conv"]["w"].grad,
                     p["input_conv"]["b"].grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
    p = init_params(4, arch)
    kw = dict(compute_dtype="float32")
    torch.testing.assert_close(
        F.fused_frontend(p["embed"], p["input_conv"], x, input_mask=torch.ones(2, 40), **kw),
        F.fused_frontend(p["embed"], p["input_conv"], x, **kw), rtol=0, atol=0)


def test_out_of_range_classes_embed_to_zero():
    """A class outside [0, Q) behaves as the sentinel (zero row, no
    gradient), as the one-hot contraction of the TPU kernel does."""
    emb, w, bias, x, dh = _inputs(5, 2, b=1, t=20)
    x_bad = x.copy()
    x_bad[0, 7] = Q
    h, d_emb, _, _ = _port(emb, w, bias, x_bad, dh, "float32")
    want = _jax(lambda e, c: jfused(e, c, jnp.asarray(x_bad), compute_dtype="float32",
                                    interpret=True), emb, w, bias, dh)
    np.testing.assert_allclose(h, want[0], rtol=0, atol=1e-5 * np.abs(want[0]).max())
    np.testing.assert_allclose(d_emb, want[1], rtol=0, atol=1e-4 * np.abs(want[1]).max())


def test_fused_frontend_has_the_jax_signature():
    """fused_frontend(embed, conv, x_classes, input_mask, compute_dtype): the
    JAX wrapper's parameters less `interpret`."""
    import inspect

    jp = list(inspect.signature(jfused).parameters)
    pp = list(inspect.signature(F.fused_frontend).parameters)
    assert pp == [n for n in jp if n != "interpret"]
