"""Port tests: the training-stack kernel pair (its plain version on the CPU)
against the JAX package's Pallas kernels in interpret mode and against the
XLA layer loop: the skip sum, dh0 and every layer-weight gradient."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu.models.wavenet import gated_unit, init_params, shift_right
from lb_wavenet_tpu.ops.pallas.train_stack import make_fused_stack as jmake
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

from .util import MICRO

torch.set_num_threads(1)
B, T = 2, 48
RTOL = 1e-4   # fp32: the same products summed in another order


def _case(arch, seed):
    """Layer weights, h0 and a skip cotangent from one numpy seed."""
    lp = {k: np.asarray(v) for k, v in init_params(jax.random.key(seed), arch)["layers"].items()}
    rng = np.random.default_rng(seed)
    h0 = rng.standard_normal((B, T, arch.residual_channels)).astype(np.float32)
    g = rng.standard_normal((B, T, arch.skip_channels)).astype(np.float32)
    return lp, h0, g


def _jax_fused(arch, lp, h0, g, tapcat):
    fused = jmake(arch, has_cond=False, interpret=True, tapcat=tapcat)
    dummy = jnp.zeros((B, T, 1))

    def loss(lp, h0):
        return jnp.sum(fused(lp, h0, dummy) * g)

    skip = fused(lp, jnp.asarray(h0), dummy)
    dlp, dh0 = jax.grad(loss, argnums=(0, 1))(lp, jnp.asarray(h0))
    return np.asarray(skip), np.asarray(dh0), {k: np.asarray(v) for k, v in dlp.items()}


def _jax_xla(arch, lp, h0, g):
    """The XLA reference: the layer loop and the stacked skip contraction
    of models/wavenet.forward."""
    dt = jnp.dtype(arch.compute_dtype)

    def stack(lp, h):
        zs = []
        for i, d in enumerate(arch.dilations):
            h, z = gated_unit(h, shift_right(h, d), lp, i, dt)
            zs.append(z)
        return jnp.einsum("lbtg,lgs->bts", jnp.stack(zs), lp["w_skip"]) + lp["b_skip"].sum(0)

    skip = jax.jit(stack)(lp, jnp.asarray(h0))
    dlp, dh0 = jax.jit(jax.grad(lambda lp, h: jnp.sum(stack(lp, h) * g), argnums=(0, 1)))(
        lp, jnp.asarray(h0))
    return np.asarray(skip), np.asarray(dh0), {k: np.asarray(v) for k, v in dlp.items()}


def _port(arch, lp, h0, g, tapcat):
    parch = PArch(**dataclasses.asdict(arch))
    tl = {k: torch.tensor(v, requires_grad=True) for k, v in lp.items()}
    th = torch.tensor(h0, requires_grad=True)
    skip = TS.make_fused_stack(parch, tapcat=tapcat)(tl, th)
    (skip * torch.from_numpy(g)).sum().backward()
    return (skip.detach().numpy(), th.grad.numpy(),
            {k: v.grad.numpy() for k, v in tl.items()})


def _close(got, want, rtol, what):
    """Each leaf within rtol of its largest magnitude."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale, err_msg=what)


@pytest.mark.parametrize("tapcat", [False, True])
def test_stack_matches_jax_pallas_kernels(tapcat):
    lp, h0, g = _case(MICRO, 3)
    want = _jax_fused(MICRO, lp, h0, g, tapcat)
    got = _port(MICRO, lp, h0, g, tapcat)
    _close(got[0], want[0], RTOL, "skip")
    _close(got[1], want[1], RTOL, "dh0")
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        _close(got[2][k], want[2][k], RTOL, f"layers.{k}")


@pytest.mark.parametrize("tapcat", [False, True])
def test_stack_matches_xla_layer_loop(tapcat):
    lp, h0, g = _case(MICRO, 4)
    want = _jax_xla(MICRO, lp, h0, g)
    got = _port(MICRO, lp, h0, g, tapcat)
    _close(got[0], want[0], RTOL, "skip")
    _close(got[1], want[1], RTOL, "dh0")
    for k in want[2]:
        _close(got[2][k], want[2][k], RTOL, f"layers.{k}")


def test_stack_bf16_matches_jax_pallas_kernels():
    """bf16 operands: a rounding flip of one operand moves a sum by ~1e-2
    of its size; both sides store z in bf16."""
    arch = dataclasses.replace(MICRO, compute_dtype="bfloat16")
    lp, h0, g = _case(arch, 5)
    want = _jax_fused(arch, lp, h0, g, True)
    got = _port(arch, lp, h0, g, True)
    _close(got[0], want[0], 2e-2, "skip")
    _close(got[1], want[1], 2e-2, "dh0")
    for k in want[2]:
        _close(got[2][k], want[2][k], 2e-2, f"layers.{k}")


def _port_xla(arch, lp, h0, g):
    """The port's unfused stack through autograd (models/wavenet.py)."""
    from lb_wavenet_tpu_torch.models import wavenet as PW

    parch = PArch(**dataclasses.asdict(arch))
    dt = PW.compute_dtype(parch)
    tl = {k: torch.tensor(v, requires_grad=True) for k, v in lp.items()}
    th = torch.tensor(h0, requires_grad=True)
    h, zs = th, []
    for i, d in enumerate(parch.dilations):
        h, z = PW.gated_unit(h, PW.shift_right(h, d), tl, i, dt)
        zs.append(z)
    skip = torch.einsum("lbtg,lgs->bts", PW.rnd(torch.stack(zs), dt),
                        PW.rnd(tl["w_skip"], dt)) + tl["b_skip"].sum(0)
    (skip * torch.from_numpy(g)).sum().backward()
    return th.grad.numpy(), {k: v.grad.numpy() for k, v in tl.items()}


def test_stack_bf16_fused_vs_unfused_gap_matches_jax():
    """In bf16 the fused backward rounds only the products' operands, while
    autodiff of the unfused stack also rounds every cotangent that enters a
    bf16 product. JAX's Pallas-vs-XLA gradients differ by that much too:
    the port's fused-vs-unfused gap is of the same size as JAX's."""
    arch = dataclasses.replace(MICRO, compute_dtype="bfloat16")
    lp, h0, g = _case(arch, 5)
    jf, jx = _jax_fused(arch, lp, h0, g, True), _jax_xla(arch, lp, h0, g)
    pf, px = _port(arch, lp, h0, g, True), _port_xla(arch, lp, h0, g)

    def gaps(fused, ref):   # per gradient leaf, over the leaf's largest value
        return {k: np.abs(fused[k] - ref[k]).max() / np.abs(ref[k]).max()
                for k in ref if np.abs(ref[k]).max() > 0}

    want = gaps({**jf[2], "dh0": jf[1]}, {**jx[2], "dh0": jx[1]})
    got = gaps({**pf[2], "dh0": pf[1]}, {**px[1], "dh0": px[0]})
    assert max(want.values()) > 1e-3   # the rounding gap is there in JAX
    assert max(got.values()) <= 2 * max(want.values()), (got, want)
    assert max(want.values()) <= 2 * max(got.values()), (got, want)


def test_plain_backward_matches_autograd_of_plain_forward():
    """The hand-written backward (fp32) against torch autograd through the
    plain forward, which shares no backward code with it."""
    parch = PArch(**dataclasses.asdict(MICRO))
    lp, h0, g = _case(MICRO, 6)
    tl = {k: torch.tensor(v, requires_grad=True) for k, v in lp.items()}
    th = torch.tensor(h0, requires_grad=True)
    skip, z_all, x_all = TS.stack_fwd_plain(tl, th, parch.dilations, torch.float32, False)
    (skip * torch.from_numpy(g)).sum().backward()
    dh0, grads = TS.stack_bwd_plain({k: v.detach() for k, v in tl.items()},
                                    parch.dilations, torch.float32, False,
                                    z_all.detach(), x_all.detach(), torch.from_numpy(g))
    _close(dh0.numpy(), th.grad.numpy(), RTOL, "dh0")
    for k in tl:
        _close(grads[k].numpy(), tl[k].grad.numpy(), RTOL, k)
    assert z_all.shape == (len(parch.dilations), B, T, parch.gate_channels)
    assert x_all.shape == (len(parch.dilations), B, T, parch.residual_channels)


def test_unported_variants_and_devices_raise():
    parch = PArch(**dataclasses.asdict(MICRO))
    with pytest.raises(NotImplementedError, match="A queue item 4"):
        TS.make_fused_stack(parch, has_cond=True)
    with pytest.raises(NotImplementedError, match="A queue item 7"):
        TS.make_fused_stack(parch, has_mask=True)
    lp = {k: torch.zeros(v.shape, device="meta")
          for k, v in init_params(jax.random.key(0), MICRO)["layers"].items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        TS.make_fused_stack(parch)(lp, torch.zeros((B, T, 8), device="meta"))
