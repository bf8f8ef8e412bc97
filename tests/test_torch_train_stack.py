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
from lb_wavenet_tpu_torch.ops.cuda import ar_tc
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
    """The conditioned and the masked stacks are ported and want their
    cond and mask exactly when built with has_cond and has_mask; a device
    that is neither cpu nor cuda raises."""
    parch = PArch(**dataclasses.asdict(MICRO))
    h, lp0 = torch.zeros((B, T, 8)), {k: torch.tensor(np.asarray(v)) for k, v in
                                      init_params(jax.random.key(0), MICRO)["layers"].items()}
    with pytest.raises(ValueError, match="has_cond=True"):
        TS.make_fused_stack(parch, has_cond=True)(lp0, h)
    with pytest.raises(ValueError, match="has_cond=False"):
        TS.make_fused_stack(parch)(lp0, h, torch.zeros((B, T, 8)))
    with pytest.raises(ValueError, match="has_mask=True"):
        TS.make_fused_stack(parch, has_mask=True)(lp0, h)
    lp = {k: torch.zeros(v.shape, device="meta")
          for k, v in init_params(jax.random.key(0), MICRO)["layers"].items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        TS.make_fused_stack(parch)(lp, torch.zeros((B, T, 8), device="meta"))


STACK_ROUTES = [
    ("micro_fp32", 8, 8, 16, torch.float32, "cuda_cores"),
    ("wavenet30_fp32", 64, 64, 256, torch.float32, "cuda_cores"),
    ("small_bf16", 16, 16, 32, torch.bfloat16, "tensor_cores"),
    ("wavenet30_bf16", 64, 64, 256, torch.bfloat16, "tensor_cores"),
    ("s1024_small_bf16", 16, 16, 1024, torch.bfloat16, "tensor_cores"),
    ("stress_gen_bf16", 64, 64, 512, torch.bfloat16, "tensor_cores"),
    ("s1024_bf16", 64, 64, 1024, torch.bfloat16, "tensor_cores"),
    ("c256_bf16", 256, 256, 256, torch.bfloat16, "cuda_cores"),
    ("c24_bf16", 24, 24, 32, torch.bfloat16, "cuda_cores"),
    ("micro_bf16", 8, 8, 16, torch.bfloat16, "cuda_cores"),
]


@pytest.mark.parametrize("name,c,g,s,dt,want", STACK_ROUTES, ids=[r[0] for r in STACK_ROUTES])
def test_stack_route_from_dtype_and_widths(name, c, g, s, dt, want):
    """TS.route: bf16 with C, G, S multiples of 16 whose tiles fit in a
    block's shared memory takes the tensor cores; fp32 (tensor cores would
    be TF32) and any other bf16 width the CUDA-core kernels."""
    assert TS.route(c, g, s, dt) == want
    if want == "tensor_cores":
        assert TS.tc_smem(c, g, s) <= TS.TC_SMEM_MAX


def test_stack_route_shared_memory_limit():
    """The tensor-core kernels stage a layer's weights and a 64-position tile
    of every operand, S in passes of 256 columns: at C=G=64 any S fits
    (WaveNet-30's 256 in one pass; the stress config's 512 and 1024 in the
    same bytes); C=G=256 does not and takes the CUDA-core route. That
    route's skip pass caps S at 512 (fp32 at S=1024 raises)."""
    assert TS.tc_smem(64, 64, 256) < TS.tc_smem(64, 64, 512) == TS.tc_smem(64, 64, 1024)
    assert TS.tc_smem(64, 64, 1024) <= TS.TC_SMEM_MAX < TS.tc_smem(256, 256, 256)
    assert TS.route(64, 64, 1024, torch.bfloat16) == "tensor_cores"
    assert TS.route(256, 256, 256, torch.bfloat16) == "cuda_cores"
    lp = {"w_cur": torch.zeros(2, 64, 128), "w_res": torch.zeros(2, 64, 64),
          "w_skip": torch.zeros(2, 64, 1024)}
    TS._check_shapes(lp, torch.zeros(1, 8, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="S <= 512"):
        TS._check_shapes(lp, torch.zeros(1, 8, 64), torch.float32)


@pytest.mark.parametrize("tapcat", [False, True])
@pytest.mark.parametrize("tensor_cores", [False, True])
def test_stack_bf16_at_tensor_core_widths_matches_jax(tapcat, tensor_cores):
    """bf16 at widths the tensor-core route takes (C = G = 16, S = 32): the
    plain versions summed as that route sums on the card (tc_mm: one mma
    from zero per 16-deep k-step, added in order) or as the CPU sums by
    default (one fp32 product), against JAX's Pallas kernels (interpret
    mode) within 2e-2: the same bf16-rounded operands, fp32 sums in
    another order."""
    from lb_wavenet_tpu.config import ArchConfig as JArch

    arch = JArch(n_blocks=1, n_layers_per_block=4, residual_channels=16, skip_channels=32,
                 gate_channels=16, compute_dtype="bfloat16")
    lp, h0, g = _case(arch, 8)
    want = _jax_fused(arch, lp, h0, g, tapcat)
    tl = {k: torch.tensor(v) for k, v in lp.items()}
    dils, dt = tuple(arch.dilations), torch.bfloat16
    assert TS.route(16, 16, 32, dt) == "tensor_cores"
    assert not TS.default_order("cpu", 16, 16, 32, dt)
    skip, z, x = TS.stack_fwd_plain(tl, torch.tensor(h0), dils, dt, tapcat, tensor_cores)
    dh0, grads = TS.stack_bwd_plain(tl, dils, dt, tapcat, z, x, torch.tensor(g), tensor_cores)
    _close(skip.numpy(), want[0], 2e-2, "skip")
    _close(dh0.numpy(), want[1], 2e-2, "dh0")
    for k in want[2]:
        _close(grads[k].numpy(), want[2][k], 2e-2, f"layers.{k}")


def test_tc_mm_is_the_tensor_core_sum():
    """tc_mm equals ar_tc's model of the kernels' sums on any leading
    shape (the row chunks do not change a row's sum)."""
    rng = np.random.default_rng(9)
    a = torch.tensor(rng.standard_normal((3, 5, 32)), dtype=torch.bfloat16).float()
    w = torch.tensor(rng.standard_normal((32, 16)), dtype=torch.bfloat16).float()
    got = TS.tc_mm(a, w)
    assert got.shape == (3, 5, 16)
    assert torch.equal(got.reshape(15, 16), ar_tc.tc_mm(a.reshape(15, 32), w))
    assert float((got - a @ w).abs().max()) <= 1e-5 * float((a.abs() @ w.abs()).max())
