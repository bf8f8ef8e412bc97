"""Port tests: the sequence-parallel halo mask (the TPU kernels' has_mask /
input_mask) on the CPU. The masked frontend and training-stack pairs' plain
versions (both summation orders) against JAX's `fused_frontend(...,
input_mask=)` and `make_fused_stack(has_mask=True)` in interpret mode,
values and every gradient through autograd; the port's `forward(...,
input_mask=)` against JAX's with nonzero biases; masked rows exactly 0; an
all-ones mask bit for bit the unmasked function; the mask gets no
gradient."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu.config import ArchConfig
from lb_wavenet_tpu.models.wavenet import forward as jforward
from lb_wavenet_tpu.models.wavenet import init_params as jinit
from lb_wavenet_tpu.ops.pallas.frontend import fused_frontend as jfused
from lb_wavenet_tpu.ops.pallas.train_stack import make_fused_stack as jmake
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.models.wavenet import forward as pforward
from lb_wavenet_tpu_torch.ops.cuda import frontend as F
from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS
from lb_wavenet_tpu_torch.utils.convert import params_from_jax

from .util import MICRO

torch.set_num_threads(1)
# Tolerances (max |port - JAX| over the leaf's max |JAX|), as
# tests/test_torch_tc.py states them: fp32, the same products summed in
# another order; bf16, an fp32 sum in another order can flip a bf16 rounding
# of an activation, which later layers carry.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, T = 2, 48
# Widths the tensor-core routes take (C, G, Cc' multiples of 16), bf16.
TC = ArchConfig(n_blocks=1, n_layers_per_block=4, residual_channels=16, skip_channels=32,
                gate_channels=16, compute_dtype="bfloat16")


def _halo_mask(b=B, t=T, halo=15):
    """Rank 0's halo mask: row 0's first `halo` positions 0 (before its
    sequence), row 1 all ones (an interior shard)."""
    m = np.ones((b, t), np.float32)
    m[0, :halo] = 0.0
    return m


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


# ---------------------------------------------------------------------------
# The frontend pair.

def _front_inputs(seed, q=256, c=16, k=2):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((q, c)).astype(np.float32)
    w = (rng.standard_normal((k, c, c)) / 4).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)   # nonzero: it must not leak
    x = rng.integers(0, q, (B, T)).astype(np.int32)
    dh = rng.standard_normal((B, T, c)).astype(np.float32)
    return emb, w, bias, x, dh


def _jax_front(emb, w, bias, x, dh, mask, dtype):
    fn = lambda e, c: jfused(e, c, jnp.asarray(x), input_mask=jnp.asarray(mask),  # noqa: E731
                             compute_dtype=dtype, interpret=True)
    h, vjp = jax.vjp(fn, jnp.asarray(emb), {"w": jnp.asarray(w), "b": jnp.asarray(bias)})
    d_emb, d_conv = vjp(jnp.asarray(dh))
    return [np.asarray(a) for a in (h, d_emb, d_conv["w"], d_conv["b"])]


def _plain_front(emb, w, bias, x, dh, mask, dt, tensor_cores):
    args = [torch.from_numpy(a) for a in (emb, w, bias, x)]
    m = None if mask is None else torch.from_numpy(mask)
    h = F.frontend_fwd_plain(*args, dt, tensor_cores=tensor_cores, mask=m)
    grads = F.frontend_bwd_plain(args[0], args[1], args[3], dt, torch.from_numpy(dh),
                                 tensor_cores=tensor_cores, mask=m)
    return [h.numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("dtype,tensor_cores", [("float32", False), ("bfloat16", False),
                                                ("bfloat16", True)])
def test_masked_frontend_matches_jax(dtype, tensor_cores):
    """h0 and d_embed, d_w, d_b of the masked plain versions (both orders in
    bf16) against JAX's masked Pallas frontend; h0's masked rows exactly 0
    despite the bias."""
    emb, w, bias, x, dh = _front_inputs(1)
    mask = _halo_mask()
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = _plain_front(emb, w, bias, x, dh, mask, dt, tensor_cores)
    want = _jax_front(emb, w, bias, x, dh, mask, dtype)
    tol = dict(zip(("h0", "d_embed", "d_w", "d_b"),
                   (1e-5, 1e-4, 1e-4, 1e-4) if dtype == "float32" else (1e-5, 4e-3, 1e-4, 1e-4)))
    for (name, t), g, wv in zip(tol.items(), got, want):
        _close(g, wv, t, name)
    assert np.all(got[0][mask == 0] == 0.0) and np.all(want[0][mask == 0] == 0.0)


def test_masked_frontend_through_autograd_and_all_ones():
    """fused_frontend(input_mask=) through autograd equals the plain
    functions; the mask gets no gradient; an all-ones mask gives the
    unmasked values and gradients bit for bit."""
    emb, w, bias, x, dh = _front_inputs(2)
    outs = {}
    for name, mask in (("halo", _halo_mask()), ("ones", np.ones((B, T), np.float32)),
                       ("none", None)):
        pe, pw, pb = (torch.tensor(a, requires_grad=True) for a in (emb, w, bias))
        m = None if mask is None else torch.tensor(mask, requires_grad=True)
        h = F.fused_frontend(pe, {"w": pw, "b": pb}, torch.from_numpy(x), input_mask=m,
                             compute_dtype="bfloat16")
        (h * torch.from_numpy(dh)).sum().backward()
        assert m is None or m.grad is None
        outs[name] = [h.detach().numpy(), pe.grad.numpy(), pw.grad.numpy(), pb.grad.numpy()]
    plain = _plain_front(emb, w, bias, x, dh, _halo_mask(), torch.bfloat16, False)
    for a, b in zip(outs["halo"], plain):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(outs["ones"], outs["none"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The training-stack pair.

def _stack_case(arch, seed, cc=0):
    """Layer weights (with a w_cond of cc channels), h0 masked as the
    masked frontend gives it, cond and a skip cotangent."""
    lp = {k: np.asarray(v) for k, v in jinit(jax.random.key(seed), arch)["layers"].items()
          if k in TS.LAYER_KEYS}
    rng = np.random.default_rng(seed)
    for k in ("b", "b_res", "b_skip"):     # nonzero biases: they must not leak
        lp[k] = (0.2 * rng.standard_normal(lp[k].shape)).astype(np.float32)
    if cc:
        lp["w_cond"] = (rng.standard_normal((len(arch.dilations), cc, 2 * arch.gate_channels))
                        / np.sqrt(cc)).astype(np.float32)
    mask = _halo_mask()
    h0 = rng.standard_normal((B, T, arch.residual_channels)).astype(np.float32)
    h0 *= mask[..., None]
    cond = rng.standard_normal((B, T, cc or 1)).astype(np.float32)
    g = rng.standard_normal((B, T, arch.skip_channels)).astype(np.float32)
    return lp, h0, cond, g, mask


def _jax_stack(arch, lp, h0, cond, g, mask, tapcat, has_cond):
    fused = jmake(arch, has_cond=has_cond, interpret=True, tapcat=tapcat, has_mask=True)
    m = jnp.asarray(mask)
    skip = fused(lp, jnp.asarray(h0), jnp.asarray(cond), m)
    dlp, dh0, dcond = jax.grad(lambda lp, h, c: jnp.sum(fused(lp, h, c, m) * g),
                               argnums=(0, 1, 2))(lp, jnp.asarray(h0), jnp.asarray(cond))
    return (np.asarray(skip), np.asarray(dh0), np.asarray(dcond),
            {k: np.asarray(v) for k, v in dlp.items()})


def _port_stack(arch, lp, h0, cond, g, mask, tapcat, has_cond):
    parch = PArch(**dataclasses.asdict(arch))
    tl = {k: torch.tensor(v, requires_grad=True) for k, v in lp.items()}
    th = torch.tensor(h0, requires_grad=True)
    tc = torch.tensor(cond, requires_grad=True)
    tm = torch.tensor(mask, requires_grad=True)
    fused = TS.make_fused_stack(parch, has_cond=has_cond, tapcat=tapcat, has_mask=True)
    skip = fused(tl, th, tc, tm) if has_cond else fused(tl, th, tm)
    (skip * torch.from_numpy(g)).sum().backward()
    assert tm.grad is None
    return (skip.detach().numpy(), th.grad.numpy(),
            tc.grad.numpy() if has_cond else None, {k: v.grad.numpy() for k, v in tl.items()})


@pytest.mark.parametrize("arch,tapcat,cc", [(MICRO, False, 0), (MICRO, True, 8),
                                            (TC, True, 0), (TC, False, 16)],
                         ids=["fp32", "fp32_tapcat_cond", "bf16_tapcat", "bf16_cond"])
def test_masked_stack_matches_jax(arch, tapcat, cc):
    """make_fused_stack(has_mask=True) through autograd (the plain versions
    on the CPU) against JAX's make_fused_stack(has_mask=True) in interpret
    mode: skip, dh0, d cond and every layer-weight gradient."""
    lp, h0, cond, g, mask = _stack_case(arch, 3 + cc, cc)
    got = _port_stack(arch, lp, h0, cond, g, mask, tapcat, bool(cc))
    want = _jax_stack(arch, lp, h0, cond, g, mask, tapcat, bool(cc))
    tol = TOL[arch.compute_dtype]
    gtol = tol if arch.compute_dtype == "bfloat16" else 1e-4   # sums over all positions
    _close(got[0], want[0], tol, "skip")
    _close(got[1], want[1], gtol, "dh0")
    if cc:
        _close(got[2], want[2], gtol, "dcond")
    for k in want[3]:
        _close(got[3][k], want[3][k], gtol, f"layers.{k}")


@pytest.mark.parametrize("tensor_cores", [False, True])
def test_masked_stack_rows_zero_and_all_ones_exact(tensor_cores):
    """The plain versions in both orders: x_all's masked rows exactly 0 at
    every layer; an all-ones mask gives the unmasked forward and backward
    bit for bit (multiplying by 1.0 is exact); dh0 leaves unmasked as in
    JAX."""
    lp, h0, cond, g, mask = _stack_case(TC, 5, 16)
    t = {k: torch.from_numpy(v) for k, v in lp.items()}
    h, c, gs, m = (torch.from_numpy(a) for a in (h0, cond, g, mask))
    dt, dils = torch.bfloat16, TC.dilations
    kw = dict(tensor_cores=tensor_cores, cond=c)
    skip, z, x = TS.stack_fwd_plain(t, h, dils, dt, True, mask=m, **kw)
    assert torch.all(x[:, m == 0] == 0.0)
    dh0, _ = TS.stack_bwd_plain(t, dils, dt, True, z, x, gs, mask=m, **kw)
    assert torch.any(dh0[m == 0] != 0.0)
    ones = torch.ones_like(m)
    a = TS.stack_fwd_plain(t, h, dils, dt, True, mask=ones, **kw)
    b = TS.stack_fwd_plain(t, h, dils, dt, True, **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    da, ga = TS.stack_bwd_plain(t, dils, dt, True, *a[1:], gs, mask=ones, **kw)
    db, gb = TS.stack_bwd_plain(t, dils, dt, True, *b[1:], gs, **kw)
    assert torch.equal(da, db) and all(torch.equal(ga[k], gb[k]) for k in gb)


# ---------------------------------------------------------------------------
# The masked forward.

MEL = ArchConfig(n_blocks=1, n_layers_per_block=3, residual_channels=8, skip_channels=8,
                 gate_channels=8, n_mels=8, cond_channels=8, upsample_factors=(2, 2),
                 compute_dtype="float32")


def _perturbed(arch, seed):
    """JAX params with every leaf, biases included, moved off its init
    (JAX's regression case: zero biases hid a halo leak)."""
    jp = jinit(jax.random.key(seed), arch)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32), jp)


@pytest.mark.parametrize("arch,fused_frontend", [
    (MICRO, False), (MICRO, True), (dataclasses.replace(MICRO, compute_dtype="bfloat16"), True),
    (MEL, True)], ids=["fp32", "fp32_fused_frontend", "bf16_fused_frontend", "mel"])
def test_masked_forward_matches_jax(arch, fused_frontend):
    """forward(input_mask=) of the port against JAX's, nonzero biases,
    logits and every gradient (JAX's XLA forward: the masked embedding, the
    masked frontend output, the residual stream re-masked after every
    layer); with mel cond on the MEL arch."""
    np_params = _perturbed(arch, 7)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (B, T)).astype(np.int32)
    mask = _halo_mask()
    g = rng.standard_normal((B, T, arch.quant_channels)).astype(np.float32)
    frames = (rng.standard_normal((B, T // 4 + 1, arch.n_mels)).astype(np.float32)
              if arch.n_mels else None)

    def jloss(p):
        logits = jforward(p, arch, jnp.asarray(x), input_mask=jnp.asarray(mask),
                          cond_frames=None if frames is None else jnp.asarray(frames),
                          fused_frontend=fused_frontend)
        return jnp.sum(logits * g), logits

    (_, jl), jg = jax.value_and_grad(jloss, has_aux=True)(np_params)
    parch = PArch(**dataclasses.asdict(arch))
    pp = params_from_jax(np_params)
    leaves = jax.tree_util.tree_leaves_with_path(pp)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    logits = pforward(pp, parch, torch.from_numpy(x), input_mask=torch.from_numpy(mask),
                      cond_frames=None if frames is None else torch.from_numpy(frames),
                      fused_frontend=fused_frontend)
    (logits * torch.from_numpy(g)).sum().backward()
    tol = TOL[arch.compute_dtype]
    _close(logits.detach().numpy(), np.asarray(jl), tol, "logits")
    gtol = tol if arch.compute_dtype == "bfloat16" else 1e-4
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        node = pp
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        _close(node.grad.numpy(), np.asarray(want), gtol, jax.tree_util.keystr(path))
