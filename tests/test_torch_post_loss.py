"""Port tests: the post-loss kernel pair (its plain version on the CPU)
against the JAX package's Pallas kernels in interpret mode and against the
XLA post network + masked CE: the numerator, dskip and the post-weight
gradients, on a boundary-masked batch whose rows begin with an unscored
receptive-field head."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu.models.wavenet import init_params, masked_loss_sums, post_network
from lb_wavenet_tpu.ops.pallas.post_loss import fused_post_loss as jpost
from lb_wavenet_tpu_torch.models import wavenet as PW
from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL

from .util import MICRO

torch.set_num_threads(1)
B, T, W = 3, 56, 40   # head = 16 rows
RTOL = 1e-4           # fp32: the same products summed in another order
ARCH = dataclasses.replace(MICRO, skip_channels=16)


def _case(arch, seed):
    post = {k: np.asarray(v) for k, v in init_params(jax.random.key(seed), arch)["post"].items()}
    rng = np.random.default_rng(seed)
    skip = rng.standard_normal((B, T, arch.skip_channels)).astype(np.float32)
    tgt = rng.integers(0, arch.quant_channels, (B, W)).astype(np.int32)
    mask = (rng.random((B, W)) > 0.2).astype(np.float32)
    mask[0, :7] = 0.0   # a file start inside the window
    return post, skip, tgt, mask


def _port(post, skip, tgt, mask, dtype):
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in post.items()}
    ts = torch.tensor(skip, requires_grad=True)
    num = PL.fused_post_loss(tp, ts, torch.from_numpy(tgt), torch.from_numpy(mask), W, dtype)
    (num * 0.37).backward()
    return float(num.detach()), ts.grad.numpy(), {k: v.grad.numpy() for k, v in tp.items()}


def _close(got, want, rtol, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("dtype,rtol", [("float32", RTOL), ("bfloat16", 2e-2)])
def test_post_loss_matches_jax_pallas_kernels(dtype, rtol):
    post, skip, tgt, mask = _case(ARCH, 1)

    def f(post, skip):
        return 0.37 * jpost(post, skip, tgt, mask, W, compute_dtype=dtype, interpret=True)

    num_j, (dpost_j, dskip_j) = jax.value_and_grad(f, argnums=(0, 1))(post, jnp.asarray(skip))
    num, dskip, dpost = _port(post, skip, tgt, mask, dtype)
    assert abs(0.37 * num - float(num_j)) <= rtol * abs(float(num_j))
    _close(dskip, np.asarray(dskip_j), rtol, "dskip")
    assert not dskip[:, :T - W].any(), "head rows must get exactly zero dskip"
    for k in dpost:
        _close(dpost[k], np.asarray(dpost_j[k]), rtol, f"post.{k}")


def test_post_loss_matches_xla_post_network_and_ce():
    post, skip, tgt, mask = _case(ARCH, 2)

    def f(post, skip):
        logits = post_network({"post": post}, skip, jnp.float32)
        return 0.37 * masked_loss_sums(logits, tgt, mask, W)[0]

    num_j, (dpost_j, dskip_j) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        post, jnp.asarray(skip))
    num, dskip, dpost = _port(post, skip, tgt, mask, "float32")
    assert abs(0.37 * num - float(num_j)) <= RTOL * abs(float(num_j))
    _close(dskip, np.asarray(dskip_j), RTOL, "dskip")
    for k in dpost:
        _close(dpost[k], np.asarray(dpost_j[k]), RTOL, f"post.{k}")


def test_masked_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((B, T, 256)).astype(np.float32) * 3
    _, _, tgt, mask = _case(ARCH, 3)
    num_j, den_j = masked_loss_sums(jnp.asarray(logits), tgt, mask, W)
    num, den = PW.masked_loss_sums(torch.from_numpy(logits), torch.from_numpy(tgt),
                                   torch.from_numpy(mask), W)
    assert abs(float(num) - float(num_j)) <= 1e-5 * abs(float(num_j))
    assert float(den) == float(den_j)
    loss = PW.masked_loss(torch.from_numpy(logits), torch.from_numpy(tgt),
                          torch.from_numpy(mask), W)
    assert abs(float(loss) - float(num_j) / float(den_j)) <= 1e-5 * float(loss)


def test_plain_backward_matches_autograd_of_plain_forward():
    post, skip, tgt, mask = _case(ARCH, 4)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in post.items()}
    ts = torch.tensor(skip, requires_grad=True)
    PL.post_loss_plain(tp, ts, torch.from_numpy(tgt), torch.from_numpy(mask), W,
                       torch.float32).backward()
    dskip, grads = PL.post_loss_bwd_plain(
        {k: v.detach() for k, v in tp.items()}, ts.detach(), torch.from_numpy(tgt),
        torch.from_numpy(mask), W, torch.float32, torch.tensor(1.0))
    _close(dskip.numpy(), ts.grad.numpy(), RTOL, "dskip")
    for k in tp:
        _close(grads[k].numpy(), tp[k].grad.numpy(), RTOL, k)
