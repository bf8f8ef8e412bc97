"""The host side of the post-loss pair's tensor-core route
(`lb_wavenet_tpu_torch/ops/cuda/post_loss.py`) on the CPU: which widths and
dtypes take it, the shared-memory count it rests on, the packed weight
stream (a product read through the packed layout equals the plain
product), and both summation orders of the plain versions against the JAX
package's Pallas kernels (interpret mode) at bf16 widths the route takes.
The kernels themselves run in `tests/test_torch_cuda.py`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu.models.wavenet import init_params
from lb_wavenet_tpu.ops.pallas.post_loss import fused_post_loss as jpost
from lb_wavenet_tpu_torch.ops.cuda import ar_tc
from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL

from .util import MICRO

torch.set_num_threads(1)
BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("s,q,dt,want", [
    (256, 256, BF16, "tensor_cores"),    # WaveNet-30
    (512, 256, BF16, "tensor_cores"),    # the stress config
    (256, 256, FP32, "cuda_cores"),      # fp32: tensor cores would be TF32
    (24, 24, BF16, "cuda_cores"),        # not multiples of 16
    (1024, 256, BF16, "cuda_cores"),     # its tiles do not fit
    (256, 512, BF16, "cuda_cores"),      # logits wider than a tile keeps
])
def test_route_and_default_order(s, q, dt, want):
    assert PL.route(s, q, dt) == want
    assert PL.default_order(torch.device("cuda"), s, q, dt) == (want == "tensor_cores")
    assert not PL.default_order(torch.device("cpu"), s, q, dt)


@pytest.mark.parametrize("s,q,want", [
    # ring 4 x 16 KB, its barriers, two bf16 row tiles of 64 rows, row
    # statistics of 16 warps, three per-row vectors, u > 0 flags, db1 | db2
    (256, 256, 65536 + 64 + 2 * 64 * 264 * 2 + 2 * 16 * 64 * 4 + 3 * 64 * 4
     + 64 * 256 // 8 + 4 * 512),
    (512, 256, 65536 + 64 + 2 * 64 * 520 * 2 + 2 * 16 * 64 * 4 + 3 * 64 * 4
     + 2 * 64 * 256 // 8 + 4 * 768),
])
def test_tc_smem_arithmetic(s, q, want):
    assert PL.tc_smem(s, q) == want <= PL.TC_SMEM_MAX
    assert PL.tc_smem(1024, 256) > PL.TC_SMEM_MAX


@pytest.mark.parametrize("s,q", [(32, 48), (272, 256)])
def test_packed_stream_products_equal_plain(s, q):
    """Each column block of the stream, read as the kernels read it
    (ar_tc.mma_product_plain), gives W[:, block]^T x; blocks cover each
    matrix once, in order (272 columns: a block of 256 and one of 16)."""
    rng = np.random.default_rng(7)
    w1 = torch.from_numpy(rng.standard_normal((s, s)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((s, q)).astype(np.float32))
    stream = PL.pack_stream(w1, w2)
    mats = {"w1": w1, "w2": w2, "w2T": w2.t(), "w1T": w1.t()}
    blocks = PL.stream_blocks(s, q)
    assert stream.dtype == BF16 and stream.numel() == 2 * (s * s + s * q)
    off, cols = 0, {}
    for name, k, c0, n in blocks:
        assert c0 == cols.get(name, 0) and n <= PL.TC_COLS
        cols[name] = c0 + n
        piece = stream[off:off + k * n].reshape(k // 16, n // 16, 32, 8)
        off += k * n
        want = mats[name][:, c0:c0 + n].to(BF16)
        assert torch.equal(ar_tc.unpack_mma(piece), want)
        x = torch.from_numpy(rng.standard_normal((k, 5)).astype(np.float32)).to(BF16).float()
        torch.testing.assert_close(ar_tc.mma_product_plain(piece, x), want.float().t() @ x,
                                   rtol=1e-5, atol=1e-4)
    assert off == stream.numel() and cols == {"w1": s, "w2": q, "w2T": s, "w1T": s}


ARCH = dataclasses.replace(MICRO, skip_channels=32, quant_channels=32,
                           compute_dtype="bfloat16")
B, T, W = 2, 130, 100   # W is not a multiple of the 64-row tile


@pytest.mark.parametrize("order", ["tensor_cores", "one_fp32_sum"])
def test_bf16_plain_orders_match_jax_pallas_kernels(order):
    """The plain versions at bf16 S = Q = 32 (the tensor-core route's
    widths), summing as the kernels do on the card or as the CPU entry point
    does by default, against JAX's fused_post_loss (Pallas interpret mode):
    the numerator, dskip (0 on the head rows) and the four post leaves,
    each within 2e-2 of its largest magnitude (the same bf16 operands, fp32
    sums in another order)."""
    assert PL.route(32, 32, BF16) == "tensor_cores"
    post = {k: np.asarray(v) for k, v in init_params(jax.random.key(5), ARCH)["post"].items()}
    rng = np.random.default_rng(5)
    skip = rng.standard_normal((B, T, 32)).astype(np.float32)
    tgt = rng.integers(0, 32, (B, W)).astype(np.int32)
    mask = (rng.random((B, W)) > 0.2).astype(np.float32)
    mask[0, :9] = 0.0

    def f(post, skip):
        return 0.37 * jpost(post, skip, tgt, mask, W, compute_dtype="bfloat16", interpret=True)

    num_j, (dpost_j, dskip_j) = jax.value_and_grad(f, argnums=(0, 1))(post, jnp.asarray(skip))
    tc = order == "tensor_cores"
    tp = {k: torch.tensor(v) for k, v in post.items()}
    args = (tp, torch.from_numpy(skip), torch.from_numpy(tgt), torch.from_numpy(mask), W, BF16)
    num = PL.post_loss_plain(*args, tensor_cores=tc)
    dskip, grads = PL.post_loss_bwd_plain(*args, torch.tensor(0.37), tensor_cores=tc)
    assert abs(0.37 * float(num) - float(num_j)) <= 2e-2 * abs(float(num_j))
    assert not dskip[:, :T - W].any()
    for got, want, what in [(dskip, dskip_j, "dskip"),
                            *((grads[k], dpost_j[k], f"post.{k}") for k in grads)]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-2 * float(np.abs(want).max()), err_msg=what)
