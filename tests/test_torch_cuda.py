"""Port tests that need the card: each CUDA kernel against its plain
PyTorch version on the same CUDA inputs, and a pooled request replayed on a
dedicated session. They skip without a GPU; on one, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch

from lb_wavenet_tpu_torch.config import ArchConfig
from lb_wavenet_tpu_torch.generate import _fused_frontend_zero
from lb_wavenet_tpu_torch.models.wavenet import init_params
from lb_wavenet_tpu_torch.ops.cuda import ar_mega, ar_step

pytestmark = pytest.mark.cuda
SMALL = ArchConfig(n_blocks=2, n_layers_per_block=4, residual_channels=16,
                   skip_channels=32, gate_channels=16, compute_dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_fused_stack_kernel_matches_plain(cuda, dtype, atol):
    """fp32: the same products summed in another order; bf16: a rounding
    flip of one activation moves the result by ~1e-2."""
    arch = dataclasses.replace(SMALL, compute_dtype=dtype)
    p = init_params(0, arch, cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    for b in (5, 24):   # a ragged lane tile and whole tiles
        ring = torch.randn((sum(arch.dilations), b, 16), device=cuda, generator=g)
        h0 = torch.randn((b, 16), device=cuda, generator=g)
        r_k, r_p = ring.clone(), ring.clone()
        launches = ar_step.fused_stack.launches
        _, s_k = ar_step.fused_stack(p["layers"], arch, h0, r_k, 37)
        torch.cuda.synchronize()
        assert ar_step.fused_stack.launches == launches + 1
        _, s_p = ar_step.fused_stack_plain(p["layers"], arch, h0, r_p, 37)
        torch.testing.assert_close(r_k, r_p, rtol=0, atol=atol)
        torch.testing.assert_close(s_k, s_p, rtol=0, atol=atol)


@pytest.mark.parametrize("rows,temperature", [(None, 0.0), (2, 1.0), (3, 0.8),
                                              (None, 0.8)])
def test_mega_kernel_matches_plain(cuda, rows, temperature):
    """fp32 small arch: teacher-forced logits within 1e-4 and free-running
    classes equal over 64 steps (greedy, per-lane, global counter hash)."""
    p = init_params(1, SMALL, cuda)
    b, t = 16, 64
    h0, e0 = _fused_frontend_zero(p, SMALL, b)
    g = torch.Generator(device=cuda).manual_seed(1)
    lane = None
    if rows is not None:
        lane = [torch.randint(0, 2**31 - 1, (b,), generator=g, device=cuda),
                torch.zeros(b, device=cuda)]
        if rows == 3:
            inv = torch.tensor([0.0, 1.25, 1.0, 2.0] * (b // 4), device=cuda)
            lane.append(inv.view(torch.int32))
        lane = torch.stack([x.to(torch.int32) for x in lane])

    def run(fn, forced, emit):
        carry = ar_mega.mega_zero_carry(SMALL, h0, e0)
        cls, lg = fn(p, p["layers"], SMALL, carry, 3, forced, temperature, emit,
                     lane, 77)
        torch.cuda.synchronize()
        return cls, lg, carry

    forced = torch.randint(0, 256, (t, b), generator=g, device=cuda, dtype=torch.int32)
    _, lk, ck = run(ar_mega.mega_generate_cuda, forced, True)
    _, lp, cp = run(ar_mega.mega_generate_plain, forced, True)
    torch.testing.assert_close(lk, lp, rtol=0, atol=1e-4)
    for k in ck:
        torch.testing.assert_close(ck[k], cp[k], rtol=0, atol=1e-4)
    free = torch.full((t, b), -1, device=cuda, dtype=torch.int32)
    ck_cls, _, _ = run(ar_mega.mega_generate_cuda, free, False)
    cp_cls, _, _ = run(ar_mega.mega_generate_plain, free, False)
    assert torch.equal(ck_cls, cp_cls)


def test_pool_replay_on_card(cuda):
    """A sampled request on a recycled lane of a pool on the card equals
    the same request alone (kernel path end to end)."""
    import numpy as np

    from lb_wavenet_tpu_torch.serving import SessionPool

    p = init_params(2, SMALL, cuda)

    def serve(batch, reqs):
        pool = SessionPool(p, SMALL, batch, 0, chunk_size=32, pipeline=True)
        out, parts, queue = {}, {}, list(reqs)
        while pool.active or queue:
            while queue and pool.submit(queue[0][0], queue[0][1], seed=queue[0][2],
                                        temperature=queue[0][3]):
                parts[queue.pop(0)[0]] = []
            for rid, (cls, done) in pool.step().items():
                parts[rid].append(cls)
                if done:
                    out[rid] = np.concatenate(parts.pop(rid))
        return out

    reqs = [("a", 70, 1, 0.0), ("b", 40, 2, 0.7), ("c", 90, 3, 1.0)]
    busy = serve(2, reqs)
    alone = serve(1, reqs[2:])
    np.testing.assert_array_equal(busy["c"], alone["c"])
