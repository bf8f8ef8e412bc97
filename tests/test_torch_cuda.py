"""Port tests that need the card: each CUDA kernel against its plain
PyTorch version on the same CUDA inputs (the sampling kernels, and the
training kernel pairs through autograd), a pooled request replayed on a
dedicated session, and a fused training step on the card against the same
step on the CPU. They skip without a GPU; on one, run

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


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("tapcat", [False, True])
def test_train_stack_kernels_match_plain(cuda, dtype, tapcat, rtol):
    """Forward and backward kernels through the autograd Function against
    the plain versions, a ragged last time tile; errors relative to each
    leaf's largest magnitude (sums in another order, same roundings)."""
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    arch = dataclasses.replace(SMALL, compute_dtype=dtype)
    dt = compute_dtype(arch)
    p = init_params(3, arch, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    h0 = torch.randn((3, 70, 16), device=cuda, generator=g)
    gs = torch.randn((3, 70, 32), device=cuda, generator=g)
    lp = {k: v.clone().requires_grad_(True) for k, v in p["layers"].items()}
    h = h0.clone().requires_grad_(True)
    n_fwd, n_bwd = TS.train_stack_fwd.launches, TS.train_stack_bwd.launches
    skip = TS.make_fused_stack(arch, tapcat=tapcat)(lp, h)
    (skip * gs).sum().backward()
    torch.cuda.synchronize()
    L = len(arch.dilations)
    assert TS.train_stack_fwd.launches == n_fwd + L + 1
    assert TS.train_stack_bwd.launches == n_bwd + 3 * L + 1
    sp, zp, xp = TS.stack_fwd_plain(p["layers"], h0, arch.dilations, dt, tapcat)
    dp, gp = TS.stack_bwd_plain(p["layers"], arch.dilations, dt, tapcat, zp, xp, gs)

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=rtol * float(b.abs().max()))

    close(skip.detach(), sp)
    close(h.grad, dp)
    for k in gp:
        close(lp[k].grad, gp[k])


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_post_loss_kernels_match_plain(cuda, dtype, rtol):
    """Numerator, dskip (exactly 0 on the head rows) and the post
    gradients against the plain versions, a ragged last row tile."""
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL

    arch = dataclasses.replace(SMALL, compute_dtype=dtype)
    dt = compute_dtype(arch)
    p = init_params(4, arch, cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    skip = torch.randn((3, 60, 32), device=cuda, generator=g)
    tgt = torch.randint(0, 256, (3, 37), device=cuda, generator=g, dtype=torch.int32)
    mask = (torch.rand((3, 37), device=cuda, generator=g) > 0.2).float()
    post = {k: v.clone().requires_grad_(True) for k, v in p["post"].items()}
    s = skip.clone().requires_grad_(True)
    n_fwd, n_bwd = PL.post_loss_fwd.launches, PL.post_loss_bwd.launches
    num = PL.fused_post_loss(post, s, tgt, mask, 37, dtype)
    (num * 0.5).backward()
    torch.cuda.synchronize()
    assert (PL.post_loss_fwd.launches, PL.post_loss_bwd.launches) == (n_fwd + 2, n_bwd + 3)
    num_p = PL.post_loss_plain(p["post"], skip, tgt, mask, 37, dt)
    dsp, gp = PL.post_loss_bwd_plain(p["post"], skip, tgt, mask, 37, dt,
                                     torch.tensor(0.5, device=cuda))
    torch.testing.assert_close(num.detach(), num_p, rtol=rtol, atol=0)
    assert not s.grad[:, :60 - 37].any()

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=rtol * float(b.abs().max()))

    close(s.grad, dsp)
    for k in gp:
        close(post[k].grad, gp[k])


def test_fused_training_step_on_card(cuda):
    """A fused train step (stack + tapcat + post) on the card against the
    same step on the CPU (the plain versions), fp32."""
    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.config import TrainConfig

    train = TrainConfig(batch_size=2, window_size=40, learning_rate=1e-3, fused_stack=True,
                        tapcat=True, fused_post=True)
    state = PT.init_state(5, SMALL, train, "cpu")
    g = torch.Generator().manual_seed(5)
    t = SMALL.receptive_field - 1 + 40
    batch = {"inputs": torch.randint(0, 256, (2, t), generator=g, dtype=torch.int32),
             "targets": torch.randint(0, 256, (2, 40), generator=g, dtype=torch.int32),
             "mask": torch.ones((2, 40))}
    loss_c, grads_c = PT.value_and_grads(state.params, batch, SMALL, train)
    params_g = PT.tree_map(lambda v: v.to(cuda), state.params)
    loss_g, grads_g = PT.value_and_grads(params_g, {k: v.to(cuda) for k, v in batch.items()},
                                         SMALL, train)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for a, b in zip(PT.tree_leaves(grads_g), PT.tree_leaves(grads_c)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-7)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("k_taps", [1, 2, 3])
def test_frontend_kernels_match_plain(cuda, dtype, rtol, k_taps):
    """h0 and the three gradients through the autograd Function against the
    plain versions, a ragged last time tile and scatter chunk; errors
    relative to each leaf's largest magnitude (bf16: one flipped rounding
    of a d_e piece moves d_embed by up to 2^-8 of it)."""
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F

    dt = compute_dtype(dataclasses.replace(SMALL, compute_dtype=dtype))
    g = torch.Generator(device=cuda).manual_seed(6 + k_taps)
    embed = torch.randn((256, 16), device=cuda, generator=g)
    w = torch.randn((k_taps, 16, 16), device=cuda, generator=g) / 4
    b = torch.randn(16, device=cuda, generator=g) / 10
    x = torch.randint(0, 256, (3, 301), device=cuda, generator=g, dtype=torch.int32)
    x[0, 5] = 256   # out of range: a zero row, no gradient
    dh = torch.randn((3, 301, 16), device=cuda, generator=g)
    leaves = [t.clone().requires_grad_(True) for t in (embed, w, b)]
    n_fwd, n_bwd = F.frontend_fwd.launches, F.frontend_bwd.launches
    h = F.fused_frontend(leaves[0], {"w": leaves[1], "b": leaves[2]}, x, compute_dtype=dtype)
    (h * dh).sum().backward()
    torch.cuda.synchronize()
    assert (F.frontend_fwd.launches, F.frontend_bwd.launches) == (n_fwd + 1, n_bwd + 4)
    hp = F.frontend_fwd_plain(embed, w, b, x, dt)
    gp = F.frontend_bwd_plain(embed, w, x, dt, dh)

    def close(a, ref):
        torch.testing.assert_close(a, ref, rtol=0, atol=rtol * float(ref.abs().max()))

    close(h.detach(), hp)
    for leaf, ref in zip(leaves, gp):
        close(leaf.grad, ref)


@pytest.mark.parametrize("rows,temperature", [(None, 0.0), (2, 1.0), (3, 0.8),
                                              (None, 0.8)])
@pytest.mark.parametrize("k_taps", [1, 2, 3])
def test_turbo_kernel_matches_plain(cuda, rows, temperature, k_taps):
    """fp32 small arch at a ragged batch (13 lanes): teacher-forced logits
    and the carried state within 1e-4 over 48 steps, one launch per step;
    free-running classes equal (greedy, per-lane 2/3 rows, global hash)."""
    from lb_wavenet_tpu_torch.ops.cuda import ar_turbo

    arch = dataclasses.replace(SMALL, input_kernel=k_taps)
    p = init_params(7, arch, cuda)
    b, t = 13, 48
    g = torch.Generator(device=cuda).manual_seed(7)
    lane = None
    if rows is not None:
        lane = [torch.randint(0, 2**31 - 1, (b,), generator=g, device=cuda),
                torch.randint(-9, 9, (b,), generator=g, device=cuda)]
        if rows == 3:
            inv = torch.tensor([0.0, 1.25, 1.0, 2.0] * 4, device=cuda)[:b]
            lane.append(inv.view(torch.int32))
        lane = torch.stack([x.to(torch.int32) for x in lane])
    h0, e0 = _fused_frontend_zero(p, arch, b)
    ring = torch.randn((sum(arch.dilations), b, 16), device=cuda, generator=g)

    def run(fn, forced, emit):
        state = {"bufs": ring.clone(), "h": h0.clone(), "e": e0.clone()}
        cls, lg = fn(p, p["layers"], arch, state, 500, forced, temperature, emit, lane, 99)
        torch.cuda.synchronize()
        return cls, lg, state

    forced = torch.randint(0, 256, (t, b), generator=g, device=cuda, dtype=torch.int32)
    n = ar_turbo.turbo_step.launches
    _, lk, sk = run(ar_turbo.turbo_generate_cuda, forced, True)
    assert ar_turbo.turbo_step.launches == n + t
    _, lp, sp = run(ar_turbo.turbo_generate_plain, forced, True)
    torch.testing.assert_close(lk, lp, rtol=0, atol=1e-4)
    for k in sk:
        torch.testing.assert_close(sk[k], sp[k], rtol=0, atol=1e-4)
    free = torch.full((t, b), -1, device=cuda, dtype=torch.int32)
    ck, _, _ = run(ar_turbo.turbo_generate_cuda, free, False)
    cp, _, _ = run(ar_turbo.turbo_generate_plain, free, False)
    assert torch.equal(ck, cp)


def test_recipe_training_step_on_card(cuda):
    """The production recipe's step (fused frontend + stack with tapcat +
    post) on the card against the same step on the CPU (the plain
    versions), fp32."""
    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.config import TrainConfig

    train = TrainConfig(batch_size=2, window_size=40, learning_rate=1e-3, fused_stack=True,
                        tapcat=True, fused_post=True, fused_frontend=True)
    state = PT.init_state(8, SMALL, train, "cpu")
    g = torch.Generator().manual_seed(8)
    t = SMALL.receptive_field - 1 + 40
    batch = {"inputs": torch.randint(0, 256, (2, t), generator=g, dtype=torch.int32),
             "targets": torch.randint(0, 256, (2, 40), generator=g, dtype=torch.int32),
             "mask": torch.ones((2, 40))}
    loss_c, grads_c = PT.value_and_grads(state.params, batch, SMALL, train)
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F

    n = (F.frontend_fwd.launches, F.frontend_bwd.launches)
    params_g = PT.tree_map(lambda v: v.to(cuda), state.params)
    loss_g, grads_g = PT.value_and_grads(params_g, {k: v.to(cuda) for k, v in batch.items()},
                                         SMALL, train)
    assert (F.frontend_fwd.launches, F.frontend_bwd.launches) == (n[0] + 1, n[1] + 4)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for a, b in zip(PT.tree_leaves(grads_g), PT.tree_leaves(grads_c)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-7)
