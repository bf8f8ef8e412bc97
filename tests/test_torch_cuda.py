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
    flip of one activation moves the result by ~1e-2 (SMALL's bf16 widths
    take the tensor-core route, whose plain version matches it exactly:
    test_fused_stack_tensor_core_route_is_bit_exact)."""
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


STACK_WIDTHS = {"small": {}, "c24": {"residual_channels": 24, "gate_channels": 24},
                "s1024": {"skip_channels": 1024}, "s272": {"skip_channels": 272},
                "stress": {"residual_channels": 64, "gate_channels": 64, "skip_channels": 512}}


@pytest.mark.parametrize("dtype,rtol,width", [
    ("float32", 1e-5, "small"), ("bfloat16", 1e-2, "small"), ("bfloat16", 1e-2, "c24"),
    ("bfloat16", 1e-2, "s1024"), ("bfloat16", 1e-2, "s272"), ("bfloat16", 1e-2, "stress")])
@pytest.mark.parametrize("tapcat", [False, True])
def test_train_stack_kernels_match_plain(cuda, dtype, tapcat, rtol, width):
    """Forward and backward kernels through the autograd Function against
    the plain versions, a ragged last time tile; errors relative to each
    leaf's largest magnitude (sums in another order, same roundings). bf16
    SMALL, S=1024, S=272 (a last skip-column pass of 16) and the stress
    config's widths (S=512 in two passes) take the tensor-core route, C=G=24
    the CUDA-core one; the launch counts are each route's."""
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    arch = dataclasses.replace(SMALL, compute_dtype=dtype, **STACK_WIDTHS[width])
    dt = compute_dtype(arch)
    c, s = arch.residual_channels, arch.skip_channels
    p = init_params(3, arch, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    h0 = torch.randn((3, 70, c), device=cuda, generator=g)
    gs = torch.randn((3, 70, s), device=cuda, generator=g)
    lp = {k: v.clone().requires_grad_(True) for k, v in p["layers"].items()}
    h = h0.clone().requires_grad_(True)
    n_fwd, n_bwd = TS.train_stack_fwd.launches, TS.train_stack_bwd.launches
    skip = TS.make_fused_stack(arch, tapcat=tapcat)(lp, h)
    (skip * gs).sum().backward()
    torch.cuda.synchronize()
    L = len(arch.dilations)
    tc = TS.route(c, arch.gate_channels, s, dt) == "tensor_cores"
    assert tc == (dtype == "bfloat16" and width != "c24")
    assert TS.train_stack_fwd.launches == n_fwd + L + 1
    assert TS.train_stack_bwd.launches == n_bwd + (2 * L + 3 if tc else 3 * L + 1)
    sp, zp, xp = TS.stack_fwd_plain(p["layers"], h0, arch.dilations, dt, tapcat)
    dp, gp = TS.stack_bwd_plain(p["layers"], arch.dilations, dt, tapcat, zp, xp, gs)

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=rtol * float(b.abs().max()))

    close(skip.detach(), sp)
    close(h.grad, dp)
    for k in gp:
        close(lp[k].grad, gp[k])


@pytest.mark.parametrize("dtype,width,cc", [("float32", "small", 8), ("bfloat16", "small", 16),
                                             ("bfloat16", "c24", 16), ("bfloat16", "small", 32),
                                             ("bfloat16", "stress", 80)])
@pytest.mark.parametrize("tapcat", [False, True])
def test_conditioned_train_stack_kernels_match_plain(cuda, dtype, width, cc, tapcat):
    """The conditioned pair (cond (B, T, Cc') against w_cond) through the
    autograd Function against the plain versions, a ragged last time tile:
    on the tensor-core route (bf16 SMALL at Cc' = 16, 32; the stress
    config's widths at Cc' = 80, S = 512 in two passes) bit for bit in
    skip, dh0, d cond and every weight gradient; on the CUDA-core route
    (fp32; bf16 at C = G = 24) within 1e-5 / 1e-2 of each leaf's largest
    magnitude. Launch counts are each route's, no extra launch for cond."""
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    arch = dataclasses.replace(SMALL, compute_dtype=dtype, **STACK_WIDTHS[width])
    dt = compute_dtype(arch)
    c, s, two_g = arch.residual_channels, arch.skip_channels, 2 * arch.gate_channels
    p = init_params(4, arch, cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    layers = dict(p["layers"], w_cond=torch.randn((len(arch.dilations), cc, two_g),
                                                  device=cuda, generator=g) / cc ** 0.5)
    h0 = torch.randn((3, 70, c), device=cuda, generator=g)
    cond0 = torch.randn((3, 70, cc), device=cuda, generator=g)
    gs = torch.randn((3, 70, s), device=cuda, generator=g)
    lp = {k: v.clone().requires_grad_(True) for k, v in layers.items()}
    h, cond = h0.clone().requires_grad_(True), cond0.clone().requires_grad_(True)
    n = [TS.train_stack_fwd.cond_launches, TS.train_stack_bwd.cond_launches]
    skip = TS.make_fused_stack(arch, has_cond=True, tapcat=tapcat)(lp, h, cond)
    (skip * gs).sum().backward()
    torch.cuda.synchronize()
    L = len(arch.dilations)
    tc = TS.route(c, arch.gate_channels, s, dt, cc) == "tensor_cores"
    assert tc == (dtype == "bfloat16" and width != "c24")
    assert TS.train_stack_fwd.cond_launches == n[0] + L + 1
    assert TS.train_stack_bwd.cond_launches == n[1] + (2 * L + 3 if tc else 3 * L + 1)
    sp, zp, xp = TS.stack_fwd_plain(layers, h0, arch.dilations, dt, tapcat, cond=cond0)
    dp, gp = TS.stack_bwd_plain(layers, arch.dilations, dt, tapcat, zp, xp, gs, cond=cond0)
    rtol = 0.0 if tc else (1e-5 if dtype == "float32" else 1e-2)

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=rtol * float(b.abs().max()))

    close(skip.detach(), sp)
    close(h.grad, dp)
    close(cond.grad, gp.pop("cond"))
    for k in gp:
        close(lp[k].grad, gp[k])


@pytest.mark.parametrize("tapcat", [False, True])
def test_conditioned_train_stack_backward_is_bit_reproducible(cuda, tapcat):
    """Two conditioned backward calls on the tensor cores give the same
    bits: d cond is added from the fragments by one owner per element and
    launch, the layers in launch order."""
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    arch = dataclasses.replace(SMALL, compute_dtype="bfloat16")
    p = init_params(7, arch, cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    lp = dict(p["layers"], w_cond=torch.randn((len(arch.dilations), 16, 32), device=cuda,
                                              generator=g) / 4)
    h0 = torch.randn((4, 300, 16), device=cuda, generator=g)
    cond = torch.randn((4, 300, 16), device=cuda, generator=g)
    gs = torch.randn((4, 300, 32), device=cuda, generator=g)
    dils, dt = arch.dilations, torch.bfloat16
    assert TS.route(16, 16, 32, dt, 16) == "tensor_cores"
    _, z, x = TS.train_stack_fwd(lp, h0, dils, dt, tapcat, cond=cond)
    runs = [TS.train_stack_bwd(lp, dils, dt, tapcat, z, x, gs, cond=cond) for _ in range(2)]
    torch.cuda.synchronize()
    (d1, g1), (d2, g2) = runs
    assert torch.equal(d1, d2) and set(g1) >= {"cond", "w_cond"}
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


@pytest.mark.parametrize("c,g,s,cc", [(16, 16, 32, 16), (64, 64, 256, 64), (64, 64, 256, 80),
                                      (64, 64, 512, 80)])
def test_conditioned_train_stack_library_carves_tc_smem(cuda, c, g, s, cc):
    """The library's shared-memory count with cond's tiles equals
    train_stack.tc_smem(C, G, S, Cc')."""
    from lb_wavenet_tpu_torch.ops.cuda import build
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    assert TS.lib_tc_smem(build.load("train_stack"), c, g, s, cc) == TS.tc_smem(c, g, s, cc)


def test_training_upsampler_is_true_fp32_on_the_card(cuda):
    """upsample_cond_train on the card against a float64 product, with the
    TF32 switch on around it: values within 1e-5 of the largest."""
    from lb_wavenet_tpu_torch.models.conditioning import (
        init_upsampler_params, upsample_cond_train)

    arch = ArchConfig(n_mels=80, cond_channels=64, upsample_factors=(4, 8, 8))
    up = init_upsampler_params(0, arch, cuda)
    frames = torch.randn((2, 12, 80), device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = upsample_cond_train(up, arch, frames, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    h = frames.double() @ up["proj_w"].double() + up["proj_b"].double()
    for f, st in zip(arch.upsample_factors, up["stages"]):   # the same function in float64
        h = torch.repeat_interleave(h, f, dim=1)
        b, t, c = h.shape
        win = torch.nn.functional.pad(h, (0, 0, f, f)).unfold(1, 2 * f + 1, 1)
        h = torch.nn.functional.leaky_relu(
            win.transpose(-1, -2).reshape(b, t, -1) @ st["w"].double().reshape(-1, c)
            + st["b"].double(), 0.4)
    assert float((got.double() - h).abs().max()) <= 1e-5 * float(h.abs().max())


@pytest.mark.parametrize("c,g,s", [(16, 16, 32), (24, 24, 32), (64, 64, 256), (64, 64, 512),
                                   (64, 64, 1024), (128, 64, 256), (256, 256, 256)])
def test_train_stack_library_carves_tc_smem(cuda, c, g, s):
    """The built library's shared-memory count of the tensor-core kernels
    equals train_stack.tc_smem, on which the route is decided."""
    from lb_wavenet_tpu_torch.ops.cuda import build
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    assert TS.lib_tc_smem(build.load("train_stack"), c, g, s) == TS.tc_smem(c, g, s)


@pytest.mark.parametrize("tapcat", [False, True])
def test_train_stack_tensor_core_backward_is_bit_reproducible(cuda, tapcat):
    """Two backward calls on the same inputs give the same bits: fixed
    tile -> block slots and one ordered reduction, no float atomics."""
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    arch = dataclasses.replace(SMALL, compute_dtype="bfloat16")
    p = init_params(6, arch, cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    h0 = torch.randn((4, 300, 16), device=cuda, generator=g)
    gs = torch.randn((4, 300, 32), device=cuda, generator=g)
    dils, dt = arch.dilations, torch.bfloat16
    assert TS.route(16, 16, 32, dt) == "tensor_cores"
    _, z, x = TS.train_stack_fwd(p["layers"], h0, dils, dt, tapcat)
    runs = [TS.train_stack_bwd(p["layers"], dils, dt, tapcat, z, x, gs) for _ in range(2)]
    torch.cuda.synchronize()
    (d1, g1), (d2, g2) = runs
    assert torch.equal(d1, d2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_post_loss_kernels_match_plain(cuda, dtype, rtol):
    """Numerator, dskip (exactly 0 on the head rows) and the post
    gradients against the plain versions, a ragged last row tile; bf16
    SMALL (S = 32) takes the tensor-core route, fp32 the CUDA-core one, and
    the launches are that route's (2 and 3)."""
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL

    arch = dataclasses.replace(SMALL, compute_dtype=dtype)
    dt = compute_dtype(arch)
    assert PL.route(32, 256, dt) == ("tensor_cores" if dtype == "bfloat16" else "cuda_cores")
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


POST_WIDTHS = {"wavenet30": (256, 256, "bfloat16", "tensor_cores"),
               "stress": (512, 256, "bfloat16", "tensor_cores"),
               "c24": (24, 24, "bfloat16", "cuda_cores"),
               "fp32": (256, 256, "float32", "cuda_cores")}


def _post_case(cuda, s, q, seed, b=2, t=330, w=230):
    """Post weights at WaveNet-30's init scale, skip, targets and a mask
    with a file start inside the window (w rows: a ragged last tile)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    post = {"w1": torch.randn((s, s), device=cuda, generator=g) * s ** -0.5,
            "b1": torch.randn((s,), device=cuda, generator=g) * 0.1,
            "w2": torch.randn((s, q), device=cuda, generator=g) * s ** -0.5,
            "b2": torch.randn((q,), device=cuda, generator=g) * 0.1}
    skip = torch.randn((b, t, s), device=cuda, generator=g)
    tgt = torch.randint(0, q, (b, w), device=cuda, generator=g, dtype=torch.int32)
    mask = (torch.rand((b, w), device=cuda, generator=g) > 0.2).float()
    mask[0, :70] = 0.0
    return post, skip, tgt, mask


@pytest.mark.parametrize("width", list(POST_WIDTHS))
def test_post_loss_routes_match_plain(cuda, width):
    """Each route at the widths that take it: the tensor-core kernels at
    WaveNet-30's and the stress config's widths against the plain versions
    summed as the tensor cores sum (KERNEL_RTOL of chip_smoke.py, 1e-2 of
    each leaf's largest value: the softmax's sums in another order can flip
    a bf16 rounding of dlogits), the CUDA-core kernels in bf16 at S = Q = 24
    and in fp32 (1e-5); head dskip exactly 0, 2 and 3 launches."""
    from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL

    s, q, dtype, want = POST_WIDTHS[width]
    dt = getattr(torch, dtype)
    assert PL.route(s, q, dt) == want
    post, skip, tgt, mask = _post_case(cuda, s, q, 8)
    gbar = torch.tensor(0.37, device=cuda)
    n_fwd, n_bwd = PL.post_loss_fwd.launches, PL.post_loss_bwd.launches
    num = PL.post_loss_fwd(post, skip, tgt, mask, 230, dt)
    dskip, grads = PL.post_loss_bwd(post, skip, tgt, mask, 230, dt, gbar)
    torch.cuda.synchronize()
    assert (PL.post_loss_fwd.launches, PL.post_loss_bwd.launches) == (n_fwd + 2, n_bwd + 3)
    assert PL.default_order(skip.device, s, q, dt) == (want == "tensor_cores")
    num_p = PL.post_loss_plain(post, skip, tgt, mask, 230, dt)
    dsp, gp = PL.post_loss_bwd_plain(post, skip, tgt, mask, 230, dt, gbar)
    rtol = 1e-5 if dtype == "float32" else 1e-2
    assert not dskip[:, :100].any()

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=rtol * float(b.abs().max()))

    close(num, num_p)
    close(dskip, dsp)
    for k in gp:
        close(grads[k], gp[k])


def test_post_loss_tensor_core_kernels_are_bit_reproducible(cuda):
    """Two calls on the same inputs give the same bits: fixed tile -> block
    slots, fixed position chunks and ordered reductions, no float atomics."""
    from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL

    post, skip, tgt, mask = _post_case(cuda, 256, 256, 9, b=3, t=900, w=800)
    gbar = torch.tensor(0.25, device=cuda)
    runs = [(PL.post_loss_fwd(post, skip, tgt, mask, 800, torch.bfloat16),
             *PL.post_loss_bwd(post, skip, tgt, mask, 800, torch.bfloat16, gbar))
            for _ in range(2)]
    torch.cuda.synchronize()
    (n1, d1, g1), (n2, d2, g2) = runs
    assert torch.equal(n1, n2) and torch.equal(d1, d2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


@pytest.mark.parametrize("s,q", [(32, 256), (256, 256), (512, 256), (272, 32), (576, 256)])
def test_post_loss_library_carves_tc_smem(cuda, s, q):
    """The built library's shared-memory count of the tensor-core row
    kernels equals post_loss.tc_smem, on which the route is decided."""
    from lb_wavenet_tpu_torch.ops.cuda import build
    from lb_wavenet_tpu_torch.ops.cuda import post_loss as PL

    assert PL.lib_tc_smem(build.load("post_loss"), s, q) == PL.tc_smem(s, q)


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
    of a d_e piece moves d_embed by up to 2^-8 of it). bf16 at C = 16 takes
    the tensor-core route, where h0 equals the plain h0 bit for bit; launches
    2 forward, and 3 backward there, 4 on the CUDA-core route."""
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
    tc = F.route(256, 16, k_taps, dt) == "tensor_cores"
    assert tc == (dtype == "bfloat16")
    assert (F.frontend_fwd.launches, F.frontend_bwd.launches) == (n_fwd + 2,
                                                                  n_bwd + (3 if tc else 4))
    hp = F.frontend_fwd_plain(embed, w, b, x, dt)
    gp = F.frontend_bwd_plain(embed, w, x, dt, dh)

    def close(a, ref):
        torch.testing.assert_close(a, ref, rtol=0, atol=rtol * float(ref.abs().max()))

    close(h.detach(), hp)
    if tc:
        assert torch.equal(h.detach(), hp)
    for leaf, ref in zip(leaves, gp):
        close(leaf.grad, ref)


def _front_case(cuda, c, k_taps, seed, b=3, t=301):
    g = torch.Generator(device=cuda).manual_seed(seed)
    embed = torch.randn((256, c), device=cuda, generator=g)
    w = torch.randn((k_taps, c, c), device=cuda, generator=g) / (c ** 0.5)
    bias = torch.randn(c, device=cuda, generator=g) / 10
    x = torch.randint(0, 256, (b, t), device=cuda, generator=g, dtype=torch.int32)
    x[0, 5], x[b - 1, 0] = 256, -1   # out of range: zero taps, no gradient
    dh = torch.randn((b, t, c), device=cuda, generator=g)
    return embed, w, bias, x, dh


@pytest.mark.parametrize("c,k_taps,dtype,want", [
    (64, 2, torch.bfloat16, "tensor_cores"),   # WaveNet-30's widths
    (64, 1, torch.bfloat16, "tensor_cores"),
    (64, 3, torch.bfloat16, "cuda_cores"),     # four tables do not fit
    (64, 2, torch.float32, "cuda_cores"),
    (24, 2, torch.bfloat16, "cuda_cores"),     # C not a multiple of 16
    (18, 2, torch.bfloat16, "cuda_cores"),     # nor of 4: the gather's scalar path
])
def test_frontend_routes_match_plain(cuda, c, k_taps, dtype, want):
    """Each route at B = 3, T = 301 (a ragged last tile of every kernel)
    against the plain versions: h0 bit for bit on the tensor-core route
    (within 1e-5 of its largest value elsewhere), every gradient within the
    tolerances of test_frontend_kernels_match_plain; the launches of the
    route."""
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F

    assert F.route(256, c, k_taps, dtype) == want
    embed, w, bias, x, dh = _front_case(cuda, c, k_taps, 30 + c + k_taps)
    n = (F.frontend_fwd.launches, F.frontend_bwd.launches)
    h = F.frontend_fwd(embed, w, bias, x, dtype)
    grads = F.frontend_bwd(embed, w, x, dtype, dh)
    torch.cuda.synchronize()
    tc = want == "tensor_cores"
    assert (F.frontend_fwd.launches - n[0], F.frontend_bwd.launches - n[1]) == (2, 3 if tc else 4)
    hp = F.frontend_fwd_plain(embed, w, bias, x, dtype)
    gp = F.frontend_bwd_plain(embed, w, x, dtype, dh)
    if tc:
        assert torch.equal(h, hp)
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(h, hp, rtol=0, atol=1e-5 * float(hp.abs().max()))
    for got, ref in zip(grads, gp):
        torch.testing.assert_close(got, ref, rtol=0, atol=rtol * float(ref.abs().max()))


def test_frontend_taps_and_scatters_stay_in_their_row(cuda):
    """At WaveNet-30's widths on the tensor-core route, B = 3 and T = 301:
    the batch's h0 equals each row run alone bit for bit, and its gradients
    the sums of the rows' gradients within fp32 reordering."""
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F

    embed, w, bias, x, dh = _front_case(cuda, 64, 2, 40)
    h = F.frontend_fwd(embed, w, bias, x, torch.bfloat16)
    grads = F.frontend_bwd(embed, w, x, torch.bfloat16, dh)
    rows = [(F.frontend_fwd(embed, w, bias, x[i:i + 1], torch.bfloat16),
             F.frontend_bwd(embed, w, x[i:i + 1], torch.bfloat16, dh[i:i + 1]))
            for i in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(h, torch.cat([r[0] for r in rows]))
    for j, got in enumerate(grads):
        want = sum(r[1][j] for r in rows)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_frontend_tensor_core_backward_is_bit_reproducible(cuda):
    """Two backward calls on the same inputs give the same bits: a fixed tile
    -> block walk, each table entry one thread's sum in position order, the
    slots summed in order, no float atomics."""
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F

    embed, w, _, x, dh = _front_case(cuda, 64, 2, 41, b=4, t=5000)
    runs = [F.frontend_bwd(embed, w, x, torch.bfloat16, dh) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("q,c,k", [(256, 64, 2), (256, 64, 1), (256, 16, 3), (256, 64, 3),
                                   (128, 32, 2)])
def test_frontend_library_carves_tc_smem(cuda, q, c, k):
    """The built library's shared-memory count of the tensor-core backward
    pass equals frontend.tc_smem, on which the route is decided."""
    from lb_wavenet_tpu_torch.ops.cuda import build
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F

    assert F.lib_tc_smem(build.load("frontend"), q, c, k) == F.tc_smem(q, c, k)


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
    assert (F.frontend_fwd.launches, F.frontend_bwd.launches) == (n[0] + 2, n[1] + 4)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for a, b in zip(PT.tree_leaves(grads_g), PT.tree_leaves(grads_c)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-7)


def _tp_inputs(arch, b, seed, cuda):
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = arch.residual_channels
    return (torch.randn((c, b), device=cuda, generator=g),
            torch.randn((sum(arch.dilations), c, b), device=cuda, generator=g))


@pytest.mark.parametrize("width", ["small", "stress"])
def test_tp_fused_stack_kernel_matches_plain(cuda, width):
    """B7 against its plain version: the small fp32 arch at a ragged and a
    whole lane tile, and configs/stress_gen.json (bf16, B=256) on the whole
    skip width and on each half. Rows no layer wrote and layer 0's slot
    exactly; the rest within atol (fp32: sums in another order; bf16: a
    flipped rounding of an activation moves a value by ~1e-2)."""
    import os

    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.generate import _tp_weights
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import ar_tp

    if width == "small":
        arch, cases, atol = SMALL, [(5, None), (24, None)], 1e-4
    else:
        arch = Config.load(os.path.join(os.path.dirname(__file__), "..", "configs",
                                        "stress_gen.json")).arch
        cases, atol = [(256, None), (256, 0), (256, 1)], 5e-2
    whole = init_params(9, arch, cuda)
    s = arch.skip_channels
    for b, half in cases:
        lp = dict(whole["layers"])
        if half is not None:   # model rank `half` of two
            sl = slice(half * s // 2, (half + 1) * s // 2)
            lp["w_skip"], lp["b_skip"] = lp["w_skip"][..., sl], lp["b_skip"][..., sl]
        fm = _tp_weights(whole, lp, compute_dtype(arch))
        h0, ring = _tp_inputs(arch, b, 11 + b, cuda)
        r_k, r_p = ring.clone(), ring.clone()
        n = ar_tp.tp_fused_stack.launches
        _, s_k = ar_tp.tp_fused_stack(fm, arch, h0, r_k, 1000)
        torch.cuda.synchronize()
        assert ar_tp.tp_fused_stack.launches == n + 1
        _, s_p = ar_tp.tp_fused_stack_plain(fm, arch, h0, r_p, 1000)
        slots = [o + 1000 % d for o, d in zip(ar_step.buffer_offsets(arch), arch.dilations)]
        untouched = torch.ones(len(ring), dtype=torch.bool, device=cuda)
        untouched[slots] = False
        assert torch.equal(r_k[untouched], ring[untouched]) and torch.equal(r_k[slots[0]], h0)
        torch.testing.assert_close(r_k, r_p, rtol=0, atol=atol)
        torch.testing.assert_close(s_k, s_p, rtol=0, atol=atol)


def test_sharded_session_one_rank_nccl(cuda, tmp_path):
    """One NCCL rank (model axis 1): a ShardedSession's chunks equal the
    one-shot mesh run, one B7 launch per step, and the greedy classes equal
    single-device mega."""
    import torch.distributed as dist

    from lb_wavenet_tpu_torch.generate import generate_classes
    from lb_wavenet_tpu_torch.ops.cuda import ar_tp
    from lb_wavenet_tpu_torch.parallel import synthesis as S
    from lb_wavenet_tpu_torch.parallel.mesh import make_mesh
    from lb_wavenet_tpu_torch.utils.multihost import init_distributed, shutdown

    if dist.is_initialized():
        pytest.skip("this process already belongs to a process group")
    p = init_params(10, SMALL, cuda)
    assert init_distributed(init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1) == "nccl"
    try:
        mesh = make_mesh(1, 1)
        for temperature in (0.0, 1.0):
            n = ar_tp.tp_fused_stack.launches
            sess = S.ShardedSession(p, SMALL, 16, 4, mesh, engine="mega")
            chunks = torch.cat([sess.chunk(16, temperature=temperature) for _ in range(3)], 1)
            one = S.mesh_generate_classes(p, SMALL, 4, 16, 48, mesh, engine="mega",
                                          temperature=temperature)
            torch.cuda.synchronize()
            assert ar_tp.tp_fused_stack.launches == n + 96
            assert torch.equal(chunks, one)
        ref = generate_classes(p, SMALL, 4, 16, 48, engine="mega", temperature=0.0)
        assert torch.equal(S.mesh_generate_classes(p, SMALL, 4, 16, 48, mesh, engine="mega",
                                                   temperature=0.0), ref)
    finally:
        shutdown()


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two processes on cuda:0 over gloo (NCCL refuses two ranks on one
    device), model axis 2: both ranks launch B7 once per step and emit the
    same greedy classes, equal to single-device mega's."""
    from lb_wavenet_tpu_torch.generate import generate_classes
    from lb_wavenet_tpu_torch.utils.convert import params_to_numpy

    from . import torch_tp_ranks as R

    p = init_params(11, SMALL)
    torch.multiprocessing.spawn(
        R.run_cuda_rank, args=(2, str(tmp_path / "store"), dataclasses.asdict(SMALL),
                               params_to_numpy(p), str(tmp_path)),
        nprocs=2, join=True)
    out = [torch.load(tmp_path / f"cuda_rank{r}.pt") for r in range(2)]
    assert [o["backend"] for o in out] == ["gloo", "gloo"]
    assert [o["device"] for o in out] == ["cuda:0", "cuda:0"]
    assert all(o["launches"] == 32 for o in out)
    ref = generate_classes(p, SMALL, 3, 16, 32, engine="mega", temperature=0.0, device=cuda)
    assert torch.equal(out[0]["classes"], out[1]["classes"])
    assert torch.equal(out[0]["classes"], ref.cpu())


def _near_argmax_gap(logits_tf, cls, lane, temperature):
    """Largest gap between the best score and the chosen class's score,
    scores from the plain version's teacher-forced logits (T, Q, B)."""
    gap = 0.0
    for t in range(cls.shape[0]):
        s = logits_tf[t]
        if temperature > 0.0:
            q = s.shape[0]
            s = s * ar_mega._inv_temp(temperature) + ar_mega.gumbel_from_bits(
                ar_mega._perlane_bits(q, lane, t))
        chosen = s.gather(0, cls[t].long()[None, :])[0]
        gap = max(gap, float((s.max(dim=0).values - chosen).max()))
    return gap


@pytest.mark.parametrize("engine", ["mega", "turbo"])
def test_bf16_tensor_core_kernels_match_plain(cuda, engine):
    """bf16 SMALL: the tensor-core kernel against its plain version, which
    on the card sums as the tensor cores do: teacher-forced logits and
    carry bit for bit, and a per-lane sampled free run whose every choice
    is a near-argmax (gap <= 0.1) of the plain scores on the kernel's own
    history."""
    from lb_wavenet_tpu_torch.ops.cuda import ar_tc, ar_turbo

    arch = dataclasses.replace(SMALL, compute_dtype="bfloat16")
    p = init_params(12, arch, cuda)
    b, t = 24, 40
    g = torch.Generator(device=cuda).manual_seed(12)
    lane = torch.stack([torch.randint(0, 2**31 - 1, (b,), generator=g, device=cuda),
                        torch.zeros(b, device=cuda, dtype=torch.int64)]).to(torch.int32)
    h0, e0 = _fused_frontend_zero(p, arch, b)
    if engine == "mega":
        def state():
            return ar_mega.mega_zero_carry(arch, h0, e0)
        kernel, plain = ar_mega.mega_generate_cuda, ar_mega.mega_generate_plain
        counter = ar_mega.mega_generate
    else:
        def state():
            return {"bufs": torch.zeros((sum(arch.dilations), b, 16), device=cuda),
                    "h": h0.clone(), "e": e0.clone()}
        kernel, plain = ar_turbo.turbo_generate_cuda, ar_turbo.turbo_generate_plain
        counter = ar_turbo.turbo_step

    def run(fn, forced, emit):
        st = state()
        cls, lg = fn(p, p["layers"], arch, st, 0, forced, 1.0, emit, lane, 3)
        torch.cuda.synchronize()
        if lg is not None and engine == "turbo":
            lg = lg.transpose(1, 2)      # (T, Q, B) as mega's
        return cls, lg, st

    forced = torch.randint(0, 256, (t, b), generator=g, device=cuda, dtype=torch.int32)
    n = counter.launches
    _, lk, sk = run(kernel, forced, True)
    assert counter.launches == n + (1 if engine == "mega" else t)
    _, lp, sp = run(plain, forced, True)
    assert ar_tc.default_order(arch, torch.bfloat16, cuda)
    torch.testing.assert_close(lk, lp, rtol=0, atol=0)
    for k in sk:
        torch.testing.assert_close(sk[k], sp[k], rtol=0, atol=0)
    free = torch.full((t, b), -1, device=cuda, dtype=torch.int32)
    cls, _, _ = run(kernel, free, False)
    _, lg_tf, _ = run(plain, cls, True)
    assert _near_argmax_gap(lg_tf, cls, lane, 1.0) <= 0.1


@pytest.mark.parametrize("engine", ["mega", "turbo"])
def test_bf16_lane_result_does_not_depend_on_the_batch(cuda, engine):
    """The same lane state at lane 301 of B=512 and at lane 2 of B=8 gives
    bit-identical logits and classes over 12 steps (per-lane sampling):
    the tensor-core kernels' sums do not depend on B or the lane's place."""
    import os

    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.ops.cuda import ar_turbo

    arch = Config.load(os.path.join(os.path.dirname(__file__), "..", "configs",
                                    "wavenet30.json")).arch
    p = init_params(13, arch, cuda)
    g = torch.Generator(device=cuda).manual_seed(13)
    big, small, at, to = 512, 8, 301, 2
    t = 12
    c, k, sd = arch.residual_channels, arch.input_kernel, sum(arch.dilations)
    lane_big = torch.stack([torch.randint(0, 2**31 - 1, (big,), generator=g, device=cuda),
                            torch.randint(-50, 50, (big,), generator=g, device=cuda)]
                           ).to(torch.int32)
    lane_small = torch.stack([torch.randint(0, 2**31 - 1, (small,), generator=g, device=cuda),
                              torch.zeros(small, device=cuda, dtype=torch.int64)]
                             ).to(torch.int32)
    lane_small[:, to] = lane_big[:, at]
    if engine == "mega":
        shapes = {"bufs": sd * c, "hstate": 2 * len(arch.dilations) * c, "h_s": c,
                  "e_s": (k - 1) * c}
        s_big = {n: torch.randn((r, big), device=cuda, generator=g) for n, r in shapes.items()}
        s_small = {n: torch.randn((r, small), device=cuda, generator=g) for n, r in shapes.items()}
        for n in shapes:
            s_small[n][:, to] = s_big[n][:, at]
        fn, lane_axis = ar_mega.mega_generate_cuda, 2
    else:
        def rnd_state(bb):
            return {"bufs": torch.randn((sd, bb, c), device=cuda, generator=g),
                    "h": torch.randn((bb, c), device=cuda, generator=g),
                    "e": torch.randn((k - 1, bb, c), device=cuda, generator=g)}
        s_big, s_small = rnd_state(big), rnd_state(small)
        s_small["bufs"][:, to] = s_big["bufs"][:, at]
        s_small["h"][to] = s_big["h"][at]
        s_small["e"][:, to] = s_big["e"][:, at]
        fn, lane_axis = ar_turbo.turbo_generate_cuda, 1
    outs = []
    for st, lane, bb in ((s_big, lane_big, big), (s_small, lane_small, small)):
        free = torch.full((t, bb), -1, device=cuda, dtype=torch.int32)
        outs.append(fn(p, p["layers"], arch, st, 4000, free, 1.0, True, lane, 0))
    torch.cuda.synchronize()
    (cls_b, lg_b), (cls_s, lg_s) = outs
    assert torch.equal(cls_b[:, at], cls_s[:, to])
    assert torch.equal(lg_b.select(lane_axis, at), lg_s.select(lane_axis, to))


@pytest.mark.parametrize("engine", ["mega", "turbo"])
def test_bf16_sampling_at_cuda_core_widths_matches_plain(cuda, engine):
    """bf16 at C = 24 (not a multiple of 16): the CUDA-core route, no
    ValueError, teacher-forced logits within LOGIT_ATOL of the plain
    version in its one-fp32-sum order."""
    from lb_wavenet_tpu_torch.ops.cuda import ar_tc, ar_turbo

    arch = dataclasses.replace(SMALL, compute_dtype="bfloat16", residual_channels=24)
    assert ar_tc.route(arch, torch.bfloat16) == "cuda_cores"
    assert not ar_tc.default_order(arch, torch.bfloat16, cuda)
    p = init_params(14, arch, cuda)
    b, t = 16, 32
    g = torch.Generator(device=cuda).manual_seed(14)
    lane = torch.stack([torch.randint(0, 2**31 - 1, (b,), generator=g, device=cuda),
                        torch.zeros(b, device=cuda, dtype=torch.int64)]).to(torch.int32)
    h0, e0 = _fused_frontend_zero(p, arch, b)
    if engine == "mega":
        def state():
            return ar_mega.mega_zero_carry(arch, h0, e0)
        kernel, plain, counter = (ar_mega.mega_generate_cuda, ar_mega.mega_generate_plain,
                                  ar_mega.mega_generate)
    else:
        def state():
            return {"bufs": torch.zeros((sum(arch.dilations), b, 24), device=cuda),
                    "h": h0.clone(), "e": e0.clone()}
        kernel, plain, counter = (ar_turbo.turbo_generate_cuda,
                                  ar_turbo.turbo_generate_plain, ar_turbo.turbo_step)
    forced = torch.randint(0, 256, (t, b), generator=g, device=cuda, dtype=torch.int32)
    n = counter.launches
    _, lk = kernel(p, p["layers"], arch, state(), 0, forced, 1.0, True, lane, 3)
    torch.cuda.synchronize()
    assert counter.launches == n + (1 if engine == "mega" else t)
    _, lp = plain(p, p["layers"], arch, state(), 0, forced, 1.0, True, lane, 3)
    torch.testing.assert_close(lk, lp, rtol=0, atol=5e-2)


# ---------------------------------------------------------------------------
# The one-step stack kernels B1 (fused_stack) and B7 (tp_fused_stack): the
# tensor-core route against its plain version, which on the card sums as
# the tensor cores do, bit for bit; the CUDA-core route at its tolerances.

def _config_arch(name):
    import os

    from lb_wavenet_tpu_torch.config import Config

    if name == "small":
        return dataclasses.replace(SMALL, compute_dtype="bfloat16")
    path = {"wavenet30": "wavenet30.json", "stress": "stress_gen.json"}[name]
    return Config.load(os.path.join(os.path.dirname(__file__), "..", "configs", path)).arch


def _skip_cut(lp, arch, half):
    """Layer params on model rank `half` of two (None: the whole skip)."""
    if half is None:
        return lp
    s = arch.skip_channels // 2
    sl = slice(half * s, (half + 1) * s)
    return {**lp, "w_skip": lp["w_skip"][..., sl], "b_skip": lp["b_skip"][..., sl]}


@pytest.mark.parametrize("width,b", [(w, b) for w in ("small", "wavenet30")
                                     for b in (512, 100, 6)])
def test_fused_stack_tensor_core_route_is_bit_exact(cuda, width, b):
    """bf16 B1 on the tensor-core route: ring and skip equal the plain
    version's at atol 0, at whole, ragged and sub-tile batches, on the
    whole skip width and on a model rank's half."""
    from lb_wavenet_tpu_torch.ops.cuda import ar_tc

    arch = _config_arch(width)
    p = init_params(15, arch, cuda)
    c, g = arch.residual_channels, arch.gate_channels
    gen = torch.Generator(device=cuda).manual_seed(15 + b)
    ring = torch.randn((sum(arch.dilations), b, c), device=cuda, generator=gen)
    h0 = torch.randn((b, c), device=cuda, generator=gen)
    for half in (None, 0):
        lp = _skip_cut(p["layers"], arch, half)
        s = lp["w_skip"].shape[-1]
        assert ar_tc.stack_route(c, g, s, len(arch.dilations), torch.bfloat16) == "tensor_cores"
        r_k, r_p = ring.clone(), ring.clone()
        n = ar_step.fused_stack.launches
        _, s_k = ar_step.fused_stack(lp, arch, h0, r_k, 1000)
        torch.cuda.synchronize()
        assert ar_step.fused_stack.launches == n + 1 and s_k.shape == (b, s)
        _, s_p = ar_step.fused_stack_plain(lp, arch, h0, r_p, 1000)
        torch.testing.assert_close(r_k, r_p, rtol=0, atol=0)
        torch.testing.assert_close(s_k, s_p, rtol=0, atol=0)


@pytest.mark.parametrize("width,b", [(w, b) for w in ("small", "wavenet30", "stress")
                                     for b in (256, 100, 4)])
def test_tp_fused_stack_tensor_core_route_is_bit_exact(cuda, width, b):
    """bf16 B7 on the tensor-core route: ring and local skip equal the plain
    version's at atol 0 on the whole skip width and on each half (model
    axis 2), and the halves concatenate to the whole exactly; B = 100 and
    B = 4 take the masked and 4-byte tap copies."""
    from lb_wavenet_tpu_torch.generate import _tp_weights
    from lb_wavenet_tpu_torch.ops.cuda import ar_tc, ar_tp

    arch = _config_arch(width)
    p = init_params(16, arch, cuda)
    c = arch.residual_channels
    h0, ring = _tp_inputs(arch, b, 16 + b, cuda)
    skips = {}
    for half in (None, 0, 1):
        fm = _tp_weights(p, _skip_cut(p["layers"], arch, half), torch.bfloat16)
        s_l = fm["wrs"].shape[1] - c
        assert ar_tc.stack_route(c, arch.gate_channels, s_l, len(arch.dilations),
                                 torch.bfloat16) == "tensor_cores"
        r_k, r_p = ring.clone(), ring.clone()
        n = ar_tp.tp_fused_stack.launches
        _, skips[half] = ar_tp.tp_fused_stack(fm, arch, h0, r_k, 1000)
        torch.cuda.synchronize()
        assert ar_tp.tp_fused_stack.launches == n + 1
        _, s_p = ar_tp.tp_fused_stack_plain(fm, arch, h0, r_p, 1000)
        torch.testing.assert_close(r_k, r_p, rtol=0, atol=0)
        torch.testing.assert_close(skips[half], s_p, rtol=0, atol=0)
    assert torch.equal(torch.cat([skips[0], skips[1]]), skips[None])


@pytest.mark.parametrize("kernel", ["fused_stack", "tp_fused_stack"])
def test_stack_lane_result_does_not_depend_on_the_batch(cuda, kernel):
    """The same lane state at lane 301 of B=512 (B1, WaveNet-30) or 201 of
    B=256 (B7, the stress config) and at lane 2 of B=4 gives bit-identical
    ring rows and skip sums on the tensor-core route."""
    from lb_wavenet_tpu_torch.generate import _tp_weights
    from lb_wavenet_tpu_torch.ops.cuda import ar_tp

    arch = _config_arch("wavenet30" if kernel == "fused_stack" else "stress")
    p = init_params(17, arch, cuda)
    c, sd = arch.residual_channels, sum(arch.dilations)
    big, at, small, to = (512, 301, 4, 2) if kernel == "fused_stack" else (256, 201, 4, 2)
    gen = torch.Generator(device=cuda).manual_seed(17)
    if kernel == "fused_stack":
        ring_b = torch.randn((sd, big, c), device=cuda, generator=gen)
        h_b = torch.randn((big, c), device=cuda, generator=gen)
        ring_s = torch.randn((sd, small, c), device=cuda, generator=gen)
        h_s = torch.randn((small, c), device=cuda, generator=gen)
        ring_s[:, to], h_s[to] = ring_b[:, at], h_b[at]
        _, sk_b = ar_step.fused_stack(p["layers"], arch, h_b, ring_b, 4321)
        _, sk_s = ar_step.fused_stack(p["layers"], arch, h_s, ring_s, 4321)
        torch.cuda.synchronize()
        assert torch.equal(sk_b[at], sk_s[to]) and torch.equal(ring_b[:, at], ring_s[:, to])
    else:
        fm = _tp_weights(p, p["layers"], torch.bfloat16)
        h_b, ring_b = _tp_inputs(arch, big, 18, cuda)
        h_s, ring_s = _tp_inputs(arch, small, 19, cuda)
        ring_s[..., to], h_s[:, to] = ring_b[..., at], h_b[:, at]
        _, sk_b = ar_tp.tp_fused_stack(fm, arch, h_b, ring_b, 4321)
        _, sk_s = ar_tp.tp_fused_stack(fm, arch, h_s, ring_s, 4321)
        torch.cuda.synchronize()
        assert torch.equal(sk_b[:, at], sk_s[:, to])
        assert torch.equal(ring_b[..., at], ring_s[..., to])


@pytest.mark.parametrize("name,c,g,s,n_layers", [
    ("fused_stack", 16, 16, 32, 8), ("fused_stack", 64, 64, 256, 30),
    ("fused_stack", 64, 64, 128, 30), ("tp_fused_stack", 64, 64, 512, 30),
    ("tp_fused_stack", 64, 64, 256, 30), ("tp_fused_stack", 64, 64, 704, 30)])
def test_stack_libraries_carve_stack_smem(cuda, name, c, g, s, n_layers):
    """The built libraries' shared-memory counts of the tensor-core stack
    kernel equal ar_tc.stack_smem, on which the route is decided."""
    from lb_wavenet_tpu_torch.ops.cuda import ar_tc, build

    lib = build.load("ar_step" if name == "fused_stack" else "ar_tp")
    assert ar_tc.lib_stack_smem(lib, name, c, g, s, n_layers) == \
        ar_tc.stack_smem(c, g, s, n_layers)[0]


@pytest.mark.parametrize("kernel", ["fused_stack", "tp_fused_stack"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_cuda_core_route_meets_its_tolerance(cuda, kernel, dtype):
    """fp32 WaveNet-30 widths, and bf16 at C = G = 24 (not multiples of 16):
    the CUDA-core route, against the plain version in its one-fp32-sum
    order, B1 within LOGIT_ATOL (5e-2) and B7's skip within TP_RTOL (1e-2)
    of its largest value."""
    from lb_wavenet_tpu_torch.generate import _tp_weights
    from lb_wavenet_tpu_torch.ops.cuda import ar_tc, ar_tp

    arch = _config_arch("wavenet30")
    arch = dataclasses.replace(arch, compute_dtype=dtype) if dtype == "float32" else \
        dataclasses.replace(arch, residual_channels=24, gate_channels=24)
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    c, g, s, L = arch.residual_channels, arch.gate_channels, arch.skip_channels, 30
    assert ar_tc.stack_route(c, g, s, L, dt) == "cuda_cores"
    assert not ar_tc.stack_default_order(c, g, s, L, dt, cuda)
    p = init_params(20, arch, cuda)
    b = 100
    if kernel == "fused_stack":
        gen = torch.Generator(device=cuda).manual_seed(20)
        ring = torch.randn((sum(arch.dilations), b, c), device=cuda, generator=gen)
        h0 = torch.randn((b, c), device=cuda, generator=gen)
        r_k, r_p = ring.clone(), ring.clone()
        _, s_k = ar_step.fused_stack(p["layers"], arch, h0, r_k, 700)
        torch.cuda.synchronize()
        _, s_p = ar_step.fused_stack_plain(p["layers"], arch, h0, r_p, 700)
        torch.testing.assert_close(r_k, r_p, rtol=0, atol=5e-2)
        torch.testing.assert_close(s_k, s_p, rtol=0, atol=5e-2)
    else:
        fm = _tp_weights(p, p["layers"], dt)
        h0, ring = _tp_inputs(arch, b, 21, cuda)
        r_k, r_p = ring.clone(), ring.clone()
        _, s_k = ar_tp.tp_fused_stack(fm, arch, h0, r_k, 700)
        torch.cuda.synchronize()
        _, s_p = ar_tp.tp_fused_stack_plain(fm, arch, h0, r_p, 700)
        torch.testing.assert_close(r_k, r_p, rtol=0, atol=5e-2)
        assert float((s_k - s_p).abs().max()) <= 1e-2 * float(s_p.abs().max())


# ---------------------------------------------------------------------------
# The conditioned variants (mel and/or speaker: one folded cond row of Cc'
# channels a lane).

COND_SMALL = dataclasses.replace(SMALL, compute_dtype="bfloat16", n_mels=8, cond_channels=16,
                                 upsample_factors=(4,), n_speakers=4, speaker_embed_dim=16)
COND_ROUTES = {   # (dtype, Cc, with speakers, atol, route)
    "tensor_cores": ("bfloat16", 16, False, 0.0, "tensor_cores"),
    "tensor_cores_speakers": ("bfloat16", 16, True, 0.0, "tensor_cores"),
    "cuda_cores_fp32": ("float32", 16, True, 1e-4, "cuda_cores"),
    "cuda_cores_bf16_cc8": ("bfloat16", 8, False, 5e-2, "cuda_cores"),
}


@pytest.mark.parametrize("kernel", ["mega", "turbo", "fused_stack", "tp_fused_stack"])
@pytest.mark.parametrize("case", list(COND_ROUTES))
def test_conditioned_kernels_match_plain(cuda, kernel, case):
    """Each conditioned kernel against its plain version on the same CUDA
    inputs: bit for bit on the tensor-core route (Cc' = 16, and 32 with the
    speaker rows folded in), where the plain versions sum cond's k-steps in
    the gate's chain as the kernels do; on the CUDA-core route (fp32, and
    bf16 with Cc' = 8, not a multiple of 16) within 1e-4 (fp32 sums in
    another order) and 5e-2 (a bf16 rounding flip of one activation),
    over 16 teacher-forced steps from the zero state or one stack step."""
    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.models.wavenet import compute_dtype
    from lb_wavenet_tpu_torch.ops.cuda import ar_tc, ar_tp, ar_turbo

    dtype, cc, speakers, atol, route = COND_ROUTES[case]
    arch = dataclasses.replace(COND_SMALL, compute_dtype=dtype, cond_channels=cc)
    dt = compute_dtype(arch)
    p = init_params(13, arch, cuda)
    g = torch.Generator(device=cuda).manual_seed(13)
    b, t = 16, 16
    cond = torch.randn((t, b, cc), device=cuda, generator=g)
    lp = p["layers"]
    if speakers:
        ids = torch.randint(0, 4, (b,), device=cuda, generator=g)
        lp, cond = G._fold_gcond(lp, cond, p["speaker_embed"][ids], t)
    width = cond.shape[-1]
    assert ar_tc.route(arch, dt, width) == route
    assert ar_tc.stack_route(16, 16, 16, len(arch.dilations), dt, width) == route
    h0, e0 = _fused_frontend_zero(p, arch, b)
    lane = torch.stack([torch.randint(0, 2**31 - 1, (b,), generator=g, device=cuda),
                        torch.zeros(b, device=cuda, dtype=torch.int64)]).to(torch.int32)
    forced = torch.randint(0, 256, (t, b), generator=g, device=cuda, dtype=torch.int32)
    outs = []
    for fn in ("kernel", "plain"):
        if kernel == "mega":
            st = ar_mega.mega_zero_carry(arch, h0, e0)
            run = ar_mega.mega_generate_cuda if fn == "kernel" else ar_mega.mega_generate_plain
            _, lg = run(p, lp, arch, st, 0, forced, 1.0, True, lane, 3, cond=cond)
            out = [lg, *st.values()]
        elif kernel == "turbo":
            st = {"bufs": torch.zeros((sum(arch.dilations), b, 16), device=cuda),
                  "h": h0.clone(), "e": e0.clone()}
            run = (ar_turbo.turbo_generate_cuda if fn == "kernel"
                   else ar_turbo.turbo_generate_plain)
            _, lg = run(p, lp, arch, st, 0, forced, 1.0, True, lane, 3, cond=cond)
            out = [lg, *st.values()]
        elif kernel == "fused_stack":
            ring = torch.randn((sum(arch.dilations), b, 16), device=cuda,
                               generator=torch.Generator(device=cuda).manual_seed(1))
            if fn == "kernel":
                _, skip = ar_step.fused_stack(lp, arch, h0, ring, 37, cond[0])
            else:
                _, skip = ar_step.fused_stack_plain(lp, arch, h0, ring, 37, cond_t=cond[0])
            out = [ring, skip]
        else:
            half = {**lp, "w_skip": lp["w_skip"][..., :16], "b_skip": lp["b_skip"][..., :16]}
            fm = G._tp_weights(p, half, dt)
            ring = torch.randn((sum(arch.dilations), 16, b), device=cuda,
                               generator=torch.Generator(device=cuda).manual_seed(1))
            cond_fm = cond[0].t().contiguous()
            if fn == "kernel":
                _, skip = ar_tp.tp_fused_stack(fm, arch, h0.t().contiguous(), ring, 37, cond_fm)
            else:
                _, skip = ar_tp.tp_fused_stack_plain(fm, arch, h0.t().contiguous(), ring, 37,
                                                     cond_t=cond_fm)
            out = [ring, skip]
        torch.cuda.synchronize()
        outs.append(out)
    for k, p_ in zip(*outs):
        torch.testing.assert_close(k, p_, rtol=0, atol=atol)
