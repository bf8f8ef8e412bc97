"""Port tests that need the card: the masked variants of the training-stack
and frontend kernel pairs (the sequence-parallel halo mask, the TPU
kernels' has_mask / input_mask) against their plain versions on the same
CUDA inputs, on both routes, an all-ones mask against the unmasked
kernels, and masked rows exactly 0. They skip without a GPU; on one, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mask.py
"""
import dataclasses

import pytest
import torch

from lb_wavenet_tpu_torch.config import ArchConfig
from lb_wavenet_tpu_torch.models.wavenet import compute_dtype, init_params

pytestmark = pytest.mark.cuda
SMALL = ArchConfig(n_blocks=2, n_layers_per_block=4, residual_channels=16,
                   skip_channels=32, gate_channels=16, compute_dtype="float32")
WIDTHS = {"small": {}, "c24": {"residual_channels": 24, "gate_channels": 24},
          "stress": {"residual_channels": 64, "gate_channels": 64, "skip_channels": 512}}
B, T, HALO = 3, 70, 23   # a ragged last tile; row 0's first HALO positions masked


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mask(device):
    m = torch.ones((B, T), device=device)
    m[0, :HALO] = 0.0
    return m


def _stack_case(cuda, arch, cc, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    layers = dict(init_params(seed, arch, cuda)["layers"])
    for k in ("b", "b_res", "b_skip"):   # nonzero biases: they must not leak
        layers[k] = torch.randn(layers[k].shape, device=cuda, generator=g) / 5
    if cc:
        layers["w_cond"] = torch.randn((len(arch.dilations), cc, 2 * arch.gate_channels),
                                       device=cuda, generator=g) / cc ** 0.5
    mask = _mask(cuda)
    h0 = torch.randn((B, T, arch.residual_channels), device=cuda, generator=g) * mask[..., None]
    cond = torch.randn((B, T, cc), device=cuda, generator=g) if cc else None
    gs = torch.randn((B, T, arch.skip_channels), device=cuda, generator=g)
    return layers, h0, cond, gs, mask


@pytest.mark.parametrize("dtype,width,cc", [("float32", "small", 0), ("float32", "small", 8),
                                             ("bfloat16", "small", 0), ("bfloat16", "small", 16),
                                             ("bfloat16", "c24", 16), ("bfloat16", "stress", 64)])
@pytest.mark.parametrize("tapcat", [False, True])
def test_masked_train_stack_kernels_match_plain(cuda, dtype, width, cc, tapcat):
    """The masked pair through the autograd Function against the plain
    versions: on the tensor-core route (bf16 SMALL; the stress widths, S =
    512 in two passes) bit for bit in skip, dh0, d cond and every weight
    gradient; on the CUDA-core route (fp32; bf16 at C = G = 24) within 1e-5
    / 1e-2 of each leaf's largest magnitude. The masked launch counts are
    each route's (no extra launch); x_all's masked rows are 0."""
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    arch = dataclasses.replace(SMALL, compute_dtype=dtype, **WIDTHS[width])
    dt = compute_dtype(arch)
    c, s = arch.residual_channels, arch.skip_channels
    layers, h0, cond0, gs, mask = _stack_case(cuda, arch, cc, 11 + cc)
    lp = {k: v.clone().requires_grad_(True) for k, v in layers.items()}
    h = h0.clone().requires_grad_(True)
    cond = None if cond0 is None else cond0.clone().requires_grad_(True)
    n = [TS.train_stack_fwd.mask_launches, TS.train_stack_bwd.mask_launches]
    fused = TS.make_fused_stack(arch, has_cond=bool(cc), tapcat=tapcat, has_mask=True)
    skip = fused(lp, h, *([cond] if cc else []), mask)
    (skip * gs).sum().backward()
    torch.cuda.synchronize()
    L = len(arch.dilations)
    tc = TS.route(c, arch.gate_channels, s, dt, cc) == "tensor_cores"
    assert tc == (dtype == "bfloat16" and width != "c24")
    assert TS.train_stack_fwd.mask_launches == n[0] + L + 1
    assert TS.train_stack_bwd.mask_launches == n[1] + (2 * L + 3 if tc else 3 * L + 1)
    sp, zp, xp = TS.stack_fwd_plain(layers, h0, arch.dilations, dt, tapcat, cond=cond0,
                                    mask=mask)
    assert torch.all(xp[:, mask == 0] == 0.0)
    dp, gp = TS.stack_bwd_plain(layers, arch.dilations, dt, tapcat, zp, xp, gs, cond=cond0,
                                mask=mask)
    rtol = 0.0 if tc else (1e-5 if dtype == "float32" else 1e-2)

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=rtol * float(b.abs().max()))

    close(skip.detach(), sp)
    close(h.grad, dp)
    if cc:
        close(cond.grad, gp.pop("cond"))
    for k in gp:
        close(lp[k].grad, gp[k])


@pytest.mark.parametrize("dtype,width", [("float32", "small"), ("bfloat16", "small"),
                                         ("bfloat16", "c24")])
def test_all_ones_mask_is_the_unmasked_stack_bit_for_bit(cuda, dtype, width):
    """Multiplying by 1.0 is exact: with an all-ones mask the kernels give
    the unmasked kernels' skip, z, x, dh0 and gradients bit for bit, on both
    routes; a masked kernel's x_all rows under the mask are 0."""
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    arch = dataclasses.replace(SMALL, compute_dtype=dtype, **WIDTHS[width])
    dt, dils = compute_dtype(arch), arch.dilations
    layers, h0, cond, gs, mask = _stack_case(cuda, arch, 16, 21)
    ones = torch.ones_like(mask)
    a = TS.train_stack_fwd(layers, h0, dils, dt, True, cond=cond, mask=ones)
    b = TS.train_stack_fwd(layers, h0, dils, dt, True, cond=cond)
    da, ga = TS.train_stack_bwd(layers, dils, dt, True, *a[1:], gs, cond=cond, mask=ones)
    db, gb = TS.train_stack_bwd(layers, dils, dt, True, *b[1:], gs, cond=cond)
    _, _, xm = TS.train_stack_fwd(layers, h0, dils, dt, True, cond=cond, mask=mask)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(da, db) and all(torch.equal(ga[k], gb[k]) for k in gb)
    assert torch.all(xm[:, mask == 0] == 0.0)


@pytest.mark.parametrize("c,k_taps,dtype,want", [
    (64, 2, torch.bfloat16, "tensor_cores"),   # WaveNet-30's widths
    (16, 2, torch.bfloat16, "tensor_cores"),
    (64, 2, torch.float32, "cuda_cores"),
    (24, 2, torch.bfloat16, "cuda_cores"),
])
def test_masked_frontend_kernels_match_plain(cuda, c, k_taps, dtype, want):
    """The masked frontend pair against its plain versions at B = 3, T = 70:
    h0 bit for bit on the tensor-core route (within 1e-5 of its largest
    value elsewhere) and its masked rows exactly 0 despite the bias; every
    gradient within the unmasked pair's tolerances (1e-5 fp32, 1e-2 bf16);
    the route's launches, counted as masked; an all-ones mask gives the
    unmasked kernels' h0 and gradients bit for bit."""
    from lb_wavenet_tpu_torch.ops.cuda import frontend as F

    assert F.route(256, c, k_taps, dtype) == want
    g = torch.Generator(device=cuda).manual_seed(c + k_taps)
    embed = torch.randn((256, c), device=cuda, generator=g)
    w = torch.randn((k_taps, c, c), device=cuda, generator=g) / (c ** 0.5)
    bias = torch.randn(c, device=cuda, generator=g) / 3
    x = torch.randint(0, 256, (B, T), device=cuda, generator=g, dtype=torch.int32)
    dh = torch.randn((B, T, c), device=cuda, generator=g)
    mask = _mask(cuda)
    n = (F.frontend_fwd.mask_launches, F.frontend_bwd.mask_launches)
    h = F.frontend_fwd(embed, w, bias, x, dtype, mask=mask)
    grads = F.frontend_bwd(embed, w, x, dtype, dh, mask=mask)
    torch.cuda.synchronize()
    tc = want == "tensor_cores"
    assert (F.frontend_fwd.mask_launches - n[0],
            F.frontend_bwd.mask_launches - n[1]) == (2, 3 if tc else 4)
    hp = F.frontend_fwd_plain(embed, w, bias, x, dtype, mask=mask)
    gp = F.frontend_bwd_plain(embed, w, x, dtype, dh, mask=mask)
    assert torch.all(h[mask == 0] == 0.0)
    if tc:
        assert torch.equal(h, hp)
    torch.testing.assert_close(h, hp, rtol=0, atol=1e-5 * float(hp.abs().max()))
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, ref in zip(grads, gp):
        torch.testing.assert_close(got, ref, rtol=0, atol=rtol * float(ref.abs().max()))
    ones = torch.ones_like(mask)
    assert torch.equal(F.frontend_fwd(embed, w, bias, x, dtype, mask=ones),
                       F.frontend_fwd(embed, w, bias, x, dtype))
    for u, v in zip(F.frontend_bwd(embed, w, x, dtype, dh, mask=ones),
                    F.frontend_bwd(embed, w, x, dtype, dh)):
        assert torch.equal(u, v)
