"""Port tests: Tacotron 2's WaveNet vocoder (arch.output_dist == "mol")
against its plain reference (lb_wavenet_tpu_torch/reference/mol_wavenet.py)
on the CPU, at tiny fp32 and bf16 widths: the MoL NLL and its closed-form
gradient (the three edge cases included), the scalar frontend and the
teacher-forced forward, three train steps against three reference Adam
steps, xla-engine generation (replay per lane seed, streaming, the head
outputs against the reference's teacher-forced forward over the generated
samples), the 16-bit loader windows, the head pair's plain route, and what
a mol arch refuses. The head kernel pair against its plain version runs on
the card (marker `cuda`)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from lb_wavenet_tpu_torch import generate as G
from lb_wavenet_tpu_torch import train as PT
from lb_wavenet_tpu_torch.config import ArchConfig, Config, TrainConfig
from lb_wavenet_tpu_torch.data import Corpus, make_batches
from lb_wavenet_tpu_torch.models import conditioning as PC
from lb_wavenet_tpu_torch.models.wavenet import forward, init_params
from lb_wavenet_tpu_torch.ops import geometry, mol
from lb_wavenet_tpu_torch.ops.cuda import post_mol as PM
from lb_wavenet_tpu_torch.reference import mol_wavenet as R

torch.set_num_threads(1)
# The Tacotron 2 layout at CI size: 10 components, mel through two stages.
ARCH = ArchConfig(n_blocks=2, n_layers_per_block=3, residual_channels=16, skip_channels=32,
                  gate_channels=16, n_mels=8, cond_channels=8, upsample_factors=(2, 3),
                  sample_rate=24000, compute_dtype="float32", output_dist="mol", n_mix=10)
TRAIN = TrainConfig(batch_size=2, window_size=48, learning_rate=1e-3, fused_stack=True,
                    tapcat=True)
M = ARCH.n_mix


def _rdict(arch):
    return dataclasses.asdict(arch)


def _head_rows(n=64, seed=0):
    """Head outputs and targets that visit every case of the NLL: x = -1 and
    x > 0.999 (the edges), narrow logistics (delta > 1e-5) and wide ones
    (delta <= 1e-5, the mid-bin density), log-scales below the clamp."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((n, 3 * M), generator=g)
    y[:, 2 * M:] = torch.linspace(-9.0, 6.0, n)[:, None] + 0.3 * torch.randn((n, M), generator=g)
    x = mol.to_grid(torch.rand(n, generator=g) * 2 - 1)
    x[:4] = -1.0
    x[4:8] = 32767 / 32768
    y[8:12, M:2 * M] = x[8:12, None]          # targets at the means of narrow ones
    y[8:12, 2 * M:] = -8.0
    return y, x


def _err(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _as_accurate(got, f32, f64):
    """got is as close to the float64 truth as float32 autograd is (the
    NLL's wide-bin branch subtracts two sigmoids a bin apart: its gradient
    cancels in float32 whichever way it is written)."""
    assert _err(got, f64) <= 2 * _err(f32, f64) + 1e-6, (_err(got, f64), _err(f32, f64))


def test_nll_cases_and_gradient_against_reference():
    y, x = _head_rows()
    lp, (low, high, wide), _ = mol._log_probs(y, x, M)
    mid_rows = ~(low | high)
    assert low.any() and high.any()
    assert (wide & mid_rows).any() and (~wide & mid_rows).any()
    torch.testing.assert_close(mol.mol_nll(y, x, M), R.nll(y, x, M), rtol=1e-5, atol=1e-5)
    w = torch.rand(len(x), generator=torch.Generator().manual_seed(1))
    grads = []
    for dt in (torch.float32, torch.float64):
        yr = y.detach().to(dt).clone().requires_grad_(True)
        (R.nll(yr, x.to(dt), M) * w.to(dt)).sum().backward()
        grads.append(yr.grad)
    _as_accurate(mol.mol_nll_bwd(y, x, M, w), *grads)


def _batch(arch, b, t, seed):
    g = torch.Generator().manual_seed(seed)
    x = mol.to_grid(0.5 * torch.sin(torch.arange(t) * 0.07 + torch.rand(b, 1, generator=g) * 6))
    frames = torch.randn((b, -(-t // arch.hop_size), arch.n_mels), generator=g)
    return x, frames


@pytest.mark.parametrize("fused", [False, True])
def test_forward_against_reference(fused):
    """The scalar frontend, the stack (plain, or the fused pair's plain
    versions) and the head against the reference's teacher-forced forward."""
    p = init_params(0, ARCH)
    x, frames = _batch(ARCH, 2, 50, 0)
    cond = PC.upsample_cond_train(p["upsampler"], ARCH, frames, torch.float32)[:, :50]
    want = R.head_outputs(p, _rdict(ARCH), x,
                          R.upsample(p["upsampler"], ARCH.upsample_factors, frames)[:, :50])
    if fused:
        got = PT.forward_fused(p, ARCH, x, cond=cond, tapcat=True)
    else:
        got = forward(p, ARCH, x, cond=cond)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _ref_steps(p0, arch, batches, train, steps):
    """The reference's Adam steps (optax's adam, eps 1e-8): losses, the
    first gradient, the parameters after."""
    p = [t.detach().clone() for t in PT.tree_leaves(p0)]
    mu = [torch.zeros_like(v) for v in p]
    nu = [torch.zeros_like(v) for v in p]
    losses, g0 = [], None
    b1, b2, lr = train.adam_b1, train.adam_b2, train.learning_rate
    for s, batch in enumerate(batches[:steps]):
        for v in p:
            v.requires_grad_(True)
        it = iter(p)
        tree = PT.tree_map(lambda _: next(it), p0)
        cond = R.upsample(tree["upsampler"], arch.upsample_factors, batch["mel"])
        loss = R.masked_loss(tree, _rdict(arch), batch, train.window_size, cond=cond)
        g = torch.autograd.grad(loss, p)
        losses.append(float(loss.detach()))
        g0 = g0 or [v.clone() for v in g]
        with torch.no_grad():
            for i in range(len(p)):
                mu[i] = (1 - b1) * g[i] + b1 * mu[i]
                nu[i] = (1 - b2) * g[i] * g[i] + b2 * nu[i]
                p[i] = p[i] - lr * (mu[i] / (1 - b1 ** (s + 1))) / (
                    torch.sqrt(nu[i] / (1 - b2 ** (s + 1))) + 1e-8)
    return losses, g0, p


def _corpus(arch, window, seed=0, n=3, length=900):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / arch.sample_rate
    waves = [np.clip(0.4 * np.sin(2 * np.pi * rng.uniform(80, 400) * t)
                     + 0.05 * rng.standard_normal(length), -1, 1).astype(np.float32)
             for _ in range(n)]
    return Corpus(waves, arch, window)


def test_train_step_against_reference_adam():
    """train_step (the fused stack's and the head pair's plain versions)
    for three steps against three reference Adam steps from the same
    weights: losses, the first gradient and the parameters after."""
    corpus = _corpus(ARCH, TRAIN.window_size)
    host = make_batches(corpus, TRAIN, with_mel=True)
    batches = [PT.batch_to_device(next(host), "cpu") for _ in range(3)]
    p0 = init_params(1, ARCH)
    state = PT.TrainState(p0, PT.make_optimizer(TRAIN).init(p0), 0)
    losses = []
    for i, batch in enumerate(batches):
        state, loss = PT.train_step(state, batch, ARCH, TRAIN)
        losses.append(float(loss))
        if i == 0:
            g0 = [m / (1 - TRAIN.adam_b1) for m in PT.tree_leaves(state.opt_state["mu"])]
    r_losses, r_g0, r_p = _ref_steps(p0, ARCH, batches, TRAIN, 3)
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    # Per leaf, by norm (the benchmark's check compares so): the first
    # gradient within float32's cancellation in the NLL, the parameters
    # after three steps within Adam's sign-level sensitivity near 0.
    for got, want in zip(g0, r_g0):
        assert _err(got, want) < 1e-3
    p0_leaves = PT.tree_leaves(p0)
    for got, want, start in zip(PT.tree_leaves(state.params), r_p, p0_leaves):
        assert _err(got - start, want - start) < 1e-2


def test_loader_windows_are_16bit_samples():
    """Inputs and targets are the files' int16 values over 32768, cut by
    the softmax model's window geometry, with its mask."""
    corpus = _corpus(ARCH, TRAIN.window_size)
    batch = next(make_batches(corpus, TRAIN, with_mel=True))
    assert batch.inputs.dtype == np.float32 and batch.targets.dtype == np.float32
    assert np.abs(batch.inputs).max() <= 1.0 and np.all(batch.targets < 1.0)
    pcm = [mol.pcm16(w) for w in corpus.waves]
    for row in range(TRAIN.batch_size):
        hit = [(fi, wi) for fi, wi in corpus.index
               if np.array_equal(geometry.extract_window(pcm[fi], TRAIN.window_size,
                                                         ARCH.receptive_field, wi)[1]
                                 / 32768.0, batch.targets[row])]
        fi, wi = hit[0]
        inp, _, mask = geometry.extract_window(pcm[fi], TRAIN.window_size,
                                               ARCH.receptive_field, wi)
        np.testing.assert_array_equal(batch.inputs[row], inp / np.float32(32768.0))
        np.testing.assert_array_equal(batch.mask[row], mask)
    np.testing.assert_array_equal(mol.pcm16(np.array([-1.0, 32767 / 32768, 2.0, -3.0])),
                                  [-32768, 32767, 32767, -32768])


def test_xla_generation_replays_and_matches_reference():
    """Sampled and greedy xla-engine generation: the same seed replays, one
    lane's seed replays it alone, chunked streaming equals one shot, and
    each step's head outputs equal the reference's teacher-forced forward
    over the generated samples."""
    arch = dataclasses.replace(ARCH, n_mels=0, upsample_factors=())
    p = init_params(2, arch)
    n = 40
    x, y = G.generate_classes(p, arch, 7, 3, n, return_logits=True, device="cpu")
    x2 = G.generate_classes(p, arch, 7, 3, n, device="cpu")
    torch.testing.assert_close(x, x2, rtol=0, atol=0)
    assert x.dtype == torch.float32 and torch.all(x * 32768 == torch.round(x * 32768))
    prev = torch.cat([torch.zeros((3, 1)), x[:, :-1]], 1)
    torch.testing.assert_close(y, R.head_outputs(p, _rdict(arch), prev), rtol=1e-4, atol=1e-4)
    seeds = torch.tensor([11, 22, 33], dtype=torch.int32)
    st = G.start_stream(arch, 3, 0, engine="xla", device="cpu")
    parts = []
    for _ in range(2):
        out, st = G.stream_chunk(p, arch, st, n // 2, lane_seed=seeds,
                                 lane_t0=torch.zeros(3, dtype=torch.int32))
        parts.append(out)
    one = G.start_stream(arch, 1, 5, engine="xla", device="cpu")
    alone, _ = G.stream_chunk(p, arch, one, n, lane_seed=seeds[1:2],
                              lane_t0=torch.zeros(1, dtype=torch.int32))
    torch.testing.assert_close(torch.cat(parts, 1)[1:2], alone, rtol=0, atol=0)
    greedy = G.generate_classes(p, arch, 0, 2, 20, temperature=0.0, device="cpu")
    torch.testing.assert_close(greedy, G.generate_classes(p, arch, 9, 2, 20, temperature=0.0,
                                                          device="cpu"), rtol=0, atol=0)
    wav = G.generate(p, arch, 7, 3, n, device="cpu")
    torch.testing.assert_close(wav, x, rtol=0, atol=0)


def test_sampler_against_reference():
    """The port's sampler at given noise against the reference's: the same
    component, the same logistic draw to a grid step."""
    y, _ = _head_rows(32, 3)
    gum, u = G.perlane_mol_noise(torch.arange(32), torch.full((32,), 5), M)
    assert gum.shape == (32, M) and bool(((u > 0) & (u < 1)).all())
    for tau in (1.0, 0.7, 0.0):
        got = mol.sample_mol(y, M, tau, gum, u)
        want = R.sample(y, M, tau, gum, u)
        assert float((got - want).abs().max()) <= 1 / 32768


def test_head_pair_plain_route():
    """The head pair's autograd Function on the CPU (its plain versions)
    against the reference's loss and autograd: the numerator, d skip and
    the head's gradients; and its tensor-core order against one fp32 sum
    per product in bf16 (the emulation the card's comparison uses)."""
    g = torch.Generator().manual_seed(4)
    b, t, w, s = 2, 30, 20, 32
    skip = torch.randn((b, t, s), generator=g)
    head = {"w": torch.randn((s, 3 * M), generator=g) / s ** 0.5,
            "b": torch.randn(3 * M, generator=g) * 0.1}
    tgt = mol.to_grid(torch.rand((b, w), generator=g) * 2 - 1)
    tgt[0, :3] = -1.0
    mask = (torch.rand((b, w), generator=g) > 0.2).float()
    leaves = [skip.clone().requires_grad_(True),
              *(head[k].clone().requires_grad_(True) for k in ("w", "b"))]
    num = PM.mol_head_loss({"w": leaves[1], "b": leaves[2]}, leaves[0], tgt, mask, w,
                           "float32")
    got = torch.autograd.grad(num, leaves)
    want = []
    for dt in (torch.float32, torch.float64):
        ref = [v.detach().to(dt).requires_grad_(True) for v in leaves]
        y = torch.relu(ref[0][:, t - w:]) @ ref[1] + ref[2]
        want_num = (R.nll(y, tgt.to(dt), M) * mask.to(dt)).sum()
        want.append(torch.autograd.grad(want_num, ref))
        if dt == torch.float32:
            torch.testing.assert_close(num, want_num, rtol=1e-5, atol=1e-5)
    for a, f32, f64 in zip(got, *want):
        _as_accurate(a, f32, f64)
    assert float(got[0][:, : t - w].abs().max()) == 0.0
    tc = PM.post_mol_plain(head, skip, tgt, mask, w, torch.bfloat16, tensor_cores=True)
    one = PM.post_mol_plain(head, skip, tgt, mask, w, torch.bfloat16, tensor_cores=False)
    torch.testing.assert_close(tc, one, rtol=1e-4, atol=1e-4)
    d_tc = PM.post_mol_bwd_plain(head, skip, tgt, mask, w, torch.bfloat16, torch.tensor(1.0),
                                 tensor_cores=True)
    d_one = PM.post_mol_bwd_plain(head, skip, tgt, mask, w, torch.bfloat16, torch.tensor(1.0),
                                  tensor_cores=False)
    # bf16 operands: the two orders' fp32 sums round dy to other bf16 values
    # here and there.
    for a, c in zip((d_tc[0], *d_tc[1].values()), (d_one[0], *d_one[1].values())):
        assert _err(a, c) < 1e-2
    assert PM.route(256, 10, torch.bfloat16) == "tensor_cores"
    assert PM.route(256, 10, torch.float32) == "cuda_cores"
    with pytest.raises(ValueError, match="n_mix"):
        PM.route(256, 11, torch.bfloat16)
    assert PM.smem(256, True, True) < 232448 // 2 and PM.smem(256, False, True) <= 232448


def test_bf16_train_step_runs_and_config_loads():
    """The port's config file loads; a bf16 arch at tensor-core widths takes
    one train step on the CPU path with a finite loss near the reference's."""
    cfg = Config.load("lb_wavenet_tpu_torch/configs/tacotron2_mol.json")
    assert cfg.arch.mol and cfg.arch.hop_size == 300 and cfg.arch.sample_rate == 24000
    assert not cfg.train.fused_post and not cfg.train.fused_frontend and cfg.train.fused_stack
    arch = dataclasses.replace(ARCH, compute_dtype="bfloat16")
    corpus = _corpus(arch, TRAIN.window_size)
    batch = PT.batch_to_device(next(make_batches(corpus, TRAIN, with_mel=True)), "cpu")
    p0 = init_params(3, arch)
    state = PT.TrainState(p0, PT.make_optimizer(TRAIN).init(p0), 0)
    _, loss = PT.train_step(state, batch, arch, TRAIN)
    cond = R.upsample(p0["upsampler"], arch.upsample_factors, batch["mel"])
    want = R.masked_loss(p0, _rdict(arch), batch, TRAIN.window_size, "bfloat16", cond)
    assert math.isfinite(float(loss)) and abs(float(loss) - float(want)) < 1e-2 * abs(float(want))


def test_refusals():
    p = init_params(0, dataclasses.replace(ARCH, n_mels=0, upsample_factors=()))
    arch = dataclasses.replace(ARCH, n_mels=0, upsample_factors=())
    for engine in ("mega", "turbo", "pallas"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A item 10"):
            G.generate_classes(p, arch, 0, 2, 4, engine=engine, device="cpu")
    with pytest.raises(ValueError, match="fused_post"):
        PT.loss_sums_fn(p, arch, 8, {}, dataclasses.replace(TRAIN, fused_post=True))
    with pytest.raises(NotImplementedError, match="A item 11"):
        Corpus.from_pack("no.pack", arch, 16)
    with pytest.raises(NotImplementedError, match="A item 12"):
        PT._check_supported(arch, dataclasses.replace(TRAIN, seq_parallel=True))
    with pytest.raises(ValueError, match="output_dist"):
        ArchConfig(output_dist="gauss")


@pytest.mark.cuda
def test_head_pair_kernel_matches_plain():
    """On the card, at the config's widths: the head pair against its plain
    versions on both routes (bf16 on tensor cores, whose plain versions sum
    the products in the kernel's order; fp32 on CUDA cores)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, t, w, s = 4, 1100, 1000, 256
    skip = torch.randn((b, t, s), device=dev, generator=g)
    head = {"w": torch.randn((s, 30), device=dev, generator=g) / 16,
            "b": torch.randn(30, device=dev, generator=g) * 0.1}
    tgt = mol.to_grid(torch.rand((b, w), device=dev, generator=g) * 2 - 1)
    tgt[:, :5] = -1.0
    mask = (torch.rand((b, w), device=dev, generator=g) > 0.1).float()
    gbar = torch.tensor(0.7, device=dev)
    # Max |kernel - plain| over max |plain| within 1e-2, chip_smoke.py's
    # KERNEL_RTOL for the training pairs: the same rounded operands and
    # product order, but dy's transcendentals differ by ulps, which rounding
    # dy to bf16 can turn into a bf16 ulp of dskip.
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for dt in (torch.bfloat16, torch.float32):
        num = PM.post_mol_fwd(head, skip, tgt, mask, w, dt)
        want = PM.post_mol_plain(head, skip, tgt, mask, w, dt)
        dskip, grads = PM.post_mol_bwd(head, skip, tgt, mask, w, dt, gbar)
        w_dskip, w_grads = PM.post_mol_bwd_plain(head, skip, tgt, mask, w, dt, gbar)
        torch.cuda.synchronize()
        assert rel(num, want) < 1e-5
        assert float(dskip[:, : t - w].abs().max()) == 0.0
        for got, ref in ((dskip, w_dskip), (grads["w"], w_grads["w"]), (grads["b"], w_grads["b"])):
            assert rel(got, ref) < 1e-2
