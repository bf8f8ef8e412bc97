"""Port tests: conditioned training (mel and/or speaker) against the JAX
package on the CPU: the conditioned training-stack pair (its plain
versions, both summation orders) against JAX's Pallas kernels in interpret
mode, the training upsampler and its gradient, whole conditioned train
steps from a converted JAX state, gradient accumulation, mel batches of
the loader and of evaluation, run_training with a resume, and `cli train`
followed by `cli generate --mel`."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu import train as JT
from lb_wavenet_tpu.config import ArchConfig
from lb_wavenet_tpu.config import TrainConfig as JTrain
from lb_wavenet_tpu.data import make_batches as jbatches
from lb_wavenet_tpu.data import synthetic_corpus as jcorpus
from lb_wavenet_tpu.eval import eval_batches as jeval_batches
from lb_wavenet_tpu.models.conditioning import init_upsampler_params as jup_init
from lb_wavenet_tpu.models.conditioning import upsample_cond as jupsample
from lb_wavenet_tpu.models.wavenet import init_params as jinit
from lb_wavenet_tpu.ops.pallas.train_stack import make_fused_stack as jmake
from lb_wavenet_tpu.parallel.mesh import make_mesh, shard_batch, shard_params
from lb_wavenet_tpu_torch import train as PT
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.config import Config as PConfig
from lb_wavenet_tpu_torch.config import TrainConfig as PTrain
from lb_wavenet_tpu_torch.data import make_batches as pbatches
from lb_wavenet_tpu_torch.data import synthetic_corpus as pcorpus
from lb_wavenet_tpu_torch.data import write_wav
from lb_wavenet_tpu_torch.eval import eval_batches as peval_batches
from lb_wavenet_tpu_torch.models import conditioning as PC
from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS
from lb_wavenet_tpu_torch.utils.convert import params_from_jax, train_state_from_jax

torch.set_num_threads(1)
# BASELINE config 3 at CI size: mel (n_mels 8, Cc 8, hop 4) and 2 speakers
# of E = 4; the fp32 tolerance of test_torch_train.py's step comparison.
MEL = ArchConfig(n_blocks=1, n_layers_per_block=3, residual_channels=8, skip_channels=8,
                 gate_channels=8, n_mels=8, cond_channels=8, upsample_factors=(2, 2),
                 n_speakers=2, speaker_embed_dim=4, compute_dtype="float32")
# Widths the tensor-core route takes: C = G = Cc' = 16, S = 32, bf16.
TC = ArchConfig(n_blocks=1, n_layers_per_block=4, residual_channels=16, skip_channels=32,
                gate_channels=16, n_mels=8, cond_channels=16, upsample_factors=(2,),
                compute_dtype="bfloat16")
FUSED = dict(fused_stack=True, tapcat=True, fused_post=True, mm_embed_grad=True)
RTOL = 1e-4      # fp32: the same products summed in another order
B, T = 2, 40


def _parch(arch, **kw):
    return PArch(**dataclasses.asdict(dataclasses.replace(arch, **kw)))


def _close(got, want, rtol, what):
    """Within rtol of the leaf's largest magnitude."""
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale, err_msg=what)


def _tree_close(port, jax_tree, rtol, atol=0.0):
    """Leaf by leaf (dicts and lists) within rtol, plus atol or rtol of the
    leaf's largest magnitude."""
    flat = jax.tree_util.tree_leaves_with_path(jax_tree)
    assert len(flat) == len(PT.tree_leaves(port))
    for path, leaf in flat:
        node = port
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        want = np.asarray(leaf)
        got = node.detach().numpy() if isinstance(node, torch.Tensor) else node
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=max(atol, rtol * float(np.abs(want).max())),
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# The conditioned stack pair.

def _stack_case(arch, cc, seed):
    """Layer weights with a w_cond of cc channels, h0, cond and a skip
    cotangent from one numpy seed."""
    lp = {k: np.asarray(v) for k, v in jinit(jax.random.key(seed), arch)["layers"].items()
          if k in TS.LAYER_KEYS}
    rng = np.random.default_rng(seed)
    two_g = 2 * arch.gate_channels
    lp["w_cond"] = (rng.standard_normal((len(arch.dilations), cc, two_g))
                    / np.sqrt(cc)).astype(np.float32)
    h0 = rng.standard_normal((B, T, arch.residual_channels)).astype(np.float32)
    cond = rng.standard_normal((B, T, cc)).astype(np.float32)
    g = rng.standard_normal((B, T, arch.skip_channels)).astype(np.float32)
    return lp, h0, cond, g


def _jax_stack(arch, lp, h0, cond, g, tapcat):
    fused = jmake(arch, has_cond=True, interpret=True, tapcat=tapcat)
    skip = fused(lp, jnp.asarray(h0), jnp.asarray(cond))
    dlp, dh0, dcond = jax.grad(lambda lp, h, c: jnp.sum(fused(lp, h, c) * g),
                               argnums=(0, 1, 2))(lp, jnp.asarray(h0), jnp.asarray(cond))
    grads = {k: np.asarray(v) for k, v in dlp.items()}
    return np.asarray(skip), np.asarray(dh0), np.asarray(dcond), grads


def _check_stack(got, want, rtol):
    skip, dh0, dcond, grads = got
    _close(skip, want[0], rtol, "skip")
    _close(dh0, want[1], rtol, "dh0")
    _close(dcond, want[2], rtol, "dcond")
    assert set(grads) == set(want[3])
    for k in want[3]:
        _close(grads[k], want[3][k], rtol, f"layers.{k}")


@pytest.mark.parametrize("tapcat", [False, True])
def test_conditioned_stack_matches_jax_pallas_kernels(tapcat):
    """make_fused_stack(has_cond=True) through autograd (the plain versions
    on the CPU) against JAX's make_fused_stack(has_cond=True) in interpret
    mode, fp32: skip, dh0, d cond, d w_cond and every layer gradient."""
    arch = dataclasses.replace(MEL, n_speakers=0)
    lp, h0, cond, g = _stack_case(arch, 8, 3)
    want = _jax_stack(arch, lp, h0, cond, g, tapcat)
    tl = {k: torch.tensor(v, requires_grad=True) for k, v in lp.items()}
    th = torch.tensor(h0, requires_grad=True)
    tc = torch.tensor(cond, requires_grad=True)
    skip = TS.make_fused_stack(_parch(arch), has_cond=True, tapcat=tapcat)(tl, th, tc)
    (skip * torch.from_numpy(g)).sum().backward()
    _check_stack((skip.detach().numpy(), th.grad.numpy(), tc.grad.numpy(),
                  {k: v.grad.numpy() for k, v in tl.items()}), want, RTOL)


@pytest.mark.parametrize("tapcat", [False, True])
@pytest.mark.parametrize("tensor_cores", [False, True])
def test_conditioned_stack_tensor_core_widths_match_jax(tapcat, tensor_cores):
    """bf16 at widths the tensor-core route takes (C = G = Cc' = 16): the
    plain versions summed as that route sums on the card (cond's k-steps
    continuing the gate's chain; the weight and bias gradients per tile and
    block slot) or as the CPU sums (one fp32 product), against JAX's
    Pallas kernels within 2e-2: bf16-rounded operands, fp32 sums in another
    order."""
    lp, h0, cond, g = _stack_case(TC, 16, 8)
    want = _jax_stack(TC, lp, h0, cond, g, tapcat)
    tl = {k: torch.tensor(v) for k, v in lp.items()}
    dils, dt = tuple(TC.dilations), torch.bfloat16
    assert TS.route(16, 16, 32, dt, 16) == "tensor_cores"
    assert not TS.default_order("cpu", 16, 16, 32, dt, 16)
    cnd = torch.tensor(cond)
    skip, z, x = TS.stack_fwd_plain(tl, torch.tensor(h0), dils, dt, tapcat, tensor_cores, cnd)
    dh0, grads = TS.stack_bwd_plain(tl, dils, dt, tapcat, z, x, torch.tensor(g),
                                    tensor_cores, cnd)
    dcond = grads.pop("cond")
    _check_stack((skip.numpy(), dh0.numpy(), dcond.numpy(),
                  {k: v.numpy() for k, v in grads.items()}), want, 2e-2)


def test_conditioned_plain_backward_matches_autograd_of_plain_forward():
    """The hand-written conditioned backward (fp32) against torch autograd
    through the plain forward, which shares no backward code with it."""
    arch = _parch(MEL, n_speakers=0)
    lp, h0, cond, g = _stack_case(dataclasses.replace(MEL, n_speakers=0), 8, 6)
    for tapcat in (False, True):
        tl = {k: torch.tensor(v, requires_grad=True) for k, v in lp.items()}
        th, tcn = torch.tensor(h0, requires_grad=True), torch.tensor(cond, requires_grad=True)
        skip, z, x = TS.stack_fwd_plain(tl, th, arch.dilations, torch.float32, tapcat,
                                        cond=tcn)
        (skip * torch.from_numpy(g)).sum().backward()
        dh0, grads = TS.stack_bwd_plain({k: v.detach() for k, v in tl.items()},
                                        arch.dilations, torch.float32, tapcat, z.detach(),
                                        x.detach(), torch.from_numpy(g), cond=tcn.detach())
        _close(dh0.numpy(), th.grad.numpy(), RTOL, "dh0")
        _close(grads["cond"].numpy(), tcn.grad.numpy(), RTOL, "cond")
        for k in tl:
            _close(grads[k].numpy(), tl[k].grad.numpy(), RTOL, k)


def test_tensor_core_gradient_order_pieces():
    """The tensor-core order of the weight and bias gradients: every block
    slot's tiles and the slots in order (one slot: the tiles in order; as
    many slots as tiles: each tile alone), the strip butterfly of db and
    the chunked db_skip, each equal to the plain sums within fp32
    rounding, and a tile's product equal to ar_tc's mma model."""
    from lb_wavenet_tpu_torch.ops.cuda import ar_tc

    rng = np.random.default_rng(2)
    a = torch.tensor(rng.standard_normal((2, 150, 32)), dtype=torch.bfloat16).float()
    b = torch.tensor(rng.standard_normal((2, 150, 16)), dtype=torch.bfloat16).float()
    want = torch.einsum("btm,btn->mn", a, b)
    for chunks in (1, 3, 6):
        got = TS._tc_outer(a, b, chunks)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    one = TS._tc_outer(a[:1, :64], b[:1, :64], 1)
    assert torch.equal(one, ar_tc.tc_product(a[0, :64].t(), b[0, :64]))
    d = torch.tensor(rng.standard_normal((2, 150, 16)), dtype=torch.float32)
    ref, tol = d.sum((0, 1)), 1e-6 * float(d.abs().sum((0, 1)).max())
    for got in (TS._tc_db(d, 4), TS._tc_dbr(d, 4), TS._tc_dbs(d)):
        assert float((got - ref).abs().max()) <= tol
    assert TS.tc_slots(2, 150, "cpu") == 6 and TS.tc_slots(8, 9213, "cpu") == 132


@pytest.mark.parametrize("c,g,s,cc,want", [
    (64, 64, 256, 64, 184064 + 17408 + 8192), (64, 64, 256, 80, 184064 + 21760 + 10240),
    (64, 64, 256, 0, 184064), (64, 64, 512, 80, None), (16, 16, 32, 16, None)])
def test_conditioned_route_and_shared_memory(c, g, s, cc, want):
    """tc_smem(C, G, S, Cc'): w_cond's rows beside the tap weights and the
    cond columns beside the tap tile, in the forward and backward layer
    passes (the backward carves the most); the mel config fits at Cc' = 64
    and with speakers at 80. Cc' must be a multiple of 16 there."""
    got = TS.tc_smem(c, g, s, cc)
    if want is not None:
        assert got == want
    assert got <= TS.TC_SMEM_MAX and TS.route(c, g, s, torch.bfloat16, cc) == "tensor_cores"
    assert TS.route(c, g, s, torch.bfloat16, cc + 8) == "cuda_cores"
    assert TS.route(c, g, s, torch.float32, cc) == "cuda_cores"


def test_plain_order_on_a_card_tensor_follows_the_route():
    """The plain versions sum in the tensor-core order exactly when a CUDA
    tensor's widths (with the cond channels) take that route, conditioned
    or not; never on the CPU."""
    lp = {"w_cur": torch.zeros(2, 16, 32), "w_skip": torch.zeros(2, 16, 32)}
    card = torch.device("cuda")
    for cond, dt, want in ((None, torch.bfloat16, True), (torch.zeros(1, 4, 16), torch.bfloat16,
                                                           True),
                           (torch.zeros(1, 4, 8), torch.bfloat16, False),
                           (None, torch.float32, False)):
        assert TS._order(lp, card, dt, cond) is want
        assert TS._order(lp, "cpu", dt, cond) is False


# ---------------------------------------------------------------------------
# The training upsampler.

@pytest.mark.parametrize("factors", [(2, 2), (4, 8, 8), (3,)])
def test_training_upsampler_matches_jax_and_its_gradient(factors):
    """upsample_cond_train (one fp32 product per contraction) against JAX's
    upsample_cond, values and the gradient of every upsampler leaf and of
    the frames (fp32, 1e-5 of each leaf's largest value), and against the
    port's fixed-order upsample_cond."""
    arch = ArchConfig(n_mels=8, cond_channels=8, upsample_factors=factors)
    jp = jup_init(jax.random.key(1), arch)
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((2, 5, 8)).astype(np.float32)
    g = rng.standard_normal((2, 5 * arch.hop_size, 8)).astype(np.float32)

    def loss(p, fr):
        return jnp.sum(jupsample(p, arch, fr, jnp.float32) * g)

    want = np.asarray(jupsample(jp, arch, jnp.asarray(frames), jnp.float32))
    dp, dfr = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(frames))
    pa = _parch(arch)
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    for leaf in PT.tree_leaves(pp):
        leaf.requires_grad_(True)
    fr = torch.tensor(frames, requires_grad=True)
    got = PC.upsample_cond_train(pp, pa, fr, torch.float32)
    (got * torch.from_numpy(g)).sum().backward()
    _close(got.detach().numpy(), want, 1e-5, "cond")
    _close(fr.grad.numpy(), np.asarray(dfr), 1e-5, "frames")
    flat = jax.tree_util.tree_leaves(dp)
    for a, b in zip(PT.tree_leaves(pp), flat):
        _close(a.grad.numpy(), np.asarray(b), 1e-5, "upsampler leaf")
    fixed = PC.upsample_cond(pp, pa, fr.detach(), torch.float32)
    _close(got.detach().numpy(), fixed.detach().numpy(), 1e-5, "fixed order")


def test_training_upsampler_runs_in_fp32_under_tf32_flags():
    """The products run in full fp32 and restore the caller's TF32 switch."""
    arch = _parch(ArchConfig(n_mels=8, cond_channels=8, upsample_factors=(2,)))
    pp = PC.init_upsampler_params(0, arch)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = PC.upsample_cond_train(pp, arch, torch.randn(1, 3, 8), torch.bfloat16)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert out.dtype == torch.bfloat16 and out.shape == (1, 6, 8)


# ---------------------------------------------------------------------------
# Conditioned train steps.

MODES = ["mel", "speaker", "both"]


def _mode_arch(mode):
    if mode == "mel":
        return dataclasses.replace(MEL, n_speakers=0)
    if mode == "speaker":
        return dataclasses.replace(MEL, n_mels=0, upsample_factors=())
    return MEL


def _cond_batch(arch, b, w, seed):
    rng = np.random.default_rng(seed)
    r = arch.receptive_field
    mask = np.ones((b, w), np.float32)
    mask[0, w // 2:] = 0.0
    out = {"inputs": rng.integers(0, 256, (b, r - 1 + w)).astype(np.int32),
           "targets": rng.integers(0, 256, (b, w)).astype(np.int32), "mask": mask}
    if arch.use_local_cond:
        n_frames = -(-(r - 1 + w) // arch.hop_size)
        out["mel"] = rng.standard_normal((b, n_frames, arch.n_mels)).astype(np.float32)
    if arch.use_global_cond:
        out["speaker"] = rng.integers(0, arch.n_speakers, (b,)).astype(np.int32)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kernels", [FUSED, {}], ids=["fused", "unfused"])
def test_conditioned_train_steps_match_jax(mode, kernels):
    """Three steps from a converted JAX state of a mel, speaker or mel +
    speaker arch, with the fused kernels (the conditioned stack) or the
    plain forward: losses, and every parameter leaf after the steps (the
    upsampler's list of stages, w_cond, w_gcond and speaker_embed among
    them) within the fp32 tolerance of test_torch_train.py's step test."""
    arch = _mode_arch(mode)
    w = 16
    jt, pt = JTrain(batch_size=2, window_size=w, learning_rate=1e-3, **kernels), \
        PTrain(batch_size=2, window_size=w, learning_rate=1e-3, **kernels)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    js = shard_params(JT.init_state(jax.random.key(0), arch, jt), mesh)
    ps = train_state_from_jax(js)
    parch = _parch(arch)
    for i in range(3):
        raw = _cond_batch(arch, 2, w, 10 + i)
        js, loss_j = JT.train_step(js, shard_batch(raw, mesh), arch, jt)
        ps, loss_p = PT.train_step(ps, {k: torch.from_numpy(v) for k, v in raw.items()},
                                   parch, pt)
        assert float(loss_p) == pytest.approx(float(loss_j), rel=1e-5)
    _tree_close(ps.params, js.params, 1e-3, 1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_conditioned_gradients_match_jax(mode):
    """One fused conditioned value_and_grads against JAX's value_and_grad of
    the same loss: the loss and every gradient leaf (the upsampler's
    stages, w_cond, w_gcond, speaker_embed) within 1e-4 of the leaf."""
    arch = _mode_arch(mode)
    w = 16
    jt = JTrain(batch_size=2, window_size=w, **FUSED)
    pt = PTrain(batch_size=2, window_size=w, **FUSED)
    jp = jinit(jax.random.key(3), arch)
    raw = _cond_batch(arch, 2, w, 5)
    batch = {k: jnp.asarray(v) for k, v in raw.items()}

    def lf(p):
        num, den = JT.loss_sums_fn(p, arch, w, batch, jt)
        return num / jnp.maximum(den, 1.0)

    loss_j, g_j = jax.value_and_grad(lf)(jp)
    loss_p, g_p = PT.value_and_grads(params_from_jax(jax.tree.map(np.asarray, jp)),
                                     {k: torch.from_numpy(v) for k, v in raw.items()},
                                     _parch(arch), pt)
    assert float(loss_p) == pytest.approx(float(loss_j), rel=1e-5)
    _tree_close(g_p, g_j, RTOL)


def test_conditioned_grad_accum_equals_one_shot_step():
    """grad_accum 2 on a mel + speaker batch (mel and speaker rows sliced
    i::k): the same loss and params as the one-shot step, to rounding."""
    parch = _parch(MEL)
    raw = {k: torch.from_numpy(v) for k, v in _cond_batch(MEL, 4, 16, 3).items()}
    state = PT.init_state(0, parch, PTrain())
    out = [PT.train_step(state, raw, parch, PTrain(batch_size=4, window_size=16,
                                                   learning_rate=1e-3, grad_accum=k, **FUSED))
           for k in (1, 2)]
    assert float(out[1][1]) == pytest.approx(float(out[0][1]), rel=1e-6)
    for a, c in zip(PT.tree_leaves(out[1][0].params), PT.tree_leaves(out[0][0].params)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# Mel batches, run_training, the CLI.

MEL16 = dataclasses.replace(MEL, n_speakers=0, upsample_factors=(4, 4))


def test_mel_batches_match_jax():
    """make_batches(with_mel=True) and a mel arch's eval_batches against the
    JAX package's: inputs, targets and masks bit for bit, mel frames within
    1e-4 (log-mel through another FFT)."""
    train = JTrain(batch_size=3, window_size=40, seed=2)
    pt = PTrain(batch_size=3, window_size=40, seed=2)
    jc = jcorpus(MEL16, 40, n_files=2, file_len=700, seed=1)
    pc = pcorpus(_parch(MEL16), 40, n_files=2, file_len=700, seed=1)
    pairs = [(jb, pb) for (jb, pb), _ in zip(zip(jbatches(jc, train, with_mel=True),
                                                 pbatches(pc, pt, with_mel=True)), range(3))]
    pairs += list(zip(jeval_batches(jc, 4), peval_batches(pc, 4)))
    for jb, pb in pairs:
        for k in ("inputs", "targets", "mask"):
            np.testing.assert_array_equal(getattr(pb, k), getattr(jb, k))
        assert pb.mel.shape == jb.mel.shape == (jb.inputs.shape[0], -(-jb.inputs.shape[1] // 16), 8)
        np.testing.assert_allclose(pb.mel, jb.mel, rtol=0, atol=1e-4)


def _mel_cfg(ckpt, n_steps, **kw):
    return PConfig(arch=_parch(MEL16), train=PTrain(
        batch_size=4, window_size=48, learning_rate=1e-2, n_steps=n_steps, log_every=10,
        checkpoint_every=kw.pop("checkpoint_every", 100), checkpoint_dir=str(ckpt), seed=0,
        **FUSED, **kw))


def test_run_training_mel_loss_falls_and_resumes(tmp_path, capsys):
    """A tiny mel config trains through the conditioned fused stack: the
    loss falls; interrupted at 6 with Adam moments and an EMA over the
    upsampler's list of stages, resumed to 12, it equals 12 uninterrupted."""
    corpus = pcorpus(_parch(MEL16), 48, n_files=2, file_len=1500)
    state = PT.run_training(_mel_cfg(tmp_path / "a", 30), corpus=corpus, device="cpu")
    losses = [json.loads(ln)["loss"] for ln in capsys.readouterr().out.splitlines()]
    assert state.step == 30 and len(losses) == 3
    assert losses[-1] < losses[0] - 0.1
    full = PT.run_training(_mel_cfg(tmp_path / "b", 12, ema_decay=0.9), corpus=corpus,
                           device="cpu")
    PT.run_training(_mel_cfg(tmp_path / "c", 6, ema_decay=0.9, checkpoint_every=3),
                    corpus=corpus, device="cpu")
    resumed = PT.run_training(_mel_cfg(tmp_path / "c", 12, ema_decay=0.9, checkpoint_every=3),
                              corpus=corpus, device="cpu")
    assert resumed.opt_state["count"] == 12
    assert isinstance(resumed.params["upsampler"]["stages"], list)
    for tree in ("params", "ema"):
        for a, b in zip(PT.tree_leaves(getattr(resumed, tree)),
                        PT.tree_leaves(getattr(full, tree))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    for a, b in zip(PT.tree_leaves(resumed.opt_state["nu"]), PT.tree_leaves(full.opt_state["nu"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-12)


def test_mel_train_section_trains_as_written(tmp_path, capsys):
    """configs/wavenet30_mel.json's train section as written (fused
    frontend, stack with tapcat, post-loss, mm_embed_grad, mesh_data -1) on
    a tiny mel arch with speakers, cut to a small batch, window and step
    count: the conditioned stack runs (its plain versions here)."""
    full = PConfig.load(os.path.join(os.path.dirname(__file__), "..", "configs",
                                     "wavenet30_mel.json"))
    tr = full.train
    assert (tr.fused_frontend and tr.fused_stack and tr.tapcat and tr.fused_post
            and tr.mm_embed_grad and tr.mesh_data == -1)
    train = dataclasses.replace(tr, batch_size=2, window_size=32, n_steps=2, log_every=1,
                                checkpoint_dir=str(tmp_path / "ckpt"))
    arch = _parch(MEL16, n_speakers=2)
    corpus = pcorpus(arch, 32, n_files=2, file_len=800)
    corpus.speakers = [0, 1]
    calls = []
    real = TS.make_fused_stack

    def spy(a, has_cond=False, **kw):
        calls.append(has_cond)
        return real(a, has_cond=has_cond, **kw)

    TS.make_fused_stack = spy
    try:
        state = PT.run_training(PConfig(arch=arch, train=train), corpus=corpus, device="cpu")
    finally:
        TS.make_fused_stack = real
    losses = [json.loads(ln)["loss"] for ln in capsys.readouterr().out.splitlines()]
    assert state.step == 2 and len(losses) == 2 and all(np.isfinite(losses))
    assert calls and all(calls)


def test_cli_train_then_generate_mel_from_its_checkpoint(tmp_path, capsys):
    """`cli train` of a tiny mel config from a directory of wavs, then `cli
    generate --mel` and `cli eval` from its checkpoint."""
    from lb_wavenet_tpu_torch import cli

    data = tmp_path / "wavs"
    data.mkdir()
    for i in range(2):
        t = np.arange(2000) / 16000
        write_wav(str(data / f"{i}.wav"), 0.5 * np.sin(2 * np.pi * (150 + 90 * i) * t), 16000)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"arch": dataclasses.asdict(_parch(MEL16))}))
    ckpt = tmp_path / "ckpt"
    common = ["--config", str(cfg), "--device", "cpu"]
    rc = cli.main(["train", *common, "--set", f"train.data_dir={data}",
                   "--set", f"train.checkpoint_dir={ckpt}", "--set", "train.n_steps=2",
                   "--set", "train.batch_size=2", "--set", "train.window_size=32",
                   "--set", "train.log_every=1", "--set", "train.fused_stack=true",
                   "--set", "train.tapcat=true", "--set", "train.fused_post=true"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"trained_to_step": 2}
    mel = np.random.default_rng(0).standard_normal((2, 2, 8)).astype(np.float32)
    np.save(tmp_path / "mel.npy", mel)
    rc = cli.main(["generate", *common, "--set", f"gen.checkpoint_dir={ckpt}",
                   "--set", f"gen.out_dir={tmp_path / 'out'}", "--set", "gen.batch_size=2",
                   "--set", "gen.n_samples=24", "--mel", str(tmp_path / "mel.npy")])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["generated"] == 2
    assert sorted(os.listdir(tmp_path / "out")) == ["gen_0000.wav", "gen_0001.wav"]
    rc = cli.main(["eval", *common, "--data-dir", str(data), "--set",
                   f"gen.checkpoint_dir={ckpt}", "--set", "train.window_size=32",
                   "--set", "train.batch_size=2"])
    assert rc == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(metrics["nll"]) and metrics["n_samples"] > 0
