"""Port tests: the training engine against the JAX package — schedules,
Adam (clip, warmup, EMA) against optax, fused train steps from a converted
JAX state, exact gradient accumulation, run_training with resume, and the
`train` CLI followed by `generate` from its checkpoint."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu import train as JT
from lb_wavenet_tpu.config import TrainConfig as JTrain
from lb_wavenet_tpu.parallel.mesh import make_mesh, shard_batch, shard_params
from lb_wavenet_tpu_torch import train as PT
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.config import Config as PConfig
from lb_wavenet_tpu_torch.config import TrainConfig as PTrain
from lb_wavenet_tpu_torch.data import synthetic_corpus, write_wav
from lb_wavenet_tpu_torch.utils.convert import params_from_jax, train_state_from_jax

from .util import MICRO

torch.set_num_threads(1)
PMICRO = PArch(**dataclasses.asdict(MICRO))
FUSED = dict(fused_stack=True, tapcat=True, fused_post=True)


def _both(**kw):
    return JTrain(**kw), PTrain(**kw)


def _batch(b, w, seed, ragged=False):
    rng = np.random.default_rng(seed)
    r = MICRO.receptive_field
    mask = np.ones((b, w), np.float32)
    if ragged:
        mask[0, w // 2:] = 0.0
        mask[2 % b, :5] = 0.0
    return {"inputs": rng.integers(0, 256, (b, r - 1 + w)).astype(np.int32),
            "targets": rng.integers(0, 256, (b, w)).astype(np.int32), "mask": mask}


def _torch_batch(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def _assert_tree_close(port, jax_tree, rtol, atol=0.0):
    """Leaf by leaf within rtol, plus atol or rtol of the leaf's largest
    magnitude (XLA fuses the update's multiply-adds; torch does not)."""
    flat = jax.tree_util.tree_leaves_with_path(jax_tree)
    assert len(flat) == len(PT.tree_leaves(port))
    for path, leaf in flat:
        node = port
        for k in path:
            node = node[k.key]
        want = np.asarray(leaf)
        np.testing.assert_allclose(node.numpy(), want, rtol=rtol,
                                   atol=max(atol, rtol * float(np.abs(want).max())),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear", "exponential"])
@pytest.mark.parametrize("warmup", [0, 5])
def test_lr_schedule_matches_jax_and_optax(kind, warmup):
    jt, pt = _both(learning_rate=3e-3, lr_schedule=kind, warmup_steps=warmup,
                   n_steps=40, lr_min_ratio=0.1)
    sched_j = JT.make_lr_schedule(jt)
    sched_p = PT.make_lr_schedule(pt)
    for step in range(0, 45):
        assert PT.lr_at(pt, step) == JT.lr_at(jt, step)
        assert sched_p(step) == pytest.approx(float(sched_j(step)), rel=1e-6, abs=1e-12)
    with pytest.raises(ValueError, match="lr_schedule"):
        PT.make_lr_schedule(dataclasses.replace(pt, lr_schedule="bogus"))


@pytest.mark.parametrize("clip,warmup,ema", [(0.0, 0, 0.0), (0.5, 0, 0.9), (100.0, 3, 0.99)])
def test_adam_updates_match_optax(clip, warmup, ema):
    """Two updates from a converted state: clipping (triggered at 0.5, not
    at 100), warmup (the first update has lr 0: the schedule is read at
    the count before it increments) and the EMA."""
    jt, pt = _both(learning_rate=1e-2, grad_clip_norm=clip, warmup_steps=warmup,
                   ema_decay=ema, n_steps=10)
    js = JT.init_state(jax.random.key(1), MICRO, jt)
    ps = train_state_from_jax(js)
    rng = np.random.default_rng(2)
    apply = jax.jit(JT._apply_updates, static_argnums=2)
    for _ in range(2):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), js.params)
        js = apply(js, jax.tree.map(jnp.asarray, g), jt)
        ps = PT._apply_updates(ps, params_from_jax(g), pt)
    assert ps.step == int(js.step) == 2
    conv = train_state_from_jax(js)
    assert ps.opt_state["count"] == conv.opt_state["count"] == 2
    _assert_tree_close(ps.params, js.params, 1e-6)
    _assert_tree_close(ps.opt_state["mu"], conv.opt_state["mu"], 1e-6)
    _assert_tree_close(ps.opt_state["nu"], conv.opt_state["nu"], 1e-6)
    if ema:
        _assert_tree_close(ps.ema, js.ema, 1e-6)
    else:
        assert ps.ema is None


@pytest.mark.parametrize("kernels", [dict(FUSED, mm_embed_grad=True), {},
                                     dict(FUSED, mm_embed_grad=True, fused_frontend=True)],
                         ids=["fused", "unfused", "recipe"])
def test_train_steps_match_jax(kernels):
    """Three steps from a converted JAX state, with the fused stack (tapcat),
    the fused post-loss and mm_embed_grad, with the fused frontend as well
    (configs/wavenet30.json's recipe), or with none of them (the plain
    forward + masked CE): losses and params track the JAX steps."""
    w = 24
    jt, pt = _both(batch_size=2, window_size=w, learning_rate=1e-3, **kernels)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    js = shard_params(JT.init_state(jax.random.key(0), MICRO, jt), mesh)
    ps = train_state_from_jax(js)
    for i in range(3):
        raw = _batch(2, w, 10 + i)
        js, loss_j = JT.train_step(js, shard_batch(raw, mesh), MICRO, jt)
        ps, loss_p = PT.train_step(ps, _torch_batch(raw), PMICRO, pt)
        assert float(loss_p) == pytest.approx(float(loss_j), rel=1e-5)
    assert ps.step == 3
    _assert_tree_close(ps.params, js.params, 1e-3, 1e-5)


def test_grad_accum_equals_one_shot_step():
    """grad_accum 2 and 4 over the same batch, ragged masks: the loss
    equal and the params equal to float rounding (the masked mean is
    exact because the denominator carries no gradient)."""
    w, b = 24, 4
    raw = _torch_batch(_batch(b, w, 3, ragged=True))
    state = PT.init_state(0, PMICRO, PTrain())
    out = []
    for k in (1, 2, 4):
        pt = PTrain(batch_size=b, window_size=w, learning_rate=1e-3, grad_accum=k, **FUSED)
        out.append(PT.train_step(state, raw, PMICRO, pt))
    for s, loss in out[1:]:
        assert float(loss) == pytest.approx(float(out[0][1]), rel=1e-6)
        for a, c in zip(PT.tree_leaves(s.params), PT.tree_leaves(out[0][0].params)):
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-5, atol=1e-7)
    assert PT.tree_leaves(state.params)[0] is not PT.tree_leaves(out[0][0].params)[0]
    with pytest.raises(ValueError, match="divisible"):
        PT.train_step(state, raw, PMICRO, PTrain(batch_size=b, window_size=w, grad_accum=3))


def test_remat_gives_the_same_step():
    """remat recomputes each layer in the backward: the same loss and
    gradients as keeping the activations (unfused path)."""
    raw = _torch_batch(_batch(2, 24, 6))
    params = PT.init_state(2, PMICRO, PTrain()).params
    outs = [PT.value_and_grads(params, raw, PMICRO,
                               PTrain(batch_size=2, window_size=24, remat=r))
            for r in (False, True)]
    assert float(outs[0][0]) == float(outs[1][0])
    for a, b in zip(PT.tree_leaves(outs[0][1]), PT.tree_leaves(outs[1][1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_mm_embed_grad_matches_jax_embed_lookup_mm():
    """The frontend's gradient: with mm_embed_grad JAX contracts a blocked
    one-hot (embed_lookup_mm); the port always takes the gather's index
    add, which gives the same gradient."""
    from lb_wavenet_tpu.models.wavenet import init_params, input_frontend as jfront
    from lb_wavenet_tpu_torch.models.wavenet import input_frontend as pfront

    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (2, 300)).astype(np.int32)
    g = rng.standard_normal((2, 300, 8)).astype(np.float32)
    jp = init_params(jax.random.key(2), MICRO)
    front = {k: jp[k] for k in ("embed", "input_conv")}

    def loss(p):
        return jnp.sum(jfront(p, MICRO, x, jnp.float32, mm_embed_grad=True) * g)

    want = jax.jit(jax.grad(loss))(front)
    pp = params_from_jax(jax.tree.map(np.asarray, front))
    for leaf in PT.tree_leaves(pp):
        leaf.requires_grad_(True)
    h = pfront(pp, PMICRO, torch.from_numpy(x), torch.float32)
    (h * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(pp["embed"].grad.numpy(), np.asarray(want["embed"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pp["input_conv"]["w"].grad.numpy(),
                               np.asarray(want["input_conv"]["w"]), rtol=1e-5, atol=1e-4)


def _run_cfg(ckpt, n_steps, **kw):
    return PConfig(arch=PMICRO, train=PTrain(
        batch_size=4, window_size=64, learning_rate=3e-3, n_steps=n_steps,
        log_every=10, checkpoint_every=kw.pop("checkpoint_every", 100),
        checkpoint_dir=str(ckpt), seed=0, **FUSED, **kw))


def test_run_training_loss_falls_and_resumes(tmp_path, capsys, monkeypatch):
    corpus = synthetic_corpus(PMICRO, 64, n_files=2, file_len=2000)
    state = PT.run_training(_run_cfg(tmp_path / "a", 40), corpus=corpus, device="cpu")
    losses = [json.loads(ln)["loss"] for ln in capsys.readouterr().out.splitlines()]
    assert state.step == 40 and len(losses) == 4
    assert losses[-1] < losses[0] - 0.1 and losses[-1] < 5.45

    calls = []
    monkeypatch.setattr(PT, "train_step", lambda *a: calls.append(1))
    again = PT.run_training(_run_cfg(tmp_path / "a", 40), corpus=corpus, device="cpu")
    assert not calls and again.step == 40
    for a, b in zip(PT.tree_leaves(again.params), PT.tree_leaves(state.params)):
        assert torch.equal(a, b)
    monkeypatch.undo()

    # Interrupted at 8 and resumed to 16 == 16 uninterrupted; 3 kept.
    full = PT.run_training(_run_cfg(tmp_path / "b", 16), corpus=corpus, device="cpu")
    PT.run_training(_run_cfg(tmp_path / "c", 8, checkpoint_every=2), corpus=corpus,
                    device="cpu")
    resumed = PT.run_training(_run_cfg(tmp_path / "c", 16, checkpoint_every=2),
                              corpus=corpus, device="cpu")
    assert sorted(os.listdir(tmp_path / "c")) == [f"params_{s}.pt" for s in (12, 14, 16)]
    for a, b in zip(PT.tree_leaves(resumed.params), PT.tree_leaves(full.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    assert resumed.opt_state["count"] == 16


def test_cli_train_then_generate_from_its_checkpoint(tmp_path, capsys):
    from lb_wavenet_tpu_torch import cli

    data = tmp_path / "wavs"
    data.mkdir()
    for i in range(2):
        t = np.arange(3000) / 16000
        write_wav(str(data / f"{i}.wav"), 0.5 * np.sin(2 * np.pi * (150 + 90 * i) * t), 16000)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"arch": dataclasses.asdict(PMICRO)}))
    ckpt = tmp_path / "ckpt"
    common = ["--config", str(cfg), "--device", "cpu"]
    rc = cli.main(["train", *common, "--set", f"train.data_dir={data}",
                   "--set", f"train.checkpoint_dir={ckpt}", "--set", "train.n_steps=3",
                   "--set", "train.batch_size=2", "--set", "train.window_size=32",
                   "--set", "train.log_every=1", "--set", "train.fused_stack=true",
                   "--set", "train.tapcat=true", "--set", "train.fused_post=true",
                   "--set", "train.fused_frontend=false"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"trained_to_step": 3}
    assert [json.loads(ln)["step"] for ln in lines[:-1]] == [1, 2, 3]
    rc = cli.main(["generate", *common, "--set", f"gen.checkpoint_dir={ckpt}",
                   "--set", f"gen.out_dir={tmp_path / 'out'}", "--set", "gen.batch_size=2",
                   "--set", "gen.n_samples=12"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["generated"] == 2
    assert sorted(os.listdir(tmp_path / "out")) == ["gen_0000.wav", "gen_0001.wav"]


@pytest.mark.parametrize("override,item", [
    (dict(eval_dir="PACK_FILE", eval_every=5), "A queue item 8"),
    (dict(tensorboard_dir="/nonexistent"), "A queue item 8"),
])
def test_unported_training_settings_raise(tmp_path, override, item):
    """The settings still to port raise naming their ROADMAP item (the
    mesh and sequence-parallel settings are ported: test_torch_parallel_train.py)."""
    if override.get("eval_dir") == "PACK_FILE":   # a packed eval corpus
        pack = tmp_path / "eval.pack"
        pack.write_bytes(b"")
        override = dict(override, eval_dir=str(pack))
    cfg = _run_cfg(tmp_path, 2)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **override))
    corpus = synthetic_corpus(PMICRO, 64, n_files=1, file_len=500)
    with pytest.raises(NotImplementedError, match=item):
        PT.run_training(cfg, corpus=corpus, device="cpu")


def test_conditioning_and_missing_card_raise(tmp_path, monkeypatch):
    """A speaker-conditioned arch trains on the CPU now (conditioned
    training is ported; its parity is tests/test_torch_train_cond.py's);
    the default device without a card still raises."""
    cfg = _run_cfg(tmp_path, 2)
    corpus = synthetic_corpus(PMICRO, 64, n_files=1, file_len=500)
    corpus.speakers = [1]
    cond = dataclasses.replace(cfg, arch=dataclasses.replace(PMICRO, n_speakers=2))
    state = PT.run_training(cond, corpus=corpus, device="cpu")
    assert state.step == 2 and state.params["speaker_embed"].shape == (2, 16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PT.run_training(cfg, corpus=corpus)


def test_wavenet30_train_section_trains_as_written(tmp_path, capsys):
    """configs/wavenet30.json's train section as written (fused frontend,
    stack with tapcat, post-loss, mm_embed_grad, mesh_data -1) on a MICRO
    arch, cut to a small batch, window and step count."""
    full = PConfig.load(os.path.join(os.path.dirname(__file__), "..", "configs",
                                     "wavenet30.json"))
    tr = full.train
    assert tr.fused_frontend and tr.fused_stack and tr.tapcat and tr.fused_post
    train = dataclasses.replace(tr, batch_size=2, window_size=32, n_steps=2, log_every=1,
                                checkpoint_dir=str(tmp_path / "ckpt"))
    corpus = synthetic_corpus(PMICRO, 32, n_files=2, file_len=800)
    state = PT.run_training(PConfig(arch=PMICRO, train=train), corpus=corpus, device="cpu")
    losses = [json.loads(ln)["loss"] for ln in capsys.readouterr().out.splitlines()]
    assert state.step == 2 and len(losses) == 2 and all(np.isfinite(losses))
