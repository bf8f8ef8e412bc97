"""Port tests: training across ranks on the CPU. Data-parallel (2 ranks),
sequence-parallel (2 ranks; mel with speakers), skip-split model-parallel
(model axis 2) and data x model (2 x 2) over gloo, every rank a process
started once per layout (tests/torch_train_ranks.py, which imports no JAX;
the ranks run the fused flags, i.e. the kernels' plain versions). Each
layout's step, loss and every gradient leaf (Adam's first moment after one
step from zero is (1 - b1) g) held against the JAX package's step on the
virtual CPU mesh (the data-sharded `train_step`, `make_sp_train_step`,
`make_tp_train_step`) and against the port's one-rank step; grad_accum = 2
against one-shot; the divergence guard; a two-rank run_training that
checkpoints and resumes, whose model-sharded checkpoint serves on one
device; the loader's rows per rank; the chunking errors; the mesh settings
without their ranks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu import train as JT
from lb_wavenet_tpu.config import ArchConfig
from lb_wavenet_tpu.config import TrainConfig as JTrain
from lb_wavenet_tpu.data import Batch as JBatch
from lb_wavenet_tpu.parallel.halo import _check_chunking as jcheck
from lb_wavenet_tpu.parallel.mesh import make_mesh as jmesh
from lb_wavenet_tpu.parallel.mesh import shard_params as jshard
from lb_wavenet_tpu_torch import train as PT
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.config import Config as PConfig
from lb_wavenet_tpu_torch.config import TrainConfig as PTrain
from lb_wavenet_tpu_torch.data import Batch, make_batches, synthetic_corpus
from lb_wavenet_tpu_torch.parallel import halo as PH
from lb_wavenet_tpu_torch.parallel import mesh as PM
from lb_wavenet_tpu_torch.utils.convert import params_to_numpy, train_state_from_jax

from . import torch_train_ranks as R
from .util import MICRO

torch.set_num_threads(1)
RTOL = 1e-4      # fp32: the same products summed in another order
B, W = 4, 24
# Sequence parallelism with mel (Cc 8, hop 4) and 2 speakers: R - 1 = 8,
# T = 32, two chunks of 16.
SP_ARCH = ArchConfig(n_blocks=1, n_layers_per_block=3, residual_channels=8, skip_channels=8,
                     gate_channels=8, n_mels=8, cond_channels=8, upsample_factors=(2, 2),
                     n_speakers=2, speaker_embed_dim=4, compute_dtype="float32")
FUSED = dict(fused_stack=True, tapcat=True, fused_post=True, fused_frontend=True,
             mm_embed_grad=True)
LAYOUTS = {"dp": ((2, 1), MICRO), "sp": ((2, 1), SP_ARCH), "tp": ((1, 2), MICRO),
           "dp_tp": ((2, 2), MICRO)}


def _parch(arch):
    return PArch(**dataclasses.asdict(arch))


def _train(kind, layout, **kw):
    return dict(batch_size=B, window_size=W, learning_rate=1e-3, seq_parallel=kind == "sp",
                mesh_data=layout[0], mesh_model=layout[1], **kw)


def _global_batch(arch, seed=2) -> Batch:
    """The first global batch of a synthetic corpus (mel frames and
    speakers for a conditioned arch)."""
    parch = _parch(arch)
    corpus = synthetic_corpus(parch, W, n_files=2, file_len=600, seed=seed)
    if parch.use_global_cond:
        corpus.speakers = [0, 1]
    train = PTrain(**_train("dp", (1, 1)))
    return next(make_batches(corpus, train, with_mel=parch.use_local_cond))


def _jax_state(arch):
    return JT.init_state(jax.random.key(3), arch, JTrain(**_train("dp", (1, 1))))


def _case(name):
    """(layout, the ranks' case dict, the JAX state, the global batch)."""
    layout, arch = LAYOUTS[name]
    kind = "tp" if name.startswith("dp_tp") or name == "tp" else name
    jstate = _jax_state(arch)
    ps = train_state_from_jax(jstate)
    state = {"params": params_to_numpy(ps.params), "mu": params_to_numpy(ps.opt_state["mu"]),
             "nu": params_to_numpy(ps.opt_state["nu"]), "count": ps.opt_state["count"],
             "step": ps.step}
    batch = _global_batch(arch)
    case = {"kind": kind, "arch": dataclasses.asdict(_parch(arch)),
            "train": _train(kind, layout, **FUSED), "state": state, "clip": 0.05,
            "batch": {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}}
    return layout, case, jstate, batch


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{layout name: (case, JAX state, global batch, [each rank's results],
    the spawn's work directory)}, each layout spawned on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            layout, case, jstate, batch = _case(name)
            work = tmp_path_factory.mktemp(f"train_{name}")
            world = layout[0] * layout[1]
            torch.multiprocessing.spawn(
                R.run_rank, args=(world, str(work / "store"), layout, case, str(work)),
                nprocs=world, join=True)
            cache[name] = (case, jstate, batch,
                           [torch.load(work / f"rank{r}.pt", weights_only=False)
                            for r in range(world)], work)
        return cache[name]

    return get


def _flat(tree, prefix=""):
    """{path: array} of a nested dict / list tree of arrays."""
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in _flat(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _trees_close(got, want, rtol, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        scale = max(float(np.abs(w[k]).max()), 1e-30)
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=rtol * scale, err_msg=f"{what} {k}")


def _grads(mu, b1=0.9):
    """Gradients from Adam's first moment after one step from zero."""
    return jax.tree.map(lambda m: np.asarray(m) / (1 - b1), mu)


def _jax_step(name, jstate, batch, **train_kw):
    """The JAX package's step of the layout on its virtual mesh (XLA paths):
    (loss, grads, new params) as numpy trees."""
    layout, arch = LAYOUTS[name]
    kind = "tp" if name in ("tp", "dp_tp") else name
    train = JTrain(**_train(kind, layout, **train_kw))
    mesh = jmesh(*layout, devices=jax.devices()[: layout[0] * layout[1]])
    state = jshard(jax.tree.map(jnp.copy, jstate), mesh)
    jb = JBatch(**{f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)})
    if kind == "sp":
        new, loss = JT.make_sp_train_step(mesh, arch, train)(
            state, JT.seq_batch_to_device(jb, mesh, W, arch=arch))
    elif kind == "tp":
        new, loss = JT.make_tp_train_step(mesh, arch, train)(
            state, JT.batch_to_device(jb, mesh, arch))
    else:
        new, loss = JT.train_step(state, JT.batch_to_device(jb, mesh, arch), arch, train)
    ps = train_state_from_jax(jax.device_get(new))
    return (float(loss), _grads(params_to_numpy(ps.opt_state["mu"])),
            params_to_numpy(ps.params))


def _port_step(case, **train_kw):
    """The port's one-rank (windowed, unsharded) step on the global batch:
    (loss, grads, new params)."""
    arch = PArch(**case["arch"])
    train = dataclasses.replace(PTrain(**case["train"]), seq_parallel=False, mesh_data=-1,
                                mesh_model=1, **train_kw)
    state = R._state(case)
    batch = PT.batch_to_device(Batch(**case["batch"]), "cpu")
    new, loss = PT.train_step(state, batch, arch, train)
    return (float(loss), _grads(params_to_numpy(new.opt_state["mu"])),
            params_to_numpy(new.params))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_step_matches_jax_and_one_rank(ranks, name):
    """Loss and every gradient leaf of the layout's step (fused flags, the
    plain versions) against the JAX package's step (XLA) and against the
    port's one-rank step, fp32 within RTOL; every rank holds the same
    result."""
    case, jstate, batch, results, _ = ranks(name)
    layout = LAYOUTS[name][0]
    assert [r["mesh"][:2] for r in results] == [layout] * len(results)
    assert {r["mesh"][4] for r in results} == {"gloo"}
    loss, params, mu = results[0]["step"]
    for r in results[1:]:
        assert r["step"][0] == loss
        _trees_close(r["step"][1], params, 0.0, "replicated params")
    got = _grads(mu)
    for ref_loss, ref_grads, _ in (_jax_step(name, jstate, batch), _port_step(case)):
        np.testing.assert_allclose(loss, ref_loss, rtol=RTOL)
        _trees_close(got, ref_grads, RTOL, name)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_grad_accum_equals_one_shot(ranks, name):
    """grad_accum = 2 (a rank's rows i::2 as micro i, one reduction per
    step) against the one-shot step: the same function up to float
    rounding."""
    _, _, _, results, _ = ranks(name)
    for r in results:
        np.testing.assert_allclose(r["accum"][0], r["step"][0], rtol=1e-6)
        _trees_close(_grads(r["accum"][2]), _grads(r["step"][2]), 1e-5, "grad_accum")


@pytest.mark.parametrize("name", ["tp", "dp_tp"])
def test_model_sharded_clipping_takes_the_global_norm(ranks, name):
    """With grad_clip_norm > 0 the model ranks clip by the global norm (the
    sharded leaves' squares summed over the model group): the updated
    params equal the one-rank clipped step's."""
    case, _, _, results, _ = ranks(name)
    ref = _port_step(case, grad_clip_norm=case["clip"])
    for r in results:
        _trees_close(r["clip"][1], ref[2], RTOL, "clipped update")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_divergence_guard(ranks, name):
    """assert_replicated_params passes on the same state (model-sharded:
    every rank of the mesh gets one checksum) and raises on every rank when
    one rank's replicated leaf moves."""
    _, _, _, results, _ = ranks(name)
    assert len({r["checksum"] for r in results}) == 1
    for r in results:
        assert r["guard"].startswith("Cross-rank parameter divergence at step 7")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_run_training_checkpoints_and_resumes(ranks, name, tmp_path):
    """run_training on the ranks: 2 steps then a resume to 3 equals 3 steps
    straight bit for bit; the checkpoint (rank (0, 0)'s) holds the whole
    params, model-sharded leaves gathered to full width; the final params
    are the same on every rank and near the one-device run's (Adam's first
    steps move each weight by about the learning rate whatever the
    gradient's size, so a flipped sign of a near-zero gradient moves it by
    2 lr)."""
    case, _, _, results, _ = ranks(name)
    arch = PArch(**case["arch"])
    straight, resumed = results[0]["run"]["straight"], results[0]["run"]["resumed"]
    assert straight[0] == resumed[0] == 3
    assert straight[2] == [2, 3] and resumed[2] == [2, 3]
    _trees_close(resumed[1], straight[1], 0.0, "resume")
    for r in results[1:]:
        _trees_close(r["run"]["straight"][1], straight[1], 0.0, "replicated")
    _trees_close(params_to_numpy(straight[3]), straight[1], 0.0, "checkpoint")
    train = dataclasses.replace(PTrain(**case["train"]), seq_parallel=False, mesh_data=-1,
                                mesh_model=1, checkpoint_every=0)
    corpus = synthetic_corpus(arch, W, n_files=2, file_len=600, seed=5)
    if arch.use_global_cond:
        corpus.speakers = [0, 1]
    single = PT.run_training(PConfig(arch=arch, train=dataclasses.replace(
        train, checkpoint_dir=str(tmp_path), n_steps=3)), corpus=corpus, device="cpu")
    g, w = _flat(straight[1]), _flat(params_to_numpy(single.params))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=3 * 2 * train.learning_rate + 1e-6,
                                   err_msg=k)


def test_model_sharded_checkpoint_serves_on_one_device(ranks, tmp_path, capsys):
    """The checkpoint of a model-sharded run (whole-width leaves, rank (0,
    0)'s) serves through single-device `cli serve`."""
    import json

    from lb_wavenet_tpu_torch import cli

    case, _, _, _, work = ranks("tp")
    cfg = tmp_path / "arch.json"
    cfg.write_text(json.dumps({"arch": case["arch"]}))
    reqs = tmp_path / "requests.jsonl"
    reqs.write_text(json.dumps({"id": "a", "n_samples": 12}) + "\n")
    rc = cli.main(["serve", "--device", "cpu", "--config", str(cfg), "--requests", str(reqs),
                   "--set", f"gen.checkpoint_dir={work / 'ckpt_straight'}",
                   "--set", f"gen.out_dir={tmp_path / 'out'}", "--set", "gen.batch_size=2"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["served"] == 1
    assert (tmp_path / "out" / "a.wav").exists()


def test_loader_rows_per_rank():
    """A data rank's loader (host_id = data_rank, host_count = data) yields
    rows data_rank::data of the global batch, which is what shard_batch
    cuts; every model rank of one data row loads the same rows."""
    parch = _parch(MICRO)
    corpus = synthetic_corpus(parch, W, n_files=2, file_len=600, seed=1)
    train = PTrain(**_train("dp", (2, 1)))
    whole = next(make_batches(corpus, train))
    for i in range(2):
        part = next(make_batches(corpus, train, host_id=i, host_count=2))
        np.testing.assert_array_equal(part.inputs, whole.inputs[i::2])
        np.testing.assert_array_equal(part.targets, whole.targets[i::2])
    mesh = PM.Mesh(2, 2, 1, 0, None, None, torch.device("cpu"), "none")
    rows = PM.shard_batch(PT.batch_to_device(whole, "cpu"), mesh)
    np.testing.assert_array_equal(rows["inputs"].numpy(), whole.inputs[1::2])


@pytest.mark.parametrize("t,n", [(30, 4), (32, 8), (64, 2)])
def test_chunking_errors_match_jax(t, n):
    """check_chunking raises JAX's two errors (an uneven split, a chunk
    shorter than the halo) and passes where JAX's does."""
    jm = jmesh(n, 1, devices=jax.devices()[:n])
    try:
        jcheck(MICRO, t, jm, "data")
        want = None
    except ValueError as e:
        want = str(e)
    try:
        PH.check_chunking(_parch(MICRO), t, n)
        got = None
    except ValueError as e:
        got = str(e)
    assert got == want


def test_sp_logits_rows_are_the_unsharded_forward_rows():
    """sequence_parallel_logits on a 1-rank mesh and the halo windows of 2
    virtual ranks (no process group: the function reads only the mesh's
    coordinates) give the unsharded forward's rows, nonzero biases
    included."""
    arch = _parch(MICRO)
    params = PT.init_params(1, arch)
    params = PT.tree_map(lambda p: p + 0.1 * torch.randn(p.shape, generator=torch.Generator()
                                                         .manual_seed(p.numel())), params)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64)).astype(np.int32))
    ref = PT.forward(params, arch, x)
    for n in (1, 2):
        for i in range(n):
            mesh = PM.Mesh(n, 1, i, 0, None, None, torch.device("cpu"), "none")
            got = PH.sequence_parallel_logits(params, arch, x, mesh)
            want = ref[:, i * 64 // n:(i + 1) * 64 // n]
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("override", [dict(mesh_data=2), dict(mesh_model=2)],
                         ids=["mesh_data", "mesh_model"])
def test_mesh_settings_need_their_ranks(tmp_path, override):
    """A process that runs alone trains on the 1 x 1 mesh; asking it for a
    mesh of more ranks raises, naming how to start them."""
    train = PTrain(**_train("dp", (1, 1)), checkpoint_dir=str(tmp_path), n_steps=1)
    cfg = PConfig(arch=_parch(MICRO), train=dataclasses.replace(train, **override))
    corpus = synthetic_corpus(_parch(MICRO), W, n_files=1, file_len=500)
    with pytest.raises(ValueError, match="torchrun"):
        PT.run_training(cfg, corpus=corpus, device="cpu")


def test_sequence_parallel_on_one_rank_is_the_windowed_step(tmp_path):
    """seq_parallel on a process that runs alone: the 1-rank time shard
    (the halo before the sequence masked) takes the windowed step's
    gradients (Adam's first moment after one step)."""
    arch = _parch(SP_ARCH)
    corpus = synthetic_corpus(arch, W, n_files=2, file_len=600, seed=5)
    corpus.speakers = [0, 1]
    out = {}
    for sp in (False, True):
        train = PTrain(**dict(_train("sp", (1, 1), **FUSED), seq_parallel=sp, mesh_data=-1),
                       checkpoint_dir=str(tmp_path / str(sp)), n_steps=1, log_every=1)
        out[sp] = PT.run_training(PConfig(arch=arch, train=train), corpus=corpus, device="cpu")
    mu = {sp: params_to_numpy(out[sp].opt_state["mu"]) for sp in out}
    _trees_close(mu[True], mu[False], RTOL, "seq_parallel on one rank")
