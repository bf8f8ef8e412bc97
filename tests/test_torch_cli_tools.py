"""Port tests: the rest of the CLI against the JAX package on tiny archs —
`info` (keys, parameter count, bounds), `pack` then `train` from the pack
(`--profile`, TensorBoard, EMA), `generate --prime` (the primed span, greedy
classes against JAX's generate(forced=...) on every engine's plain
version, `--fleet` on one rank), `--ema` on generate and serve, the
refusals of `--prime`, `gen.matmul_precision` on the xla engine and
elsewhere, and `warm` on the CPU."""
import argparse
import dataclasses
import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from lb_wavenet_tpu import cli as JCLI
from lb_wavenet_tpu.generate import generate_classes as jgenerate_classes
from lb_wavenet_tpu.models.wavenet import init_params as jinit_params
from lb_wavenet_tpu_torch import cli
from lb_wavenet_tpu_torch import native as PN
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.data import load_wav, write_wav
from lb_wavenet_tpu_torch.generate import generate_classes
from lb_wavenet_tpu_torch.ops.mulaw import mu_law_decode, mu_law_encode
from lb_wavenet_tpu_torch.utils import profiling
from lb_wavenet_tpu_torch.utils.checkpoint import restore_params, save_params
from lb_wavenet_tpu_torch.utils.convert import params_from_jax

from .test_torch_pack import write_wavs
from .util import MICRO

torch.set_num_threads(1)
PMICRO = PArch(**dataclasses.asdict(MICRO))
N_GEN, N_PRIME, GEN_B = 40, 15, 2


def _cfg_file(path, arch, **sections) -> str:
    with open(path, "w") as f:
        json.dump({"arch": dataclasses.asdict(arch), **sections}, f)
    return str(path)


def _lines(capsys) -> list:
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def _audio(classes) -> np.ndarray:
    """The int16 samples write_wav stores for these classes."""
    wav = mu_law_decode(torch.as_tensor(classes)).numpy()
    return (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)


def _read(out_dir, n=GEN_B) -> np.ndarray:
    return np.stack([wavfile.read(os.path.join(out_dir, f"gen_{i:04d}.wav"))[1]
                     for i in range(n)])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A config file, JAX's params of MICRO saved as a port checkpoint, and
    a prime wav of N_PRIME samples."""
    d = tmp_path_factory.mktemp("cli_tools")
    jparams = jinit_params(jax.random.key(3), MICRO)
    save_params(str(d / "ckpt"), params_from_jax(jparams), 0)
    rng = np.random.default_rng(9)
    write_wav(str(d / "prime.wav"), 0.5 * rng.standard_normal(N_PRIME), 16000)
    conf = _cfg_file(d / "cfg.json", PMICRO)
    common = ["--config", conf, "--device", "cpu", "--set", f"gen.checkpoint_dir={d / 'ckpt'}",
              "--set", f"gen.batch_size={GEN_B}", "--set", f"gen.n_samples={N_GEN}",
              "--set", "gen.temperature=0"]
    prime = mu_law_encode(torch.from_numpy(load_wav(str(d / "prime.wav"))[0])).numpy()
    return {"dir": d, "jparams": jparams, "common": common, "prime": prime}


@pytest.mark.parametrize("variant", ["plain", "mel_speakers"])
def test_info_keys_params_and_bounds(tmp_path, capsys, variant):
    """`info` prints JAX's keys with the same geometry and parameter count
    (JAX's by jax.eval_shape), and utils.profiling's H100 bounds; the train
    bound is the six kernels' bounds plus Adam's bytes."""
    arch = MICRO if variant == "plain" else dataclasses.replace(
        MICRO, n_mels=8, cond_channels=8, upsample_factors=(4, 4), n_speakers=3,
        speaker_embed_dim=4)
    parch = PArch(**dataclasses.asdict(arch))
    conf = _cfg_file(tmp_path / "cfg.json", arch)   # JAX's fields: both CLIs load it
    assert cli.main(["info", "--config", conf, "--device", "cpu"]) == 0
    (info,) = _lines(capsys)
    JCLI.cmd_info(argparse.Namespace(config=conf, set=None))
    (jinfo,) = _lines(capsys)
    assert set(info) == set(jinfo)
    for k in ("layers", "dilations", "receptive_field", "receptive_field_ms", "hop_size",
              "local_cond", "global_cond", "n_params", "param_mb", "train_flops_per_sample",
              "gen_batch"):
        assert info[k] == jinfo[k], k
    shapes = jax.eval_shape(lambda k: jinit_params(k, arch), jax.random.key(0))
    assert info["n_params"] == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    from lb_wavenet_tpu_torch.config import Config

    cfg = Config.load(conf)
    train = info["train_speed_of_light"]
    assert train == profiling.train_step_speed_of_light(
        parch, cfg.train.batch_size, cfg.train.window_size, n_param=info["n_params"])
    assert train["device"] == "H100 SXM (data sheet)"
    assert train["sol_step_ms"] == pytest.approx(sum(train["kernels_ms"].values())
                                                 + train["optimizer_ms"], rel=1e-12)
    assert info["ar_speed_of_light"] == profiling.ar_step_speed_of_light(parch, cfg.gen.batch_size)


def test_wavenet30_train_bound_is_perf_rows_plus_adam():
    """At the recipe's shape the train bound is PERF.md's rows 5-10 summed
    (0.927 ms) plus 32 bytes a parameter over 3.35 TB/s (~0.012 ms)."""
    from lb_wavenet_tpu_torch.config import Config

    arch = Config.load(os.path.join(os.path.dirname(__file__), "..", "configs",
                                    "wavenet30.json")).arch
    sol = profiling.train_step_speed_of_light(arch, 8, 10240)
    rows = (0.238, 0.582, 0.0253, 0.0651, 0.0083, 0.0083)
    assert sol["optimizer_ms"] == pytest.approx(32 * 1275584 / 3.35e12 * 1e3)
    assert sol["sol_step_ms"] == pytest.approx(sum(rows) + sol["optimizer_ms"], abs=1e-3)


def test_pack_then_train_from_the_pack(tmp_path, capsys):
    """`pack` (its summary line; --with-waves forced on for a mel arch), then
    `train` from the pack with --profile, TensorBoard and EMA: the losses of
    training from the directory, a Chrome trace of the run, the loss
    scalars, an EMA checkpoint."""
    write_wavs(str(tmp_path / "wavs"), lens=(2500, 1700, 2300))
    conf = _cfg_file(tmp_path / "cfg.json", PMICRO)
    base = ["--config", conf, "--device", "cpu"]
    assert cli.main(["pack", *base, "--data-dir", str(tmp_path / "wavs"),
                     "--out", str(tmp_path / "c.pack")]) == 0
    (summary,) = _lines(capsys)
    assert summary["n_files"] == 2 and summary["enc_dtype"] == "uint8" \
        and not summary["with_waves"] and summary["bytes"] == os.path.getsize(tmp_path / "c.pack")
    mel = _cfg_file(tmp_path / "mel.json", dataclasses.replace(
        PMICRO, n_mels=8, cond_channels=8, upsample_factors=(4, 4)))
    assert cli.main(["pack", "--config", mel, "--data-dir", str(tmp_path / "wavs"),
                     "--out", str(tmp_path / "m.pack")]) == 0
    assert _lines(capsys)[0]["with_waves"]

    train = ["train", *base, "--set", "train.n_steps=3", "--set", "train.log_every=1",
             "--set", "train.batch_size=2", "--set", "train.window_size=64",
             "--set", "train.ema_decay=0.9"]
    assert cli.main([*train, "--profile", str(tmp_path / "prof"),
                     "--set", f"train.data_dir={tmp_path / 'c.pack'}",
                     "--set", f"train.checkpoint_dir={tmp_path / 'ck_pack'}",
                     "--set", f"train.tensorboard_dir={tmp_path / 'tb'}"]) == 0
    from_pack = [r["loss"] for r in _lines(capsys) if "loss" in r]
    assert cli.main([*train, "--set", f"train.data_dir={tmp_path / 'wavs'}",
                     "--set", f"train.checkpoint_dir={tmp_path / 'ck_dir'}"]) == 0
    from_dir = [r["loss"] for r in _lines(capsys) if "loss" in r]
    assert len(from_pack) == 3 and from_pack == from_dir
    (trace,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / trace) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("aten::" in n for n in names)
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    np.testing.assert_allclose([e.value for e in acc.Scalars("loss")], from_pack, rtol=1e-6)
    assert restore_params(str(tmp_path / "ck_pack"), prefer_ema=True)


@pytest.mark.parametrize("engine", ["xla", "mega", "turbo"])
def test_generate_prime_equals_jax(world, capsys, engine):
    """`generate --prime`: every lane's first N_PRIME classes are the
    prime's, and the greedy classes equal JAX's generate(forced=...) on the
    xla engine; mega and turbo run their plain versions here (mega pads the
    session to its lane tile with lanes that never see the prime)."""
    d = world["dir"]
    out = d / f"prime_{engine}"
    assert cli.main(["generate", *world["common"], "--prime", str(d / "prime.wav"),
                     "--set", f"gen.engine={engine}", "--set", f"gen.out_dir={out}",
                     "--profile", str(d / f"gprof_{engine}")]) == 0
    assert _lines(capsys)[-1]["generated"] == GEN_B
    assert os.listdir(d / f"gprof_{engine}")
    forced = np.full((GEN_B, N_GEN), -1, np.int32)
    forced[:, :N_PRIME] = world["prime"]
    want = np.asarray(jgenerate_classes(world["jparams"], MICRO, jax.random.key(0), GEN_B, N_GEN,
                                        forced=jnp.asarray(forced), temperature=0.0,
                                        engine="xla"))
    got = generate_classes(restore_params(str(d / "ckpt")), PMICRO, 0, GEN_B, N_GEN,
                           forced=torch.from_numpy(forced), temperature=0.0, engine=engine,
                           device="cpu").numpy()
    assert (got[:, :N_PRIME] == world["prime"]).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_read(out), _audio(got))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_fleet_prime_on_one_rank(world, capsys, monkeypatch):
    """`generate --fleet --prime` on a one-rank gloo group passes the prime
    through to the mesh synthesis: the single-process run's audio."""
    d = world["dir"]
    args = ["generate", *world["common"], "--prime", str(d / "prime.wav"),
            "--set", "gen.engine=turbo"]
    assert cli.main([*args, "--set", f"gen.out_dir={d / 'single'}"]) == 0
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(_free_port())),
                 ("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_WORLD_SIZE", "1")):
        monkeypatch.setenv(k, v)
    assert cli.main([*args, "--fleet", "--set", f"gen.out_dir={d / 'fleet'}"]) == 0
    summary = _lines(capsys)[-1]
    assert summary["mesh"]["data"] == 1 and summary["engine"] == "turbo"
    np.testing.assert_array_equal(_read(d / "fleet"), _read(d / "single"))
    assert not torch.distributed.is_initialized()


def test_ema_on_generate_and_serve(world, tmp_path, capsys):
    """--ema restores the checkpoint's EMA params: generate and serve write
    the audio of the EMA params saved on their own, not the params'."""
    d = world["dir"]
    write_wavs(str(tmp_path / "wavs"))
    conf = _cfg_file(tmp_path / "cfg.json", PMICRO)
    assert cli.main(["train", "--config", conf, "--device", "cpu",
                     "--set", f"train.data_dir={tmp_path / 'wavs'}", "--set", "train.n_steps=2",
                     "--set", "train.batch_size=2", "--set", "train.window_size=64",
                     "--set", "train.ema_decay=0.5", "--set", "train.learning_rate=0.05",
                     "--set", f"train.checkpoint_dir={tmp_path / 'ck'}"]) == 0
    save_params(str(tmp_path / "ema_only"), restore_params(str(tmp_path / "ck"), prefer_ema=True), 0)
    req = tmp_path / "req.jsonl"
    req.write_text("".join(json.dumps({"id": f"q{i}", "n_samples": 30 + 7 * i, "seed": i,
                                       "temperature": 1.0}) + "\n" for i in range(3)))
    common = world["common"]
    outs = {}
    for name, ckpt, extra in (("ema", tmp_path / "ck", ["--ema"]),
                              ("saved", tmp_path / "ema_only", []),
                              ("plain", tmp_path / "ck", [])):
        sets = [*common, "--set", f"gen.checkpoint_dir={ckpt}", "--set", "gen.temperature=1.0"]
        assert cli.main(["generate", *sets, *extra, "--set", f"gen.out_dir={tmp_path / name}"]) == 0
        assert cli.main(["serve", *sets, *extra, "--requests", str(req), "--stream-chunk", "16",
                         "--set", f"gen.out_dir={tmp_path / ('s_' + name)}"]) == 0
        outs[name] = (_read(tmp_path / name),
                      [wavfile.read(tmp_path / f"s_{name}" / f"q{i}.wav")[1] for i in range(3)])
    capsys.readouterr()
    np.testing.assert_array_equal(outs["ema"][0], outs["saved"][0])
    for a, b in zip(outs["ema"][1], outs["saved"][1]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(outs["ema"][0], outs["plain"][0])
    with pytest.raises(ValueError, match="no EMA"):
        cli.main(["generate", *common, "--ema"])


@pytest.mark.parametrize("flag", [["--stream-chunk", "8"], ["--artifact", "/nonexistent"]])
def test_prime_refused_with_stream_chunk_and_artifact(world, flag):
    d = world["dir"]
    with pytest.raises(SystemExit, match="--prime|priming"):
        cli.main(["generate", *world["common"], "--prime", str(d / "prime.wav"), *flag])


@pytest.mark.parametrize("cmd,engine,value,want", [
    ("generate", "xla", "high", "high"),
    ("generate", "xla", "highest", "highest"),
    ("generate", "xla", "default", "highest"),
    ("generate", "", "", None),
    ("generate", "mega", "highest", SystemExit),
    ("generate", "turbo", "high", SystemExit),
    ("generate", "pallas", "highest", SystemExit),
    ("serve", "", "highest", SystemExit),
])
def test_matmul_precision(world, capsys, monkeypatch, cmd, engine, value, want):
    """gen.matmul_precision: on the xla engine the run takes torch's fp32
    matmul precision of the same name ("default": torch's own) and restores
    the setting after; every other engine refuses it, as JAX does; empty
    changes nothing."""
    from lb_wavenet_tpu_torch import generate as G

    seen = []
    real = G.generate

    def spy(*a, **k):
        seen.append(torch.get_float32_matmul_precision())
        return real(*a, **k)

    monkeypatch.setattr(G, "generate", spy)
    before = torch.get_float32_matmul_precision()
    argv = [cmd, *world["common"], "--set", f"gen.engine={engine}",
            "--set", f"gen.matmul_precision={value}",
            "--set", f"gen.out_dir={world['dir'] / 'prec'}"]
    if cmd == "serve":
        argv += ["--listen", "127.0.0.1:0"]
    if want is SystemExit:
        with pytest.raises(SystemExit, match="xla-engine audit knob"):
            cli.main(argv)
    else:
        assert cli.main(argv) == 0
        assert seen == [want or before]
    assert torch.get_float32_matmul_precision() == before
    capsys.readouterr()


def test_warm_on_the_cpu_builds_the_native_tier(tmp_path, capsys, monkeypatch):
    """`warm --device cpu` builds the native library (the nvcc kernels need a
    card); a second warm finds it built. Without a card, the default device
    raises."""
    monkeypatch.setattr(PN, "BUILD", tmp_path / "build")
    argv = ["warm", "--device", "cpu", "--skip-train", "--stream-chunk", "64"]
    assert cli.main(argv) == 0
    first = _lines(capsys)
    assert first[0]["target"] == "native:loader" and not first[0]["cached"]
    assert first[-1]["backend"] == "cpu" and first[-1]["cache_dir"] == str(tmp_path / "build")
    assert [p.name for p in (tmp_path / "build").iterdir()] == [PN.library_path().name]
    assert cli.main(argv) == 0
    assert all(w["cached"] for w in _lines(capsys)[-1]["warmed"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["warm"])
