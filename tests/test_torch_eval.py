"""Port tests: held-out evaluation (eval.py) against the JAX package's
`evaluate`, its invariance to the eval batch size, the fused forward
against the plain one, in-training eval records and `cli eval`."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from lb_wavenet_tpu import data as JD
from lb_wavenet_tpu.eval import evaluate as jevaluate
from lb_wavenet_tpu.models.wavenet import init_params as jinit
from lb_wavenet_tpu_torch import data as PD
from lb_wavenet_tpu_torch import train as PT
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.config import Config as PConfig
from lb_wavenet_tpu_torch.config import TrainConfig as PTrain
from lb_wavenet_tpu_torch.eval import eval_batches, evaluate
from lb_wavenet_tpu_torch.utils.convert import params_from_jax

from .util import MICRO

torch.set_num_threads(1)
PMICRO = PArch(**dataclasses.asdict(MICRO))
W = 32
# fp32 MICRO: masked sums over a few thousand positions in another order.
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jp = jinit(jax.random.key(3), MICRO)
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    jc = JD.synthetic_corpus(MICRO, W, n_files=3, file_len=700, seed=2)
    pc = PD.synthetic_corpus(PMICRO, W, n_files=3, file_len=700, seed=2)
    return jp, pp, jc, pc


def _close(a: dict, b: dict, tol=TOL):
    assert a["n_samples"] == b["n_samples"] and a["n_windows"] == b["n_windows"]
    for k in ("nll", "bits_per_sample", "accuracy"):
        assert a[k] == pytest.approx(b[k], abs=tol), k


def test_evaluate_matches_jax(setup):
    jp, pp, jc, pc = setup
    want = jevaluate(jp, MICRO, jc, 4)
    got = evaluate(pp, PMICRO, pc, 4, device="cpu")
    _close(got, want)
    assert got["n_windows"] == len(pc.index) and 0.0 <= got["accuracy"] <= 1.0
    capped = evaluate(pp, PMICRO, pc, 4, max_batches=1, device="cpu")
    _close(capped, jevaluate(jp, MICRO, jc, 4, max_batches=1))


def test_eval_batch_size_does_not_change_the_result(setup):
    """The last batch is padded with zero-mask rows: batch 2 and 3 give the
    same metrics, and the padded rows are masked out."""
    _, pp, _, pc = setup
    a = evaluate(pp, PMICRO, pc, 2, device="cpu")
    b = evaluate(pp, PMICRO, pc, 3, device="cpu")
    _close(a, b)
    last = list(eval_batches(pc, 3))[-1]
    n_pad = 3 * -(-len(pc.index) // 3) - len(pc.index)
    assert last.inputs.shape[0] == 3
    assert n_pad == 0 or not last.mask[-n_pad:].any()


def test_fused_and_plain_forward_agree(setup):
    _, pp, _, pc = setup
    _close(evaluate(pp, PMICRO, pc, 4, fused=True, tapcat=True, device="cpu"),
           evaluate(pp, PMICRO, pc, 4, device="cpu"))


def test_run_training_writes_eval_records(tmp_path, capsys, setup):
    """eval_every = 2 over 4 steps: eval records at steps 2 and 4 (with the
    EMA's), the last equal to evaluate() of the final params; the step
    records stay apart."""
    _, _, _, pc = setup
    train = PTrain(batch_size=2, window_size=W, learning_rate=1e-3, n_steps=4, log_every=1,
                   checkpoint_dir=str(tmp_path / "ckpt"), eval_every=2, eval_batch_size=3,
                   ema_decay=0.9, fused_stack=True, tapcat=True, fused_post=True,
                   fused_frontend=True)
    corpus = PD.synthetic_corpus(PMICRO, W, n_files=2, file_len=900, seed=5)
    state = PT.run_training(PConfig(arch=PMICRO, train=train), corpus=corpus,
                            eval_corpus=pc, device="cpu")
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    evals = [r for r in recs if "eval_nll" in r]
    assert [r["step"] for r in evals] == [2, 4]
    assert all({"eval_accuracy", "eval_bits_per_sample", "eval_n_samples", "eval_ema_nll",
                "eval_ema_accuracy"} <= set(r) for r in evals)
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4]
    final = evaluate(state.params, PMICRO, pc, 3, fused=True, tapcat=True, device="cpu")
    assert evals[-1]["eval_nll"] == pytest.approx(final["nll"], abs=1e-6)


def test_cli_eval_prints_the_metrics(tmp_path, capsys, setup):
    from lb_wavenet_tpu_torch import cli
    from lb_wavenet_tpu_torch.utils.checkpoint import save_params

    _, pp, _, pc = setup
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i, w in enumerate(pc.waves):
        PD.write_wav(str(wavs / f"{i}.wav"), w, PMICRO.sample_rate)
    save_params(str(tmp_path / "ckpt"), pp, 7)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"arch": dataclasses.asdict(PMICRO),
                               "train": {"window_size": W, "eval_batch_size": 4}}))
    common = ["eval", "--config", str(cfg), "--device", "cpu",
              "--set", f"gen.checkpoint_dir={tmp_path / 'ckpt'}"]
    assert cli.main(common + ["--data-dir", str(wavs)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = evaluate(pp, PMICRO, PD.load_corpus(str(wavs), PMICRO, W), 4, device="cpu")
    assert set(got) == {"nll", "bits_per_sample", "accuracy", "n_samples", "n_windows"}
    _close(got, want, 0.0)
    with pytest.raises(ValueError, match="no EMA"):
        cli.main(common + ["--data-dir", str(wavs), "--ema"])
    with pytest.raises(SystemExit, match="data-dir"):
        cli.main(common)
