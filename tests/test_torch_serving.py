"""Port tests: SessionPool against the JAX SessionPool, lane recycling,
checkpoints and the `serve` CLI (CPU, mega engine's plain version)."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from lb_wavenet_tpu.models.wavenet import init_params as jinit
from lb_wavenet_tpu.serving import SessionPool as JPool
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.serving import SessionPool as PPool
from lb_wavenet_tpu_torch.utils.checkpoint import (
    latest_step, restore_params, save_params,
)
from lb_wavenet_tpu_torch.utils.convert import params_from_jax

from .util import MICRO

torch.set_num_threads(1)
CHUNK = 8
# (id, n_samples, seed, temperature): greedy, sampled and default lanes;
# more requests than lanes, so later ones take recycled lanes.
REQUESTS = [("a", 20, 11, 0.0), ("b", 13, 2**31 - 7, 0.7), ("c", 9, 5, None),
            ("d", 17, 23, 1.0), ("e", 8, 0, 0.7)]


@pytest.fixture(scope="module")
def pair():
    import dataclasses

    jp = jinit(jax.random.key(0), MICRO)
    return (jp, params_from_jax(jax.tree.map(np.asarray, jp)),
            PArch(**dataclasses.asdict(MICRO)))


def _serve(pool, requests, lanes=None):
    """Drive a pool to completion, submitting as lanes free up."""
    out, parts, queue = {}, {}, list(requests)

    def fill():
        while queue:
            rid, n, seed, temp = queue[0]
            if not pool.submit(rid, n, seed=seed, temperature=temp):
                return
            if lanes is not None:
                lanes[rid] = next(i for i, ls in enumerate(pool._lanes)
                                  if ls is not None and ls.request_id == rid)
            parts[rid] = []
            queue.pop(0)

    fill()
    while pool.active or queue:
        for rid, (cls, done) in pool.step().items():
            parts[rid].append(cls)
            if done:
                out[rid] = np.concatenate(parts.pop(rid))
        fill()
    return out


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("deliver", ["chunk", "request"])
def test_pool_matches_jax_pool(pair, pipeline, deliver):
    """Mega pools with explicit seeds and mixed temperatures deliver the
    same classes in both frameworks (per-lane hash, recycled lanes)."""
    jp, pp, parch = pair
    kw = dict(engine="mega", chunk_size=CHUNK, temperature=1.0,
              pipeline=pipeline, deliver=deliver, acc_samples=6 * CHUNK)
    reqs = [(rid, n, 100 + i if seed is None else seed, t)
            for i, (rid, n, seed, t) in enumerate(REQUESTS)]
    j = _serve(JPool(jp, MICRO, 3, jax.random.key(1), **kw), reqs)
    lanes = {}
    p = _serve(PPool(pp, parch, 3, 1, device="cpu", **kw), reqs, lanes)
    assert sorted(p) == sorted(j) == sorted(r[0] for r in REQUESTS)
    for rid, n, _, _ in reqs:
        assert p[rid].shape == (n,) and p[rid].dtype == np.int32
        np.testing.assert_array_equal(p[rid], j[rid], err_msg=rid)
    assert lanes["d"] < 3 and lanes["e"] < 3   # leased after completions


def test_recycled_lane_equals_fresh_session(pair):
    """A request served on a recycled lane of a busy pool equals the same
    request alone on a dedicated pool (greedy and sampled)."""
    _, pp, parch = pair
    kw = dict(engine="mega", chunk_size=CHUNK, temperature=1.0, device="cpu")
    lanes = {}
    reqs = [(rid, n, 7 if seed is None else seed, t)
            for rid, n, seed, t in REQUESTS[:4]]
    busy = _serve(PPool(pp, parch, 2, 3, **kw), reqs, lanes)
    for req in reqs[2:4]:
        alone = _serve(PPool(pp, parch, 1, 4, **kw), [req])
        np.testing.assert_array_equal(busy[req[0]], alone[req[0]], err_msg=req[0])
    assert lanes["c"] < 2 and lanes["d"] < 2


def test_pool_validation(pair):
    _, pp, parch = pair
    pool = PPool(pp, parch, 1, 0, engine="mega", chunk_size=CHUNK,
                 temperature=1.0, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        pool.submit("x", 0)
    with pytest.raises(ValueError, match=">= 0"):
        pool.submit("x", 4, temperature=-1.0)
    with pytest.raises(ValueError, match="n_speakers"):   # speakers are ported
        pool.submit("x", 4, speaker=1)
    with pytest.raises(ValueError, match="cond_fn"):
        pool.submit("x", 4, cond_fn=lambda t, n: None)
    assert pool.submit("x", 4) and not pool.submit("y", 4)
    with pytest.raises(ValueError, match="deliver"):
        PPool(pp, parch, 1, 0, deliver="bogus", device="cpu")


def test_checkpoint_round_trip(pair, tmp_path):
    _, pp, _ = pair
    assert latest_step(str(tmp_path)) is None
    save_params(str(tmp_path), pp, 3)
    save_params(str(tmp_path), {"post": {"w1": torch.zeros(2)}}, 1)
    assert latest_step(str(tmp_path)) == 3
    back = restore_params(str(tmp_path))
    for k in ("embed",):
        assert torch.equal(back[k], pp[k])
    assert torch.equal(back["layers"]["w_skip"], pp["layers"]["w_skip"])
    with pytest.raises(FileNotFoundError):
        restore_params(str(tmp_path / "missing"))


def test_cli_serve_writes_wavs(pair, tmp_path, capsys):
    """`serve --requests --device cpu` from a save_params checkpoint: one
    wav per request, equal to the pool's classes, and the summary line."""
    from scipy.io import wavfile

    from lb_wavenet_tpu_torch import cli
    from lb_wavenet_tpu_torch.ops.mulaw import mu_law_decode

    _, pp, parch = pair
    save_params(str(tmp_path / "ckpt"), pp, 0)
    cfg = tmp_path / "arch.json"
    import dataclasses

    cfg.write_text(json.dumps({"arch": dataclasses.asdict(parch)}))
    req = tmp_path / "req.jsonl"
    req.write_text("".join(
        json.dumps({"id": rid, "n_samples": n, **({"seed": s} if s is not None else {}),
                    **({"temperature": t} if t is not None else {})}) + "\n"
        for rid, n, s, t in REQUESTS[:3]
    ))
    out = tmp_path / "wav"
    rc = cli.main([
        "serve", "--config", str(cfg), "--requests", str(req), "--device", "cpu",
        "--stream-chunk", str(CHUNK), "--set", f"gen.checkpoint_dir={tmp_path / 'ckpt'}",
        "--set", f"gen.out_dir={out}", "--set", "gen.batch_size=2",
    ])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["served"] == 3 and summary["engine"] == "mega"
    assert set(summary["phase_ms_per_step"]) == {
        "reset", "cond", "dispatch", "fetch", "slice", "submit"}
    seeds = {json.loads(ln)["done"]: json.loads(ln).get("seed") for ln in lines[:-1]}
    ref = _serve(PPool(pp, parch, 2, 0, engine="mega", chunk_size=CHUNK,
                       temperature=1.0, pipeline=True, device="cpu"),
                 [(rid, n, seeds[rid], t) for rid, n, _, t in REQUESTS[:3]])
    for rid, n, _, _ in REQUESTS[:3]:
        sr, wav = wavfile.read(os.path.join(out, f"{rid}.wav"))
        assert sr == parch.sample_rate and wav.shape == (n,)
        expect = mu_law_decode(torch.from_numpy(ref[rid])).numpy()
        np.testing.assert_array_equal(
            wav, (np.clip(expect, -1, 1) * 32767.0).astype(np.int16))


def test_cli_generate_streams(pair, tmp_path, capsys):
    from lb_wavenet_tpu_torch import cli

    _, pp, parch = pair
    import dataclasses

    save_params(str(tmp_path / "ckpt"), pp, 0)
    cfg = tmp_path / "arch.json"
    cfg.write_text(json.dumps({"arch": dataclasses.asdict(parch)}))
    for extra in ([], ["--stream-chunk", "8"]):
        rc = cli.main([
            "generate", "--config", str(cfg), "--device", "cpu", *extra,
            "--set", f"gen.checkpoint_dir={tmp_path / 'ckpt'}",
            "--set", f"gen.out_dir={tmp_path / 'out'}",
            "--set", "gen.batch_size=3", "--set", "gen.n_samples=20",
            "--set", 'gen.engine="mega"',
        ])
        assert rc == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["generated"] == 3 and summary["n_samples"] == 20
    assert len(os.listdir(tmp_path / "out")) == 3
