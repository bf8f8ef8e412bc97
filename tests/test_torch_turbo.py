"""Port tests: the turbo engine — turbo_step's plain version (the CPU path
of the kernel wrapper) against the JAX turbo kernel in interpret mode, the
one-shot and streaming turbo paths against JAX's, reset_lanes, the pallas
engine, and SessionPool(engine="turbo")."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu import generate as JG
from lb_wavenet_tpu.models.wavenet import init_params as jinit
from lb_wavenet_tpu.ops.pallas.ar_turbo import turbo_step as jturbo
from lb_wavenet_tpu_torch import generate as PG
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.ops.cuda import ar_turbo as PT
from lb_wavenet_tpu_torch.utils.convert import params_from_jax

from .util import MICRO

torch.set_num_threads(1)
ATOL = 2e-5   # fp32 MICRO: the same products summed in another order


def _pair(k_taps=2, seed=0):
    arch = dataclasses.replace(MICRO, input_kernel=k_taps)
    jp = jinit(jax.random.key(seed), arch)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp)), arch, \
        PArch(**dataclasses.asdict(arch))


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _lane(b, rows, seed=0):
    rng = np.random.default_rng(seed)
    lane = [rng.integers(0, 2**31 - 1, b).astype(np.int32),
            rng.integers(-50, 50, b).astype(np.int32)]
    if rows == 3:
        inv = (np.float32(1.0) / np.array([0.7, 1.0, 2.0] * b, np.float32)[:b])
        inv[::3] = 0.0   # greedy lanes
        lane.append(inv.astype(np.float32).view(np.int32))
    return np.stack(lane)


CASES = [("greedy", 2), ("lane2", 2), ("lane3", 2), ("forced", 2), ("global", 2),
         ("greedy", 1), ("lane2", 1), ("lane3", 3), ("global", 3)]


@pytest.mark.parametrize("mode,k_taps", CASES)
def test_turbo_step_matches_jax(mode, k_taps):
    """One step at t = 777 from a random ring, h0 and embedding stack: the
    ring, classes, h0_next, stack and logits equal the JAX kernel's."""
    jp, pp, jarch, parch = _pair(k_taps, seed=k_taps)
    b, c, t, seed_base = 6, MICRO.residual_channels, 777, 12345
    rng = np.random.default_rng(7)
    bufs = rng.standard_normal((sum(MICRO.dilations), b, c)).astype(np.float32)
    h0 = rng.standard_normal((b, c)).astype(np.float32)
    estack = rng.standard_normal((k_taps - 1, b, c)).astype(np.float32)
    forced = np.full((b,), -1, np.int32)
    if mode == "forced":
        forced[::2] = [3, 250, 0]
    temperature = 0.0 if mode in ("greedy", "forced") else 0.8
    lane = {"lane2": _lane(b, 2), "lane3": _lane(b, 3)}.get(mode)
    slots = np.asarray(PG.buffer_offsets(parch)) + t % np.asarray(MICRO.dilations)
    jb, jc, je, jh, jl = jturbo(
        jp, jp["layers"], jarch, jnp.asarray(h0), jnp.asarray(estack), jnp.asarray(bufs),
        jnp.asarray(slots, jnp.int32), jnp.asarray([seed_base + t, t], jnp.int32),
        jnp.asarray(forced[:, None]), temperature=temperature, interpret=True,
        lane=None if lane is None else jnp.asarray(lane), emit_logits=True)
    pbufs = torch.from_numpy(bufs.copy())
    pb, pc, pe, ph, pl = PT.turbo_step(
        pp, pp["layers"], parch, torch.from_numpy(h0), torch.from_numpy(estack), pbufs, t,
        seed_base, torch.from_numpy(forced), temperature=temperature,
        lane=None if lane is None else torch.from_numpy(lane), emit_logits=True)
    assert pb is pbufs   # the ring is updated in place
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    for got, want in ((pb, jb), (pe, je), (ph, jh), (pl, jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    if mode == "forced":
        np.testing.assert_array_equal(pc.numpy()[::2], [3, 250, 0])


def test_generate_turbo_matches_jax(pair):
    """One-shot turbo over 48 steps: teacher-forced logits and classes, and
    free-running greedy classes, equal JAX's."""
    jp, pp, jarch, parch = pair
    b, n = 5, 48
    forced = np.random.default_rng(0).integers(0, 256, (b, n)).astype(np.int32)
    jc, jl = JG.generate_classes(jp, jarch, jax.random.key(0), b, n, engine="turbo",
                                 forced=jnp.asarray(forced), return_logits=True)
    pc, pl = PG.generate_classes(pp, parch, 0, b, n, engine="turbo", forced=forced,
                                 return_logits=True, device="cpu")
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    jg = JG.generate_classes(jp, jarch, jax.random.key(0), b, n, engine="turbo",
                             temperature=0.0)
    pg = PG.generate_classes(pp, parch, 0, b, n, engine="turbo", temperature=0.0,
                             device="cpu")
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("rows", [2, 3, None], ids=["lane2", "lane3", "global"])
def test_sampled_turbo_stream_matches_jax(pair, rows):
    """Sampled turbo streaming, 48 steps in two chunks: with an explicit lane
    block (2 or 3 rows), or with global_rng at JAX's session seed; the
    classes equal JAX's and the logits are allclose."""
    jp, pp, jarch, parch = pair
    b = 6
    js = JG.start_stream(jarch, b, jax.random.key(1), engine="turbo", params=jp)
    ps = PG.start_stream(parch, b, 1, engine="turbo", params=pp, device="cpu")
    ps.state["seed_base"] = int(js.state["seed_base"])
    kw, pkw = {}, {}
    if rows is None:
        kw = pkw = dict(global_rng=True)
    else:
        lane = _lane(b, rows, seed=rows)
        pkw = dict(lane_seed=lane[0], lane_t0=lane[1])
        kw = {k: jnp.asarray(v) for k, v in pkw.items()}
        if rows == 3:
            pkw["lane_inv_temp"] = lane[2].view(np.float32)
            kw["lane_inv_temp"] = jnp.asarray(pkw["lane_inv_temp"])
    for _ in range(2):
        jc, jl, js = JG.stream_chunk(jp, jarch, js, 24, temperature=0.9, engine="turbo",
                                     return_logits=True, **kw)
        pc, pl, ps = PG.stream_chunk(pp, parch, ps, 24, temperature=0.9, engine="turbo",
                                     return_logits=True, **pkw)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert ps.t == int(js.t) == 48


def test_chunked_streaming_equals_one_shot(pair):
    """Three chunks of 16 equal one 48-step one-shot call, bit for bit
    (default per-lane seeds, classes and logits)."""
    _, pp, _, parch = pair
    b = 4
    one_c, one_l = PG.generate_classes(pp, parch, 3, b, 48, engine="turbo",
                                       return_logits=True, device="cpu")
    s = PG.start_stream(parch, b, 3, engine="turbo", params=pp, device="cpu")
    parts_c, parts_l = [], []
    for _ in range(3):
        c, lg, s = PG.stream_chunk(pp, parch, s, 16, engine="turbo", return_logits=True)
        parts_c.append(c)
        parts_l.append(lg)
    assert torch.equal(torch.cat(parts_c, 1), one_c)
    assert torch.equal(torch.cat(parts_l, 1), one_l)


def test_reset_lanes_matches_jax(pair):
    """Chunk, reset half the lanes, chunk: classes and the whole turbo
    state (rings, embedding stack, h) equal JAX's after each chunk."""
    jp, pp, jarch, parch = pair
    b, chunk = 6, 12
    lane = _lane(b, 2, seed=9)
    js = JG.start_stream(jarch, b, jax.random.key(0), engine="turbo", params=jp)
    ps = PG.start_stream(parch, b, 0, engine="turbo", params=pp, device="cpu")
    for i in range(3):
        if i == 2:
            mask = np.array([True, False] * (b // 2))
            js = JG.reset_lanes(jp, jarch, js, jnp.asarray(mask), engine="turbo")
            ps = PG.reset_lanes(pp, parch, ps, mask, engine="turbo")
        jc, js = JG.stream_chunk(jp, jarch, js, chunk, temperature=1.0, engine="turbo",
                                 lane_seed=jnp.asarray(lane[0]), lane_t0=jnp.asarray(lane[1]))
        pc, ps = PG.stream_chunk(pp, parch, ps, chunk, temperature=1.0, engine="turbo",
                                 lane_seed=lane[0], lane_t0=lane[1])
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        for k in ("bufs", "e", "h"):
            np.testing.assert_allclose(ps.state[k].numpy(), np.asarray(js.state[k]),
                                       rtol=0, atol=ATOL, err_msg=k)


def test_turbo_greedy_equals_pallas_engine(pair):
    """turbo and the port's pallas engine share the split layer order and
    the input-conv order: greedy classes and teacher-forced logits equal."""
    _, pp, _, parch = pair
    b, n = 4, 40
    tg = PG.generate_classes(pp, parch, 0, b, n, engine="turbo", temperature=0.0,
                             device="cpu")
    pg = PG.generate_classes(pp, parch, 0, b, n, engine="pallas", temperature=0.0,
                             device="cpu")
    assert torch.equal(tg, pg)
    forced = np.random.default_rng(2).integers(0, 256, (b, n)).astype(np.int32)
    _, tl = PG.generate_classes(pp, parch, 0, b, n, engine="turbo", forced=forced,
                                return_logits=True, device="cpu")
    _, pl = PG.generate_classes(pp, parch, 0, b, n, engine="pallas", forced=forced,
                                return_logits=True, device="cpu")
    torch.testing.assert_close(tl, pl, rtol=0, atol=1e-6)


def test_session_pool_turbo_at_batch_three(pair):
    """SessionPool(engine="turbo") at batch 3 (no lane padding): five
    requests with seeds and temperatures, two on recycled lanes, equal the
    same pool on the xla engine (the same per-lane hash and layer order), and
    a sampled request replays bit-identically alone."""
    from lb_wavenet_tpu_torch.serving import SessionPool

    _, pp, _, parch = pair
    assert PG.stream_lane_multiple("turbo") == 1

    def serve(engine, batch, reqs):
        pool = SessionPool(pp, parch, batch, 0, engine=engine, chunk_size=8,
                           temperature=1.0, pipeline=True, device="cpu")
        assert pool._device_batch == batch
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

    reqs = [("a", 20, 1, 0.0), ("b", 13, 2, 0.7), ("c", 30, 3, 1.0), ("d", 9, 4, 1.0),
            ("e", 17, 5, 0.0)]
    turbo = serve("turbo", 3, reqs)
    assert {k: len(v) for k, v in turbo.items()} == {r[0]: r[1] for r in reqs}
    xla = serve("xla", 3, reqs)
    for r in reqs:
        np.testing.assert_array_equal(turbo[r[0]], xla[r[0]], err_msg=r[0])
    alone = serve("turbo", 1, [reqs[3]])
    np.testing.assert_array_equal(alone["d"], turbo["d"])


def test_cli_serve_and_generate_with_turbo(pair, tmp_path, capsys):
    """`serve` and `generate` (one-shot and streamed) with
    --set gen.engine=turbo: serve's wavs equal a turbo pool's classes, and
    streamed generate equals one-shot."""
    import json
    import os

    from scipy.io import wavfile

    from lb_wavenet_tpu_torch import cli
    from lb_wavenet_tpu_torch.ops.mulaw import mu_law_decode
    from lb_wavenet_tpu_torch.serving import SessionPool
    from lb_wavenet_tpu_torch.utils.checkpoint import save_params

    _, pp, _, parch = pair
    save_params(str(tmp_path / "ckpt"), pp, 0)
    cfg = tmp_path / "arch.json"
    cfg.write_text(json.dumps({"arch": dataclasses.asdict(parch)}))
    common = ["--config", str(cfg), "--device", "cpu", "--set", 'gen.engine="turbo"',
              "--set", f"gen.checkpoint_dir={tmp_path / 'ckpt'}", "--set", "gen.batch_size=3"]
    req = tmp_path / "req.jsonl"
    req.write_text("".join(json.dumps({"id": f"q{i}", "n_samples": 10 + 7 * i, "seed": i})
                           + "\n" for i in range(4)))
    assert cli.main(["serve", *common, "--requests", str(req), "--stream-chunk", "8",
                     "--set", f"gen.out_dir={tmp_path / 'wav'}"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["served"] == 4 and summary["engine"] == "turbo"
    pool = SessionPool(pp, parch, 3, 0, engine="turbo", chunk_size=8, temperature=1.0,
                       pipeline=True, device="cpu")
    out, parts, queue = {}, {}, [(f"q{i}", 10 + 7 * i, i) for i in range(4)]
    while pool.active or queue:
        while queue and pool.submit(queue[0][0], queue[0][1], seed=queue[0][2]):
            parts[queue.pop(0)[0]] = []
        for rid, (cls, done) in pool.step().items():
            parts[rid].append(cls)
            if done:
                out[rid] = np.concatenate(parts.pop(rid))
    for rid, cls in out.items():
        _, wav = wavfile.read(os.path.join(tmp_path / "wav", f"{rid}.wav"))
        ref = mu_law_decode(torch.from_numpy(cls)).numpy()
        np.testing.assert_array_equal(wav, (np.clip(ref, -1, 1) * 32767.0).astype(np.int16))
    wavs = []
    for extra in ([], ["--stream-chunk", "8"]):
        d = tmp_path / f"gen{len(extra)}"
        assert cli.main(["generate", *common, *extra, "--set", "gen.n_samples=20",
                         "--set", f"gen.out_dir={d}"]) == 0
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["generated"] == 3
        wavs.append([wavfile.read(os.path.join(d, f"gen_{i:04d}.wav"))[1] for i in range(3)])
    for a, b in zip(*wavs):
        np.testing.assert_array_equal(a, b)
