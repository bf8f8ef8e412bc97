"""Port tests: mel (local) and speaker (global) conditioning against the JAX
package on the CPU: the teacher-forced forward, every engine (xla, pallas,
turbo, mega; B7 one step), conditioned SessionPool requests, the CLI's
`generate --mel` and mel request lines, and the raises that remain.
Engines whose JAX version reaches a Pallas kernel run it in interpret mode,
as the JAX package's own tests do."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu import generate as JG
from lb_wavenet_tpu.config import ArchConfig
from lb_wavenet_tpu.models.conditioning import upsample_cond as jupsample
from lb_wavenet_tpu.models.wavenet import forward as jforward
from lb_wavenet_tpu.models.wavenet import init_params as jinit
from lb_wavenet_tpu.ops.pallas.ar_tp import tp_fused_stack as jtp
from lb_wavenet_tpu.serving import SessionPool as JPool
from lb_wavenet_tpu_torch import generate as PG
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.models.wavenet import forward as pforward
from lb_wavenet_tpu_torch.ops.cuda import ar_tc
from lb_wavenet_tpu_torch.ops.cuda import ar_tp as PTP
from lb_wavenet_tpu_torch.serving import SessionPool as PPool
from lb_wavenet_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
COND = ArchConfig(n_blocks=2, n_layers_per_block=3, residual_channels=8, skip_channels=8,
                  gate_channels=8, n_mels=8, cond_channels=8, upsample_factors=(4,),
                  n_speakers=4, speaker_embed_dim=6, compute_dtype="float32")
# Widths the tensor-core kernels take: C = G = 16, S = 32, Cc = 16, E = 16.
TC = ArchConfig(n_blocks=2, n_layers_per_block=4, residual_channels=16, skip_channels=32,
                gate_channels=16, n_mels=8, cond_channels=16, upsample_factors=(4,),
                n_speakers=4, speaker_embed_dim=16, compute_dtype="bfloat16")
ATOL = 1e-4      # fp32: the same products summed in another order, over the run
BF16_ATOL = 2e-2  # bf16 operands: a flipped rounding moves logits ~1e-2
B, T = 4, 24
MODES = ["mel", "speaker", "both"]
ENGINES = ["xla", "pallas", "turbo", "mega"]


def _parch(arch):
    return PArch(**dataclasses.asdict(arch))


def _pair(arch, seed=0):
    jp = jinit(jax.random.key(seed), arch)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp)), _parch(arch)


@pytest.fixture(scope="module")
def pair():
    return _pair(COND)


def _inputs(jp, arch, mode, b=B, t=T, seed=1):
    """(jax kwargs, port kwargs) of a mode: the upsampled cond of random
    frames (JAX's upsampler, handed to both) and/or speaker ids."""
    rng = np.random.default_rng(seed)
    jkw, pkw = {}, {}
    if mode in ("mel", "both"):
        frames = rng.standard_normal((b, -(-t // arch.hop_size), arch.n_mels))
        cond = np.asarray(jupsample(jp["upsampler"], arch, jnp.asarray(frames, jnp.float32),
                                    jnp.dtype(arch.compute_dtype)).astype(jnp.float32))
        jkw["cond"] = jnp.asarray(cond, arch.compute_dtype)
        pkw["cond"] = torch.from_numpy(cond.copy())
    if mode in ("speaker", "both"):
        ids = rng.integers(0, arch.n_speakers, b)
        jkw["speaker_ids"], pkw["speaker_ids"] = jnp.asarray(ids), torch.from_numpy(ids)
    return jkw, pkw


# ---------------------------------------------------------------------------
# The teacher-forced forward.

@pytest.mark.parametrize("mode", ["frames", "cond", "speaker", "both"])
@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", BF16_ATOL)])
def test_forward_conditioned_matches_jax(mode, dtype, atol):
    arch = dataclasses.replace(COND, compute_dtype=dtype)
    jp, pp, parch = _pair(arch, seed=2)
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (B, T)).astype(np.int32)
    frames = rng.standard_normal((B, T // arch.hop_size + 1, arch.n_mels)).astype(np.float32)
    ids = rng.integers(0, arch.n_speakers, B)
    jkw, pkw = {}, {}
    if mode in ("frames", "both"):
        jkw["cond_frames"], pkw["cond_frames"] = jnp.asarray(frames), torch.from_numpy(frames)
    if mode == "cond":
        cond = np.asarray(jupsample(jp["upsampler"], arch, jnp.asarray(frames),
                                    jnp.float32))[:, :T]
        jkw["cond"], pkw["cond"] = jnp.asarray(cond), torch.from_numpy(cond.copy())
    if mode in ("speaker", "both"):
        jkw["speaker_ids"], pkw["speaker_ids"] = jnp.asarray(ids), torch.from_numpy(ids)
    want = np.asarray(jforward(jp, arch, jnp.asarray(x), **jkw))
    got = pforward(pp, parch, torch.from_numpy(x), **pkw)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=atol)
    plain = pforward(pp, parch, torch.from_numpy(x))
    assert float((got - plain).abs().max()) > 10 * atol   # the conditioning acts


def test_forward_refuses_cond_and_cond_frames(pair):
    _, pp, parch = pair
    x = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="not both"):
        pforward(pp, parch, x, cond_frames=torch.zeros((1, 2, 8)), cond=torch.zeros((1, 8, 8)))


# ---------------------------------------------------------------------------
# Every engine.

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
def test_engine_teacher_forced_matches_jax(pair, engine, mode):
    """Teacher-forced logits (the cond row of step t at step t) and
    classes equal JAX's, its Pallas kernels in interpret mode."""
    jp, pp, parch = pair
    jkw, pkw = _inputs(jp, COND, mode)
    forced = np.random.default_rng(4).integers(0, 256, (B, T)).astype(np.int32)
    jc, jl = JG.generate_classes(jp, COND, jax.random.key(0), B, T, forced=jnp.asarray(forced),
                                 return_logits=True, engine=engine, **jkw)
    pc, pl = PG.generate_classes(pp, parch, 0, B, T, forced=forced, return_logits=True,
                                 engine=engine, device="cpu", **pkw)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
def test_engine_greedy_matches_jax(pair, engine, mode):
    jp, pp, parch = pair
    jkw, pkw = _inputs(jp, COND, mode, seed=5)
    jc = JG.generate_classes(jp, COND, jax.random.key(0), B, 16, temperature=0.0,
                             engine=engine, **jkw)
    pc = PG.generate_classes(pp, parch, 0, B, 16, temperature=0.0, engine=engine,
                             device="cpu", **pkw)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


LANE_SEED = np.array([11, 2**31 - 5, 7, 123456] * 2, np.int32)   # 8 lanes: mega's tile
LANE_T0 = np.array([0, -3, 2, 5, 1, 0, -7, 4], np.int32)
LANE_INV = np.array([1.0 / 0.8, 0.0, 1.0, 2.0] * 2, np.float32)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
def test_per_lane_sampled_classes_equal_jax(pair, engine, mode):
    """Sampled from the per-lane hash with explicit seeds, lease times and
    inverse temperatures: the classes equal JAX's, chunk after chunk."""
    jp, pp, parch = pair
    b = len(LANE_SEED)
    jkw, pkw = _inputs(jp, COND, mode, b=b, seed=6)
    js = JG.start_stream(COND, b, jax.random.key(2), engine=engine, params=jp)
    ps = PG.start_stream(parch, b, 2, engine=engine, params=pp, device="cpu")
    lane = dict(lane_seed=LANE_SEED, lane_t0=LANE_T0, lane_inv_temp=LANE_INV)
    for c in range(2):
        sl = slice(c * T // 2, (c + 1) * T // 2)
        jc, js = JG.stream_chunk(jp, COND, js, T // 2, temperature=1.0, engine=engine,
                                 **{k: v[:, sl] if k == "cond" else v for k, v in jkw.items()},
                                 **{k: jnp.asarray(v) for k, v in lane.items()})
        pc, ps = PG.stream_chunk(pp, parch, ps, T // 2, temperature=1.0, engine=engine,
                                 **{k: v[:, sl] if k == "cond" else v for k, v in pkw.items()},
                                 **lane)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc), err_msg=f"chunk {c}")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
def test_streaming_equals_one_shot(pair, engine, mode):
    """Chunks that take their span of the cond continue the one-shot run
    bit for bit (the chunk reads cond at its local step, the ring and the
    sampling counters at the absolute one)."""
    jp, pp, parch = pair
    _, pkw = _inputs(jp, COND, mode, b=8, seed=7)
    one = PG.generate_classes(pp, parch, 9, 8, T, engine=engine, device="cpu", **pkw)
    stream = PG.start_stream(parch, 8, 9, engine=engine, params=pp, device="cpu")
    parts = []
    for c in range(3):
        sl = slice(c * T // 3, (c + 1) * T // 3)
        cls, stream = PG.stream_chunk(pp, parch, stream, T // 3, engine=engine,
                                      **{k: v[:, sl] if k == "cond" else v
                                         for k, v in pkw.items()})
        parts.append(cls)
    assert torch.equal(torch.cat(parts, 1), one)


def test_stream_chunk_cond_covers_exactly_the_chunk(pair):
    _, pp, parch = pair
    stream = PG.start_stream(parch, 2, 0, engine="xla", device="cpu")
    with pytest.raises(ValueError, match="cond must be"):
        PG.stream_chunk(pp, parch, stream, 4, cond=torch.zeros((2, 8, 8)))


@pytest.mark.parametrize("engine", ["pallas", "turbo", "mega"])
@pytest.mark.parametrize("mode", ["mel", "both"])
def test_tensor_core_order_matches_jax(monkeypatch, engine, mode):
    """bf16 at widths the tensor-core kernels take (Cc' = 16, or 32 with the
    speaker rows folded in): the plain versions summed as the kernels sum
    on the card (cond's k-steps in the gate's chain; float64 emulation of
    the tensor core) against JAX within BF16_ATOL, the same bf16-rounded
    operands with fp32 sums in another order."""
    jp, pp, parch = _pair(TC, seed=3)
    monkeypatch.setattr(ar_tc, "default_order", lambda arch, dt, device, cc=0: ar_tc.route(
        arch, dt, cc) == "tensor_cores")
    monkeypatch.setattr(ar_tc, "stack_default_order",
                        lambda c, g, s, n, dt, device, cc=0: ar_tc.stack_route(
                            c, g, s, n, dt, cc) == "tensor_cores")
    cc = TC.cond_channels + (TC.speaker_embed_dim if mode == "both" else 0)
    assert ar_tc.route(parch, torch.bfloat16, cc) == "tensor_cores"
    jkw, pkw = _inputs(jp, TC, mode, b=8, t=16, seed=8)
    forced = np.random.default_rng(9).integers(0, 256, (8, 16)).astype(np.int32)
    _, jl = JG.generate_classes(jp, TC, jax.random.key(0), 8, 16, forced=jnp.asarray(forced),
                                return_logits=True, engine=engine, **jkw)
    _, pl = PG.generate_classes(pp, parch, 0, 8, 16, forced=forced, return_logits=True,
                                engine=engine, device="cpu", **pkw)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl, np.float32), rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("arch,atol,tc", [(COND, 1e-5, False), (TC, BF16_ATOL, True)],
                         ids=["fp32", "bf16_tensor_core_order"])
@pytest.mark.parametrize("mode", ["mel", "both"])
def test_tp_fused_stack_conditioned_matches_jax(arch, atol, tc, mode):
    """B7 one step with the folded cond (Cc', B) on the skip slice of the
    last model rank of two: ring and local skip sum against JAX's TP kernel
    (interpret mode)."""
    jp, pp, parch = _pair(arch, seed=4)
    s_l = arch.skip_channels // 2
    sl = slice(arch.skip_channels - s_l, arch.skip_channels)
    jlp, plp = dict(jp["layers"]), dict(pp["layers"])
    jlp["w_skip"], jlp["b_skip"] = jlp["w_skip"][..., sl], jlp["b_skip"][..., sl]
    plp["w_skip"], plp["b_skip"] = plp["w_skip"][..., sl], plp["b_skip"][..., sl]
    b, c, t = 6, arch.residual_channels, 321
    rng = np.random.default_rng(5)
    bufs = rng.standard_normal((sum(arch.dilations), c, b)).astype(np.float32)
    h0 = rng.standard_normal((c, b)).astype(np.float32)
    cond = rng.standard_normal((b, arch.cond_channels)).astype(np.float32)
    gcond = None
    if mode == "both":
        ids = rng.integers(0, arch.n_speakers, b)
        gcond = (jp["speaker_embed"][ids], pp["speaker_embed"][torch.from_numpy(ids)])
    jcond = jnp.asarray(cond)
    if gcond is not None:   # JAX's step fold ([cond | speaker row], [w_cond ; w_gcond])
        jcond = jnp.concatenate([jcond, gcond[0]], -1)
        jlp["w_cond"] = jnp.concatenate([jlp["w_cond"], jlp["w_gcond"]], 1)
    plp, pcond = PG._fold_gcond(plp, torch.from_numpy(cond), None if gcond is None
                                else gcond[1])
    slots = np.asarray(PG.buffer_offsets(parch)) + t % np.asarray(arch.dilations)
    jfm = JG._tp_weights(jp, jlp, True)
    jb, js = jtp(jfm, arch, jnp.asarray(h0), jnp.asarray(bufs), jnp.asarray(slots, jnp.int32),
                 cond_t=jnp.swapaxes(jcond, 0, 1), interpret=True)
    pfm = PG._tp_weights(pp, plp, torch.float32 if arch.compute_dtype == "float32"
                         else torch.bfloat16)
    assert "wcond" in pfm
    pb, ps = PTP.tp_fused_stack_plain(pfm, parch, torch.from_numpy(h0),
                                      torch.from_numpy(bufs.copy()), t, tensor_cores=tc,
                                      cond_t=pcond.t())
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=atol)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=atol)
    with pytest.raises(ValueError, match="wcond"):
        PTP.tp_fused_stack(pfm, parch, torch.from_numpy(h0), torch.from_numpy(bufs), t)


def test_folded_weights_are_made_once_per_weight_set(pair):
    """_fold_gcond builds [w_cond ; w_gcond] once per weight set, so the
    kernels' packed stream (keyed on it) stays cached from chunk to chunk;
    writing a source weight makes it again."""
    _, pp, _ = pair
    g = torch.zeros((3, COND.speaker_embed_dim))
    c = torch.zeros((5, 3, COND.cond_channels))
    lp1, c1 = PG._fold_gcond(pp["layers"], c, g, 5)
    lp2, _ = PG._fold_gcond(pp["layers"], c, g, 5)
    assert lp1["w_cond"] is lp2["w_cond"]
    assert lp1["w_cond"].shape == (6, COND.cond_channels + COND.speaker_embed_dim, 16)
    assert c1.shape == (5, 3, COND.cond_channels + COND.speaker_embed_dim)
    lp3, c3 = PG._fold_gcond(pp["layers"], None, g, 5)
    assert lp3["w_cond"] is pp["layers"]["w_gcond"] and c3.shape == (5, 3, 6)
    w = {**pp["layers"], "w_gcond": pp["layers"]["w_gcond"].clone()}
    before = PG._fold_gcond(w, c, g, 5)[0]["w_cond"]
    w["w_gcond"].add_(1.0)
    assert PG._fold_gcond(w, c, g, 5)[0]["w_cond"] is not before


def test_generate_upsamples_cond_frames(pair):
    jp, pp, parch = pair
    frames = np.random.default_rng(10).standard_normal((2, 5, 8)).astype(np.float32)
    jw = JG.generate(jp, COND, jax.random.key(0), 2, 16, cond_frames=jnp.asarray(frames),
                     temperature=0.0, engine="mega")
    pw = PG.generate(pp, parch, 0, 2, 16, cond_frames=frames, temperature=0.0, engine="mega",
                     device="cpu")
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))


# ---------------------------------------------------------------------------
# SessionPool with cond_fn and speakers.

def _cond_requests(jp, n_req=5, seed=11):
    """(id, n_samples, seed, temperature, speaker, cond (n, Cc)) requests;
    more than the pool's lanes, so later ones take recycled lanes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_req):
        n = int(rng.integers(9, 22))
        frames = rng.standard_normal((1, -(-n // COND.hop_size), COND.n_mels))
        cond = np.asarray(jupsample(jp["upsampler"], COND, jnp.asarray(frames, jnp.float32),
                                    jnp.float32))[0, :n]
        out.append((f"r{i}", n, 40 + i, (0.0, 0.7, 1.0)[i % 3], i % COND.n_speakers, cond))
    return out


def _serve_cond(pool, requests):
    out, parts, queue = {}, {}, list(requests)

    def fill():
        while queue:
            rid, n, seed, temp, spk, cond = queue[0]
            if not pool.submit(rid, n, speaker=spk, seed=seed, temperature=temp,
                               cond_fn=lambda t0, k, c=cond: c[t0: t0 + k]):
                return
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


@pytest.mark.parametrize("engine,pipeline", [("mega", True), ("turbo", False),
                                             ("xla", False)])
def test_pool_with_cond_and_speakers_matches_jax(pair, engine, pipeline):
    """Mel + speaker requests with seeds and temperatures through both
    frameworks' pools (per-lane hash, recycled lanes): equal classes. The
    cond_fn is asked only for the steps a request consumes."""
    jp, pp, parch = pair
    reqs = _cond_requests(jp)
    kw = dict(engine=engine, chunk_size=8, temperature=1.0, pipeline=pipeline)
    j = _serve_cond(JPool(jp, COND, 3, jax.random.key(1), **kw), reqs)
    pool = PPool(pp, parch, 3, 1, device="cpu", **kw)
    p = _serve_cond(pool, reqs)
    assert sorted(p) == sorted(j) == sorted(r[0] for r in reqs)
    for r in reqs:
        np.testing.assert_array_equal(p[r[0]], j[r[0]], err_msg=r[0])
    assert pool.stats["cond_s"] > 0.0


def test_pool_cond_checks_match_jax(pair):
    """cond_fn exactly when the arch is mel-conditioned; a speaker only on
    an arch with speakers; a cond_fn span of the wrong shape raises."""
    jp, pp, parch = pair
    pool = PPool(pp, parch, 2, 0, engine="mega", chunk_size=8, device="cpu")
    with pytest.raises(ValueError, match="cond_fn"):
        pool.submit("x", 4)
    assert pool.submit("y", 4, cond_fn=lambda t0, n: np.zeros((n + 1, 8), np.float32))
    with pytest.raises(ValueError, match="cond_fn returned"):
        pool.step()
    speakerless = dataclasses.replace(parch, n_speakers=0)
    pp2 = {k: v for k, v in pp.items() if k != "speaker_embed"}
    pool = PPool(pp2, speakerless, 1, 0, engine="mega", chunk_size=8, device="cpu")
    with pytest.raises(ValueError, match="n_speakers"):
        pool.submit("z", 4, speaker=1, cond_fn=lambda t0, n: np.zeros((n, 8), np.float32))


# ---------------------------------------------------------------------------
# The CLI.

def _cli_setup(tmp_path, pp, parch):
    from lb_wavenet_tpu_torch.utils.checkpoint import save_params

    save_params(str(tmp_path / "ckpt"), pp, 0)
    cfg = tmp_path / "arch.json"
    cfg.write_text(json.dumps({"arch": dataclasses.asdict(parch)}))
    return ["--config", str(cfg), "--device", "cpu",
            "--set", f"gen.checkpoint_dir={tmp_path / 'ckpt'}"]


def test_cli_generate_mel_one_shot_and_streamed(pair, tmp_path, capsys):
    """`generate --mel` equals the in-process conditioned generate, one-shot
    and streamed through the StreamingUpsampler (--stream-chunk); with
    --speakers too."""
    from scipy.io import wavfile

    from lb_wavenet_tpu_torch import cli

    _, pp, parch = pair
    common = _cli_setup(tmp_path, pp, parch)
    frames = np.random.default_rng(12).standard_normal((3, 9, 8)).astype(np.float32)
    np.save(tmp_path / "mel.npy", frames)
    ref = PG.generate(pp, parch, 4, 3, 30, cond_frames=frames, speaker_ids=[1, 3, 0],
                      temperature=1.0, engine="mega", device="cpu").numpy()
    for name, extra in (("one", []), ("stream", ["--stream-chunk", "8"])):
        rc = cli.main(["generate", *common, "--mel", str(tmp_path / "mel.npy"),
                       "--speakers", "1,3,0", *extra, "--set", "gen.batch_size=3",
                       "--set", "gen.n_samples=30", "--set", "gen.engine=mega",
                       "--set", "gen.seed=4", "--set", f"gen.out_dir={tmp_path / name}"])
        assert rc == 0
        for i in range(3):
            _, wav = wavfile.read(tmp_path / name / f"gen_{i:04d}.wav")
            np.testing.assert_array_equal(
                wav, (np.clip(ref[i], -1, 1) * 32767.0).astype(np.int16), err_msg=name)
    capsys.readouterr()
    with pytest.raises(SystemExit, match="--mel"):
        cli.main(["generate", *common])


def test_cli_serve_mel_and_speaker_requests(pair, tmp_path, capsys):
    """`serve --requests` lines with "mel" and "speaker" write the pool's
    audio: the frames upsampled once per request (zero-padded to a multiple
    of 32 frames, as the JAX CLI pads them)."""
    from scipy.io import wavfile

    from lb_wavenet_tpu_torch import cli
    from lb_wavenet_tpu_torch.models.conditioning import upsample_cond
    from lb_wavenet_tpu_torch.ops.mulaw import mu_law_decode

    _, pp, parch = pair
    common = _cli_setup(tmp_path, pp, parch)
    rng = np.random.default_rng(13)
    lines, reqs = [], []
    for i, n in enumerate((20, 13, 30)):
        frames = rng.standard_normal((-(-n // parch.hop_size) + 1, 8)).astype(np.float32)
        np.save(tmp_path / f"m{i}.npy", frames)
        lines.append(json.dumps({"id": f"q{i}", "n_samples": n, "seed": 5 + i,
                                 "temperature": 1.0, "mel": str(tmp_path / f"m{i}.npy"),
                                 "speaker": i}) + "\n")
        padded = np.zeros((1, 32, 8), np.float32)
        padded[0, : len(frames)] = frames
        cond = upsample_cond(pp["upsampler"], parch, torch.from_numpy(padded),
                             torch.float32)[0, :n].numpy()
        reqs.append((f"q{i}", n, 5 + i, 1.0, i, cond))
    (tmp_path / "req.jsonl").write_text("".join(lines))
    rc = cli.main(["serve", *common, "--requests", str(tmp_path / "req.jsonl"),
                   "--stream-chunk", "8", "--set", "gen.batch_size=2",
                   "--set", f"gen.out_dir={tmp_path / 'wav'}"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["served"] == 3 and "cond" in summary["phase_ms_per_step"]
    want = _serve_cond(PPool(pp, parch, 2, 0, engine="mega", chunk_size=8, temperature=1.0,
                             pipeline=True, device="cpu"), reqs)
    for rid, cls in want.items():
        _, wav = wavfile.read(tmp_path / "wav" / f"{rid}.wav")
        ref = mu_law_decode(torch.from_numpy(cls)).numpy()
        np.testing.assert_array_equal(wav, (np.clip(ref, -1, 1) * 32767.0).astype(np.int16))
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"id": "x", "n_samples": 4}) + "\n")
    with pytest.raises(SystemExit, match="mel"):
        cli.main(["serve", *common, "--requests", str(bad)])


# ---------------------------------------------------------------------------
# What stays raising, and the import guard.

def test_conditioned_training_raises_naming_its_roadmap_item(pair):
    from lb_wavenet_tpu_torch import data as PD
    from lb_wavenet_tpu_torch import eval as PE
    from lb_wavenet_tpu_torch.config import TrainConfig
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS
    from lb_wavenet_tpu_torch.train import forward_fused

    _, pp, parch = pair
    corpus = PD.synthetic_corpus(parch, 16, n_files=1, file_len=200)
    with pytest.raises(NotImplementedError, match="A queue item 4b"):
        next(PD.make_batches(corpus, TrainConfig(batch_size=2, window_size=16), with_mel=True))
    with pytest.raises(NotImplementedError, match="A queue item 4b"):
        next(PE.eval_batches(corpus, 2))
    with pytest.raises(NotImplementedError, match="A queue item 4b"):
        TS.make_fused_stack(parch, has_cond=True)
    with pytest.raises(NotImplementedError, match="A queue item 4b"):
        forward_fused(pp, parch, torch.zeros((1, 8), dtype=torch.int32),
                      speaker_ids=torch.zeros(1, dtype=torch.long))


def test_import_guard_covers_the_new_modules():
    from .test_torch_config import _port_sources

    names = {p.replace("\\", "/").split("lb_wavenet_tpu_torch/")[-1] for p in _port_sources()}
    assert {"ops/mel.py", "models/conditioning.py"} <= names
