"""Port tests: serving artifacts (utils/export.py) and SessionPool over them.
The port's counterparts of tests/test_export.py: save -> load -> step
equals the in-process streaming session bit for bit (the programs call the
kernels' custom ops, whose CPU registrations are the plain versions), plus
a JAX per-lane artifact against the port's and an artifact served by a
fresh process that imports no model code."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu_torch.config import ArchConfig
from lb_wavenet_tpu_torch.generate import start_stream, stream_chunk
from lb_wavenet_tpu_torch.models.wavenet import init_params
from lb_wavenet_tpu_torch.serving import SessionPool
from lb_wavenet_tpu_torch.utils.export import (
    ServingArtifact, export_serving, export_sharded_serving, load_serving,
)

from . import torch_export_ranks as R

torch.set_num_threads(1)
ARCH = ArchConfig(n_blocks=2, n_layers_per_block=3, residual_channels=8, skip_channels=8,
                  gate_channels=8, compute_dtype="float32")
MEL_ARCH = ArchConfig(n_blocks=1, n_layers_per_block=3, residual_channels=8,
                      skip_channels=8, gate_channels=8, n_mels=6, cond_channels=4,
                      upsample_factors=(2, 4), compute_dtype="float32")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(engine):
    return 8 if engine == "mega" else 2


def _reference_chunks(params, arch, batch, chunk, n_chunks, engine, seed, cond_full=None,
                      temperature=1.0):
    stream = start_stream(arch, batch, seed, engine=engine, params=params, device="cpu")
    out = []
    for i in range(n_chunks):
        cond = None if cond_full is None else cond_full[:, i * chunk: (i + 1) * chunk]
        classes, stream = stream_chunk(params, arch, stream, chunk, cond=cond,
                                       engine=engine, temperature=temperature)
        out.append(classes)
    return torch.cat(out, 1)


@pytest.mark.parametrize("engine", ["xla", "pallas", "turbo", "mega"])
def test_export_roundtrip_bitmatch(tmp_path, engine):
    batch, chunk, n_chunks = _batch(engine), 16, 3
    params = init_params(0, ARCH)
    out_dir = str(tmp_path / f"artifact_{engine}")
    manifest = export_serving(params, ARCH, batch, chunk, out_dir, engine=engine,
                              temperature=1.0)
    assert manifest["engine"] == engine and manifest["device"] == "cpu"
    assert os.path.exists(os.path.join(out_dir, "manifest.json"))
    art = load_serving(out_dir)
    assert isinstance(art, ServingArtifact) and art.arch == ARCH
    state = art.init(params, seed=7)
    got = []
    for _ in range(n_chunks):
        classes, state = art.step(params, state)
        got.append(classes)
    want = _reference_chunks(params, ARCH, batch, chunk, n_chunks, engine, 7)
    assert torch.equal(torch.cat(got, 1), want)
    assert int(state["t"]) == n_chunks * chunk


@pytest.mark.parametrize("engine", ["xla", "mega"])
def test_export_with_cond(tmp_path, engine):
    """Mel-conditioned artifact: the chunk's cond threads through (a
    per-step program takes it one row at a time)."""
    from lb_wavenet_tpu_torch.models.conditioning import upsample_cond

    batch, chunk, n_chunks = _batch(engine), 16, 2
    params = init_params(1, MEL_ARCH)
    g = torch.Generator().manual_seed(2)
    frames = torch.randn((batch, n_chunks * chunk // MEL_ARCH.hop_size + 2, MEL_ARCH.n_mels),
                         generator=g)
    cond_full = upsample_cond(params["upsampler"], MEL_ARCH, frames, torch.float32)
    out_dir = str(tmp_path / "artifact_mel")
    export_serving(params, MEL_ARCH, batch, chunk, out_dir, engine=engine, with_cond=True)
    art = load_serving(out_dir)
    state = art.init(params, seed=3)
    got = []
    for i in range(n_chunks):
        classes, state = art.step(params, state, cond=cond_full[:, i * chunk: (i + 1) * chunk])
        got.append(classes)
    want = _reference_chunks(params, MEL_ARCH, batch, chunk, n_chunks, engine, 3,
                             cond_full=cond_full)
    assert torch.equal(torch.cat(got, 1), want)
    with pytest.raises(ValueError, match="with_cond"):
        art.step(params, state)


def test_export_manifest_and_errors(tmp_path):
    params = init_params(0, ARCH)
    out_dir = str(tmp_path / "artifact")
    export_serving(params, ARCH, 2, 8, out_dir, engine="xla")
    with open(os.path.join(out_dir, "manifest.json")) as f:
        m = json.load(f)
    assert m["batch"] == 2 and m["chunk_size"] == 8
    assert m["arch"]["n_blocks"] == ARCH.n_blocks
    assert m["torch_version"] == torch.__version__ and m["device_kind"] == "cpu"
    assert "cuda_version" in m and "jax_version" not in m
    with pytest.raises(ValueError, match="engines"):
        export_serving(params, ARCH, 2, 8, out_dir, engine="warp")
    with pytest.raises(ValueError, match="multiples of 8"):
        export_serving(params, ARCH, 4, 8, out_dir, engine="mega")
    # Integrity guard: a mixed-generation / corrupted program is rejected.
    with open(os.path.join(out_dir, "step.pt2"), "ab") as f:
        f.write(b"garbage")
    with pytest.raises(ValueError, match="manifest hash"):
        load_serving(out_dir)
    export_serving(params, ARCH, 2, 8, out_dir, engine="xla")   # re-export
    load_serving(out_dir)
    # Another torch version is refused like a hash mismatch.
    m2 = dict(m, torch_version="0.0.1")
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(m2, f)
    with pytest.raises(ValueError, match="torch 0.0.1"):
        load_serving(out_dir)
    m3 = dict(m, artifact_version=999)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(m3, f)
    with pytest.raises(ValueError, match="version"):
        load_serving(out_dir)


@pytest.mark.parametrize("engine", ["xla", "mega"])
def test_export_reset_lanes_bitmatch(tmp_path, engine):
    """Artifact `reset` == in-process reset_lanes: recycle lane 1 mid-
    session; its greedy output afterwards equals a fresh session's, and the
    kept lane is untouched."""
    batch, chunk = _batch(engine), 16
    params = init_params(0, ARCH)
    out_dir = str(tmp_path / f"art_reset_{engine}")
    export_serving(params, ARCH, batch, chunk, out_dir, engine=engine, temperature=0.0)
    art = load_serving(out_dir)
    mask = np.zeros(batch, bool)
    mask[1] = True

    def run(n_chunks, reset_after=None):
        state = art.init(params, seed=7)
        outs = []
        for i in range(n_chunks):
            classes, state = art.step(params, state)
            outs.append(classes)
            if reset_after is not None and i == reset_after:
                state = art.reset(params, state, mask)
        return torch.cat(outs, 1)

    out, control, fresh = run(4, reset_after=1), run(4), run(2)
    post = out[:, 2 * chunk:]
    assert torch.equal(post[1], fresh[1])                       # recycled
    assert torch.equal(post[0], control[:, 2 * chunk:][0])      # kept
    assert not torch.equal(control[:, 2 * chunk:][1], fresh[1])


def test_export_sharded_roundtrip_bitmatch(tmp_path):
    """Model-sharded artifact on two gloo ranks (1 x 2 mesh): the exported
    pre/post halves around the rank's all-reduce reproduce the in-process
    ShardedSession chunk for chunk, including a mid-stream lane reset."""
    params = init_params(0, ARCH)
    art_dir = str(tmp_path / "sharded")
    manifest = export_sharded_serving(params, ARCH, R.B, R.CHUNK, art_dir, engine="turbo",
                                      temperature=1.0, mesh_data=1, mesh_model=2)
    assert manifest["sharded"] and manifest["mesh_model"] == 2
    torch.multiprocessing.spawn(
        R.run_rank, args=(2, str(tmp_path / "store"), art_dir, params,
                          dataclasses.asdict(ARCH), str(tmp_path)),
        nprocs=2, join=True)
    for rank in range(2):
        res = torch.load(tmp_path / f"rank{rank}.pt")
        assert res["got"].shape == (R.B, R.N_CHUNKS * R.CHUNK)
        assert torch.equal(res["got"], res["want"])
    # One process without a group of the mesh's size is refused.
    with pytest.raises(ValueError, match="needs 2 ranks"):
        load_serving(art_dir)


def test_export_sharded_validation(tmp_path):
    params = init_params(0, ARCH)
    with pytest.raises(ValueError, match="turbo|mega"):
        export_sharded_serving(params, ARCH, 4, 16, str(tmp_path / "x"), engine="xla",
                               mesh_data=2, mesh_model=2)
    with pytest.raises(ValueError, match="skip_channels"):
        export_sharded_serving(params, ARCH, 4, 16, str(tmp_path / "x"), engine="mega",
                               mesh_data=1, mesh_model=3)
    with pytest.raises(ValueError, match="mesh_data"):
        export_sharded_serving(params, ARCH, 3, 16, str(tmp_path / "x"), engine="mega",
                               mesh_data=2, mesh_model=2)


REQS = [("a", 32, dict(seed=11)), ("b", 19, dict(seed=22, temperature=0.7)),
        ("c", 16, dict(seed=33, temperature=0.0)), ("d", 17, dict(seed=44))]


def _run_pool(pool, reqs=REQS):
    i, out = 0, {}
    while i < len(reqs) and pool.submit(reqs[i][0], reqs[i][1], **reqs[i][2]):
        i += 1
    while pool.active or i < len(reqs):
        for rid, (classes, done) in pool.step().items():
            out.setdefault(rid, []).append(classes)
        while i < len(reqs) and pool.submit(reqs[i][0], reqs[i][1], **reqs[i][2]):
            i += 1
    return {r: np.concatenate(v) for r, v in out.items()}


@pytest.mark.parametrize("engine", ["xla", "mega"])
def test_per_lane_artifact_pool_bitmatch(tmp_path, engine):
    """A SessionPool over a per-lane artifact == the in-process pool, bit
    for bit: per-request seeds, temperature, a greedy request and a
    recycled lane."""
    batch, chunk = (3, 16) if engine == "xla" else (8, 16)
    params = init_params(0, ARCH)
    out_dir = str(tmp_path / "artifact_pool")
    manifest = export_serving(params, ARCH, batch, chunk, out_dir, engine=engine,
                              temperature=1.0, per_lane=True)
    assert manifest["per_lane"] is True
    art = load_serving(out_dir)
    got = _run_pool(SessionPool(params, ARCH, batch, 5, artifact=art, temperature=1.0,
                                device="cpu"))
    want = _run_pool(SessionPool(params, ARCH, batch, 5, engine=engine, chunk_size=chunk,
                                 temperature=1.0, device="cpu"))
    assert set(got) == set(want) == {"a", "b", "c", "d"}
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_per_lane_artifact_pool_validation(tmp_path):
    params = init_params(0, ARCH)
    plain = str(tmp_path / "plain")
    export_serving(params, ARCH, 2, 16, plain, engine="xla")
    art = load_serving(plain)
    with pytest.raises(ValueError, match="per_lane artifact"):
        SessionPool(params, ARCH, 2, 3, artifact=art, device="cpu")
    with pytest.raises(ValueError, match="temperature > 0"):
        export_serving(params, ARCH, 2, 16, str(tmp_path / "x"), engine="xla",
                       temperature=0.0, per_lane=True)
    pl = str(tmp_path / "pl")
    export_serving(params, ARCH, 2, 16, pl, engine="xla", per_lane=True)
    art = load_serving(pl)
    with pytest.raises(ValueError, match="INT seed"):
        SessionPool(params, ARCH, 2, torch.Generator(), artifact=art, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        SessionPool(params, ARCH, 4, 3, artifact=art, device="cpu")
    with pytest.raises(ValueError, match="temperature > 0"):
        SessionPool(params, ARCH, 2, 3, artifact=art, temperature=0.0, device="cpu")
    with pytest.raises(ValueError, match="per_lane_rng"):
        SessionPool(params, ARCH, 2, 3, artifact=art, per_lane_rng=False, device="cpu")
    with pytest.raises(ValueError, match="lane"):
        art.step(params, art.init(params, 0))


def test_per_lane_artifact_pool_request_mode(tmp_path):
    """Artifact pools compose with deliver='request' (the device-side time
    ring is outside the export boundary)."""
    batch, chunk = 2, 16
    params = init_params(0, ARCH)
    out_dir = str(tmp_path / "art")
    export_serving(params, ARCH, batch, chunk, out_dir, engine="xla", temperature=1.0,
                   per_lane=True)
    art = load_serving(out_dir)

    def run(pool):
        for rid, n in (("a", 2 * chunk), ("b", chunk + 3)):
            assert pool.submit(rid, n, seed=len(rid) * 977 + ord(rid))
        out = {}
        while pool.active:
            for rid, (classes, done) in pool.step().items():
                assert done
                out[rid] = classes
        return out

    got = run(SessionPool(params, ARCH, batch, 9, artifact=art, temperature=1.0,
                          deliver="request", acc_samples=8 * chunk, device="cpu"))
    want = run(SessionPool(params, ARCH, batch, 9, engine="xla", chunk_size=chunk,
                           temperature=1.0, deliver="request", acc_samples=8 * chunk,
                           device="cpu"))
    assert set(got) == set(want) == {"a", "b"}
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_jax_and_port_per_lane_artifacts_agree(tmp_path):
    """A JAX per-lane artifact and the port's, from the same converted
    params, lane seeds, lease times and temperatures, give the same classes
    (the per-lane hash is bit-exact across the two frameworks); the two
    frameworks' teacher-forced logits agree within 1e-4."""
    from lb_wavenet_tpu.config import ArchConfig as JArch
    from lb_wavenet_tpu.generate import generate_classes as jgen
    from lb_wavenet_tpu.models.wavenet import init_params as jinit
    from lb_wavenet_tpu.utils.export import export_serving as jexport
    from lb_wavenet_tpu.utils.export import load_serving as jload
    from lb_wavenet_tpu_torch.generate import generate_classes as pgen
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    jarch = JArch(**dataclasses.asdict(ARCH))
    jp = jinit(jax.random.key(0), jarch)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    batch, chunk = 3, 16
    jexport(jp, jarch, batch, chunk, str(tmp_path / "jax"), engine="xla", temperature=1.0,
            per_lane=True)
    export_serving(params, ARCH, batch, chunk, str(tmp_path / "port"), engine="xla",
                   temperature=1.0, per_lane=True)
    inv = np.array([1.0, 1.0 / 0.7, 0.0], np.float32)
    lane = np.stack([np.array([11, 22, 33], np.int32), np.array([0, -5, 3], np.int32),
                     inv.view(np.int32)])
    ja, pa = jload(str(tmp_path / "jax")), load_serving(str(tmp_path / "port"))
    js, ps = ja.init(jp, 4), pa.init(params, 4)
    jout, pout = [], []
    for _ in range(3):
        c, js = ja.step(jp, js, lane=jnp.asarray(lane))
        jout.append(np.asarray(c))
        c, ps = pa.step(params, ps, lane=torch.from_numpy(lane))
        pout.append(c.numpy())
    np.testing.assert_array_equal(np.concatenate(pout, 1), np.concatenate(jout, 1))
    forced = np.random.default_rng(1).integers(0, 256, (batch, 24)).astype(np.int32)
    _, jl = jgen(jp, jarch, jax.random.key(0), batch, 24, forced=jnp.asarray(forced),
                 temperature=0.0, return_logits=True, engine="xla")
    _, pl = pgen(params, ARCH, 0, batch, 24, forced=torch.from_numpy(forced),
                 temperature=0.0, return_logits=True, engine="xla", device="cpu")
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)


def test_artifact_serves_in_a_fresh_process_without_model_code(tmp_path):
    """A per-lane mega artifact loaded by a fresh interpreter serves the
    pool's requests with the in-process pool's classes, and that process
    never imports lb_wavenet_tpu_torch.models (nor generate)."""
    batch, chunk = 8, 16
    params = init_params(0, ARCH)
    out_dir = str(tmp_path / "art")
    export_serving(params, ARCH, batch, chunk, out_dir, engine="mega", temperature=1.0,
                   per_lane=True)
    torch.save(params, tmp_path / "params.pt")
    code = f"""
import json, sys
import numpy as np, torch
from lb_wavenet_tpu_torch.config import ArchConfig
from lb_wavenet_tpu_torch.serving import SessionPool
from lb_wavenet_tpu_torch.utils.export import load_serving
art = load_serving({out_dir!r})
params = torch.load({str(tmp_path / "params.pt")!r})
pool = SessionPool(params, art.arch, {batch}, 5, artifact=art, temperature=1.0, device="cpu")
reqs = {REQS!r}
i, out = 0, {{}}
while pool.active or i < len(reqs):
    while i < len(reqs) and pool.submit(reqs[i][0], reqs[i][1], **reqs[i][2]):
        i += 1
    for rid, (c, done) in pool.step().items():
        out.setdefault(rid, []).extend(int(x) for x in c)
mods = [m for m in sys.modules if m.startswith("lb_wavenet_tpu_torch.")]
print(json.dumps({{"out": out, "mods": mods}}))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert not [m for m in rec["mods"] if m.startswith(("lb_wavenet_tpu_torch.models",
                                                        "lb_wavenet_tpu_torch.generate"))]
    want = _run_pool(SessionPool(params, ARCH, batch, 5, engine="mega", chunk_size=chunk,
                                 temperature=1.0, device="cpu"))
    assert set(rec["out"]) == set(want)
    for rid in want:
        np.testing.assert_array_equal(np.asarray(rec["out"][rid], np.int32), want[rid])
