"""Port tests: model-sharded serving. Kernel B7's plain version (the CPU
path of `ops/cuda/ar_tp.py`) against the JAX TP kernel in interpret mode,
and the slice over gloo ranks on the CPU: (data, model) layouts (1, 2) and
(2, 2), every rank a process started once per layout
(tests/torch_tp_ranks.py, which imports no JAX), its results held against
JAX's mesh synthesis and ShardedSession on the 8-device CPU mesh of
tests/conftest.py and against the port's single-device runs."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu import generate as JG
from lb_wavenet_tpu.models.wavenet import init_params as jinit
from lb_wavenet_tpu.ops.pallas.ar_tp import tp_fused_stack as jtp
from lb_wavenet_tpu.parallel.mesh import make_mesh as jmesh
from lb_wavenet_tpu.parallel import synthesis as JS
from lb_wavenet_tpu_torch import generate as PG
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.models.wavenet import post_network
from lb_wavenet_tpu_torch.ops.cuda import ar_tp as PTP
from lb_wavenet_tpu_torch.utils.convert import params_from_jax

from . import torch_tp_ranks as R
from .util import MICRO

torch.set_num_threads(1)
ATOL = 1e-5   # fp32 MICRO: the same products summed in another order


def _pair(arch=MICRO, seed=0):
    jp = jinit(jax.random.key(seed), arch)
    np_params = jax.tree.map(np.asarray, jp)
    return jp, np_params, params_from_jax(np_params), PArch(**dataclasses.asdict(arch))


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _skip_slice(tree, sl):
    """A params tree with w_skip/b_skip cut to the skip columns `sl`."""
    lp = dict(tree["layers"])
    lp["w_skip"], lp["b_skip"] = lp["w_skip"][..., sl], lp["b_skip"][..., sl]
    return {**tree, "layers": lp}


@pytest.mark.parametrize("s_l,dtype,atol", [(8, "float32", ATOL), (4, "float32", ATOL),
                                            (1, "float32", ATOL), (4, "bfloat16", 2e-2)])
def test_tp_fused_stack_matches_jax(s_l, dtype, atol):
    """One step at t = 777 from a random ring and h0 on the skip slice of
    the LAST model rank. The ring: rows no layer wrote, and layer 0's slot
    (which takes h0), exactly; the other written slots hold h after a
    product, within atol like the local skip sum (fp32: the same products
    summed in another order; bf16: also an activation's rounding may flip)."""
    arch = dataclasses.replace(MICRO, compute_dtype=dtype)
    jp, _, pp, parch = _pair(arch, seed=s_l)
    sl = slice(arch.skip_channels - s_l, arch.skip_channels)
    jp, pp = _skip_slice(jp, sl), _skip_slice(pp, sl)
    b, c, t = 6, arch.residual_channels, 777
    rng = np.random.default_rng(s_l)
    bufs = rng.standard_normal((sum(arch.dilations), c, b)).astype(np.float32)
    h0 = rng.standard_normal((c, b)).astype(np.float32)
    slots = np.asarray(PG.buffer_offsets(parch)) + t % np.asarray(arch.dilations)
    jfm = JG._tp_weights(jp, jp["layers"], False)
    jb, js = jtp(jfm, arch, jnp.asarray(h0), jnp.asarray(bufs), jnp.asarray(slots, jnp.int32),
                 interpret=True)
    pfm = PG._tp_weights(pp, pp["layers"], torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    written = np.zeros(len(bufs), bool)
    written[slots] = True
    for fn in (PTP.tp_fused_stack_plain, PTP.tp_fused_stack):
        pbufs = torch.from_numpy(bufs.copy())
        pb, ps = fn(pfm, parch, torch.from_numpy(h0), pbufs, t)
        assert pb is pbufs and ps.shape == (s_l, b)   # the ring is updated in place
        np.testing.assert_array_equal(pb.numpy()[~written], bufs[~written])
        np.testing.assert_array_equal(pb.numpy()[slots[0]], h0)
        np.testing.assert_array_equal(np.asarray(jb)[slots[0]], h0)
        np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=atol)
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=atol)


def test_prepared_keys_a_slice_apart_from_the_whole():
    """build.prepared: a view of a weight (a rank's skip slice, same data
    pointer) gets its own entry, not the whole weight's."""
    from lb_wavenet_tpu_torch.ops.cuda import build

    w = torch.arange(12.0).reshape(3, 4)
    whole = build.prepared("slice test", (w,), lambda: w.clone())
    part = build.prepared("slice test", (w[:, :2],), lambda: w[:, :2].clone())
    assert part.shape == (3, 2) and whole.shape == (3, 4)
    assert build.prepared("slice test", (w.t(),), lambda: w.t().clone()).shape == (4, 3)


def test_model_axis_is_a_process_group_not_a_name(pair):
    """The port's model axis is a process group (or Mesh): an axis name
    raises before anything runs."""
    *_, pp, parch = pair
    with pytest.raises(TypeError, match="process group"):
        PG.generate_classes(pp, parch, 0, 2, 4, engine="mega", model_axis="model",
                            device="cpu")


# ---------------------------------------------------------------------------
# The slice over gloo ranks.

LAYOUTS = [(1, 2), (2, 2)]
CHECKS = ["greedy_mega", "greedy_turbo", "greedy_pallas", "greedy_xla", "forced_mega",
          "lane_seed_mega", "lane_seed_pallas", "chunked_mega", "chunked_turbo",
          "reset_lane", "guard_skip_channels", "guard_return_logits", "guard_global_rng",
          "post_network_sharded", "pool_greedy", "cli_serve", "cli_generate"]


def _spawn(layout, work, np_params, parch):
    from lb_wavenet_tpu_torch.utils.checkpoint import save_params

    world = layout[0] * layout[1]
    save_params(str(work / "ckpt"), params_from_jax(np_params), 0)
    (work / "arch.json").write_text(json.dumps({"arch": dataclasses.asdict(parch)}))
    (work / "requests.jsonl").write_text("".join(
        json.dumps({"id": rid, "n_samples": n}) + "\n" for rid, n in R.pool_requests()))
    torch.multiprocessing.spawn(
        R.run_rank, args=(world, str(work / "store"), layout, dataclasses.asdict(parch),
                          np_params, str(work)),
        nprocs=world, join=True)
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, pair):
    """{layout: [each rank's results]}, each layout spawned on first use."""
    _, np_params, _, parch = pair
    cache = {}

    def get(layout):
        if layout not in cache:
            work = tmp_path_factory.mktemp(f"tp_{layout[0]}x{layout[1]}")
            cache[layout] = (_spawn(layout, work, np_params, parch), work)
        return cache[layout]

    return get


def _jax_mesh(layout):
    return jmesh(*layout, devices=jax.devices()[: layout[0] * layout[1]])


def _jax_raises(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _check(name, layout, results, work, pair):
    """Hold one check's results (every rank's) against its reference."""
    jp, _, pp, parch = pair
    r0 = results[0]
    key = jax.random.key(3)
    mesh = _jax_mesh(layout)
    world = layout[0] * layout[1]
    assert [r["mesh"][:2] for r in results] == [layout] * world
    assert {r["mesh"][4] for r in results} == {"gloo"}

    def same_on_every_rank(value):
        for r in results[1:]:
            torch.testing.assert_close(r[name], value, rtol=0, atol=0)

    if name.startswith("greedy_") or name == "forced_mega":
        engine = name.split("_")[1]
        forced = R.forced_primer() if name == "forced_mega" else None
        ref = JS.mesh_generate_classes(jp, MICRO, key, R.B, R.T, mesh, engine=engine,
                                       temperature=0.0, forced=forced)
        np.testing.assert_array_equal(r0[name].numpy(), np.asarray(ref))
        same_on_every_rank(r0[name])
    elif name.startswith("lane_seed_"):
        sess = JS.ShardedSession(jp, MICRO, R.B, jax.random.key(5), mesh,
                                 engine=name.split("_")[2])
        ref = np.concatenate([np.asarray(sess.chunk(
            R.T // 2, temperature=0.9, lane_seed=R.LANE_SEEDS, lane_t0=R.LANE_T0,
            lane_inv_temp=R.LANE_INV)) for _ in range(2)], 1)
        np.testing.assert_array_equal(r0[name].numpy(), ref)
        same_on_every_rank(r0[name])
    elif name.startswith("chunked_"):
        chunked, one_shot, t = r0[name]
        assert t == R.T and torch.equal(chunked, one_shot)
        for r in results[1:]:
            assert torch.equal(r[name][0], chunked)
    elif name == "reset_lane":
        recycled, fresh = r0[name]
        assert torch.equal(recycled[3], fresh[3])
    elif name.startswith("guard_"):
        msgs = {r[name] for r in results}
        assert len(msgs) == 1
        if name == "guard_skip_channels":
            arch7 = dataclasses.replace(MICRO, skip_channels=7)
            want = _jax_raises(lambda: JS.mesh_generate_classes(
                jinit(jax.random.key(0), arch7), arch7, key, R.B, R.T, mesh, engine="mega"))
            assert r0[name] == want
        elif name == "guard_return_logits":
            want = _jax_raises(lambda: JS.mesh_generate_classes(
                jp, MICRO, key, R.B, R.T, mesh, engine="pallas", return_logits=True))
            assert r0[name] == want
        else:
            want = _jax_raises(lambda: JS.mesh_generate_classes(
                jp, MICRO, key, R.B, R.T, mesh, engine="mega", temperature=1.0,
                global_rng=True))
            assert want.startswith("global_rng sampling") and r0[name].startswith(
                "global_rng sampling")
    elif name == "post_network_sharded":
        for r in results:
            got, skip = r[name]
            ref = post_network(pp, skip, torch.float32)
            torch.testing.assert_close(got, ref, rtol=0, atol=ATOL)
    elif name == "pool_greedy":
        from lb_wavenet_tpu_torch.serving import SessionPool

        pool = SessionPool(pp, parch, R.POOL_BATCH, 0, engine="mega", chunk_size=R.POOL_CHUNK,
                           temperature=1.0, pipeline=True, device="cpu")
        ref = R.serve_pool(pool, R.pool_requests())
        assert set(r0[name]) == set(ref)
        for r in results:
            for rid in ref:
                np.testing.assert_array_equal(r[name][rid], ref[rid], err_msg=rid)
    else:
        from scipy.io import wavfile

        from lb_wavenet_tpu_torch.ops.mulaw import mu_law_decode

        assert all(r[name] == 0 for r in results)
        if name == "cli_serve":
            want = {rid: cls for rid, cls in r0["pool_greedy"].items()}
            paths = {rid: work / "serve" / f"{rid}.wav" for rid in want}
        else:
            want = {i: r0["greedy_mega"][i].numpy() for i in range(R.B)}
            paths = {i: work / "generate" / f"gen_{i:04d}.wav" for i in range(R.B)}
        for k, cls in want.items():
            _, wav = wavfile.read(paths[k])
            ref = mu_law_decode(torch.from_numpy(np.asarray(cls))).numpy()
            np.testing.assert_array_equal(wav, (np.clip(ref, -1, 1) * 32767.0).astype(np.int16))


@pytest.mark.parametrize("layout", LAYOUTS, ids=["1x2", "2x2"])
@pytest.mark.parametrize("name", CHECKS)
def test_sharded_slice_over_gloo_ranks(ranks, pair, layout, name):
    """One check of the model-sharded slice on gloo ranks: greedy and forced
    classes (mega, turbo, pallas, xla) equal JAX's mesh synthesis; sampled
    ShardedSession chunks with explicit lane seeds equal JAX's; chunked
    output equals one-shot; a reset lane equals a fresh session's; the
    guards raise with JAX's messages; post_network_sharded's partial
    products sum to the unsharded post network; a mesh SessionPool's greedy
    audio equals the single-device pool's; `cli serve/generate
    --mesh-model` write that audio."""
    results, work = ranks(layout)
    _check(name, layout, results, work, pair)
