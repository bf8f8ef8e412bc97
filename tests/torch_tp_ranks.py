"""The rank side of tests/test_torch_tp.py: one process per rank of a
(data, model) mesh over gloo on the CPU, started by
torch.multiprocessing.spawn with a file:// store, so the ranks need no port.
This module imports torch and the port only (no JAX): each rank runs every
check of the model-sharded slice and saves its results for the test process,
which holds them against the JAX package and the port's single-device runs.
"""
import os

import numpy as np
import torch

B, T = 8, 12          # global lanes and steps of the one-shot checks
POOL_BATCH, POOL_CHUNK = 4, 8
LANE_SEEDS = (np.arange(B, dtype=np.int64) * 2654435761 % 2**31).astype(np.int32)
LANE_T0 = np.array([0, -3, 5, 0, 2, -7, 1, 4], np.int32)
LANE_INV = np.array([1.0 / 0.9, 0.0, 1.0, 2.0] * 2, np.float32)


def forced_primer() -> np.ndarray:
    """(B, T) primer: distinct classes per lane for the first third."""
    forced = np.full((B, T), -1, np.int32)
    forced[:, : T // 3] = (np.arange(B)[:, None] * 7 + np.arange(T // 3)[None, :]) % 256
    return forced


def pool_requests():
    """(id, n_samples) greedy requests; the last ones take recycled lanes."""
    return [(f"q{i}", 9 + 5 * i) for i in range(6)]


def serve_pool(pool, requests):
    """Drive a SessionPool to completion; {id: classes}."""
    out, parts, queue = {}, {}, list(requests)
    while pool.active or queue:
        while queue and pool.submit(queue[0][0], queue[0][1], temperature=0.0):
            parts[queue.pop(0)[0]] = []
        for rid, (cls, done) in pool.step().items():
            parts[rid].append(cls)
            if done:
                out[rid] = np.concatenate(parts.pop(rid))
    return out


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "did not raise"


def run_rank(rank, world, store, layout, arch_kw, np_params, work):
    torch.set_num_threads(1)
    import dataclasses

    from lb_wavenet_tpu_torch import cli
    from lb_wavenet_tpu_torch.config import ArchConfig
    from lb_wavenet_tpu_torch.generate import post_network_sharded
    from lb_wavenet_tpu_torch.parallel import synthesis as S
    from lb_wavenet_tpu_torch.parallel.mesh import make_mesh
    from lb_wavenet_tpu_torch.serving import SessionPool
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax
    from lb_wavenet_tpu_torch.utils.multihost import init_distributed, shutdown

    arch = ArchConfig(**arch_kw)
    params = params_from_jax(np_params)
    init_distributed(device="cpu", init_method=f"file://{store}", rank=rank,
                     world_size=world)
    mesh = make_mesh(*layout, device="cpu")
    res = {"mesh": (mesh.data, mesh.model, mesh.data_rank, mesh.model_rank, mesh.backend)}

    def gen(engine, **kw):
        return S.mesh_generate_classes(params, arch, 3, B, T, mesh, engine=engine, **kw)

    for engine in ("mega", "turbo", "pallas", "xla"):
        res[f"greedy_{engine}"] = gen(engine, temperature=0.0)
    res["forced_mega"] = gen("mega", temperature=0.0, forced=forced_primer())
    lane_kw = dict(lane_seed=LANE_SEEDS, lane_t0=LANE_T0, lane_inv_temp=LANE_INV)
    for engine in ("mega", "pallas"):
        sess = S.ShardedSession(params, arch, B, 5, mesh, engine=engine)
        res[f"lane_seed_{engine}"] = torch.cat(
            [sess.chunk(T // 2, temperature=0.9, **lane_kw) for _ in range(2)], 1)
    for engine in ("mega", "turbo"):
        sess = S.ShardedSession(params, arch, B, 7, mesh, engine=engine)
        chunks = [sess.chunk(T // 3, temperature=1.0) for _ in range(3)]
        one_shot = S.mesh_generate_classes(params, arch, 7, B, T, mesh, engine=engine)
        res[f"chunked_{engine}"] = (torch.cat(chunks, 1), one_shot, sess.t)

    # A recycled lane equals a fresh session's lane (greedy).
    sess = S.ShardedSession(params, arch, B, 9, mesh, engine="mega")
    sess.chunk(T, temperature=0.0)
    mask = np.zeros(B, bool)
    mask[3] = True
    sess.reset_lanes(mask)
    recycled = sess.chunk(T, temperature=0.0)
    fresh = S.ShardedSession(params, arch, B, 9, mesh, engine="mega").chunk(T, temperature=0.0)
    res["reset_lane"] = (recycled, fresh)

    res["guard_skip_channels"] = _raises(lambda: S.mesh_generate_classes(
        params, dataclasses.replace(arch, skip_channels=7), 0, B, T, mesh, engine="mega"))
    res["guard_return_logits"] = _raises(lambda: gen("pallas", return_logits=True))
    res["guard_global_rng"] = _raises(lambda: gen("mega", temperature=1.0, global_rng=True))

    # The post network over skip slices: partial products summed by the
    # all-reduce equal the unsharded post network.
    skip = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, arch.skip_channels)).astype(np.float32))
    s_l = arch.skip_channels // mesh.model
    local = S.skip_sharded_params(params, mesh)
    res["post_network_sharded"] = (post_network_sharded(
        local, skip[:, mesh.model_rank * s_l: (mesh.model_rank + 1) * s_l],
        torch.float32, mesh), skip)

    pool = SessionPool(params, arch, POOL_BATCH, 0, engine="mega", chunk_size=POOL_CHUNK,
                       temperature=1.0, pipeline=True, mesh=mesh)
    res["pool_greedy"] = serve_pool(pool, pool_requests())

    common = ["--config", os.path.join(work, "arch.json"), "--device", "cpu",
              "--mesh-model", str(layout[1]),
              "--set", f"gen.checkpoint_dir={os.path.join(work, 'ckpt')}"]
    res["cli_serve"] = cli.main([
        "serve", *common, "--requests", os.path.join(work, "requests.jsonl"),
        "--stream-chunk", str(POOL_CHUNK), "--set", f"gen.batch_size={POOL_BATCH}",
        "--set", "gen.temperature=0.0", "--set", f"gen.out_dir={os.path.join(work, 'serve')}"])
    res["cli_generate"] = cli.main([
        "generate", *common, "--set", f"gen.batch_size={B}", "--set", f"gen.n_samples={T}",
        "--set", "gen.temperature=0.0", "--set", "gen.engine=mega",
        "--set", f"gen.out_dir={os.path.join(work, 'generate')}"])
    torch.save(res, os.path.join(work, f"rank{rank}.pt"))
    shutdown()


def run_cuda_rank(rank, world, store, arch_kw, np_params, work):
    """A rank of the card test: gloo ranks sharing cuda:0, greedy TP mega."""
    from lb_wavenet_tpu_torch.config import ArchConfig
    from lb_wavenet_tpu_torch.ops.cuda import ar_tp
    from lb_wavenet_tpu_torch.parallel import synthesis as S
    from lb_wavenet_tpu_torch.parallel.mesh import make_mesh
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax
    from lb_wavenet_tpu_torch.utils.multihost import init_distributed, shutdown

    backend = init_distributed(device="cuda", init_method=f"file://{store}", rank=rank,
                               world_size=world, local_world_size=world)
    mesh = make_mesh(1, world)
    cls = S.mesh_generate_classes(params_from_jax(np_params), ArchConfig(**arch_kw), 3, 16, 32,
                                  mesh, engine="mega", temperature=0.0)
    torch.cuda.synchronize()
    torch.save({"backend": backend, "device": str(mesh.device), "classes": cls.cpu(),
                "launches": ar_tp.tp_fused_stack.launches},
               os.path.join(work, f"cuda_rank{rank}.pt"))
    shutdown()
