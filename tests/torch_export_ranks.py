"""The rank side of tests/test_torch_export.py's sharded case: one process per
rank of a (1, 2) mesh over gloo on the CPU (file:// store, no port), started
by torch.multiprocessing.spawn. Imports torch and the port only (no JAX).
Each rank serves a model-sharded artifact and the in-process
ShardedSession with the same seed and reset schedule, and saves both."""
import torch

B, CHUNK, N_CHUNKS = 4, 8, 3
RESET = [False, True, False, False]


def run_rank(rank, world, store, art_dir, params, arch_kw, work):
    torch.set_num_threads(1)
    from lb_wavenet_tpu_torch.config import ArchConfig
    from lb_wavenet_tpu_torch.parallel.mesh import make_mesh
    from lb_wavenet_tpu_torch.parallel.synthesis import ShardedSession
    from lb_wavenet_tpu_torch.utils.export import ShardedServingArtifact, load_serving
    from lb_wavenet_tpu_torch.utils.multihost import init_distributed, shutdown

    arch = ArchConfig(**arch_kw)
    init_distributed(device="cpu", init_method=f"file://{store}", rank=rank,
                     world_size=world)
    mesh = make_mesh(1, world, device="cpu")
    art = load_serving(art_dir)
    assert isinstance(art, ShardedServingArtifact)
    placed = art.place_params(params)
    state = art.init(placed, 7)
    got = []
    for i in range(N_CHUNKS):
        classes, state = art.step(placed, state)
        got.append(classes)
        if i == 0:   # recycle lane 1 mid-stream, like the serving pool
            state = art.reset(placed, state, RESET)
    sess = ShardedSession(params, arch, B, 7, mesh, engine="turbo")
    want = []
    for i in range(N_CHUNKS):
        want.append(sess.chunk(CHUNK, temperature=1.0))
        if i == 0:
            sess.reset_lanes(RESET)
    torch.save({"got": torch.cat(got, 1), "want": torch.cat(want, 1)},
               f"{work}/rank{rank}.pt")
    shutdown()
