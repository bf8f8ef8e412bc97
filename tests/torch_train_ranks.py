"""The rank side of tests/test_torch_parallel_train.py: one process per rank
of a (data, model) mesh over gloo on the CPU, started by
torch.multiprocessing.spawn with a file:// store. This module imports torch
and the port only (no JAX): each rank runs the layout's checks and saves
its results for the test process, which holds them against the JAX
package's steps and the port's one-rank step."""
import numpy as np
import torch


def _state(case):
    """The case's (whole) train state as the port's TrainState."""
    from lb_wavenet_tpu_torch.train import TrainState
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    st = case["state"]
    opt = {"count": st["count"], "mu": params_from_jax(st["mu"]),
           "nu": params_from_jax(st["nu"])}
    return TrainState(params_from_jax(st["params"]), opt, st["step"], None)


def step_once(kind, mesh, arch, train, state, batch):
    """One step of the layout's kind ("dp", "sp", "tp") from the WHOLE
    state on the GLOBAL host batch (a data.Batch): (this rank's new state,
    loss)."""
    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.parallel.mesh import shard_batch

    if kind == "sp":
        return PT.make_sp_train_step(mesh, arch, train)(
            state, PT.seq_batch_to_device(batch, mesh, train.window_size, "cpu"))
    rows = shard_batch(PT.batch_to_device(batch, "cpu"), mesh)
    if kind == "tp":
        return PT.make_tp_train_step(mesh, arch, train)(PT.shard_state(state, mesh), rows)
    return PT.make_dp_train_step(mesh, arch, train)(state, rows)


def _whole(state, mesh):
    """(params, Adam mu) of a rank's state at full width, as numpy."""
    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.utils.convert import params_to_numpy

    whole = PT.gather_state(state, mesh)
    return params_to_numpy(whole.params), params_to_numpy(whole.opt_state["mu"])


def run_rank(rank, world, store, layout, case, work):
    torch.set_num_threads(1)
    import dataclasses
    import os

    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.config import ArchConfig, Config, TrainConfig
    from lb_wavenet_tpu_torch.data import Batch, synthetic_corpus
    from lb_wavenet_tpu_torch.parallel.mesh import make_mesh
    from lb_wavenet_tpu_torch.utils import checkpoint, multihost

    multihost.init_distributed(device="cpu", init_method=f"file://{store}", rank=rank,
                               world_size=world, local_world_size=world)
    try:
        mesh = make_mesh(*layout, device="cpu")
        arch = ArchConfig(**case["arch"])
        train = TrainConfig(**case["train"])
        kind = case["kind"]
        batch = Batch(**case["batch"])
        out = {"mesh": (mesh.data, mesh.model, mesh.data_rank, mesh.model_rank, mesh.backend)}
        state = _state(case)

        new, loss = step_once(kind, mesh, arch, train, state, batch)
        out["step"] = (float(loss), *_whole(new, mesh))
        acc = dataclasses.replace(train, grad_accum=2)
        new, loss = step_once(kind, mesh, arch, acc, state, batch)
        out["accum"] = (float(loss), *_whole(new, mesh))
        if kind == "tp":
            clip = dataclasses.replace(train, grad_clip_norm=case["clip"])
            new, loss = step_once(kind, mesh, arch, clip, state, batch)
            out["clip"] = (float(loss), *_whole(new, mesh))

        # The divergence guard: the same state passes; one rank's perturbed
        # replicated leaf makes every rank raise.
        held = PT.shard_state(state, mesh) if mesh.model > 1 else state
        multihost.assert_replicated_params(held.params, 0, mesh)
        out["checksum"] = multihost.params_checksum(held.params, mesh)
        bad = dict(held.params, embed=held.params["embed"] + (rank == world - 1) * 1e-3)
        try:
            multihost.assert_replicated_params(bad, 7, mesh)
            out["guard"] = "did not raise"
        except RuntimeError as e:
            out["guard"] = str(e)

        # run_training across the ranks: 3 steps straight, and 2 steps then
        # a resume to 3, from a corpus every rank builds alike.
        corpus = synthetic_corpus(arch, train.window_size, n_files=2, file_len=600, seed=5)
        if arch.use_global_cond:
            corpus.speakers = [0, 1]
        runs = {}
        for name, legs in (("straight", (3,)), ("resumed", (2, 3))):
            ckpt = os.path.join(work, f"ckpt_{name}")
            cfg = Config(arch=arch, train=dataclasses.replace(
                train, checkpoint_dir=ckpt, checkpoint_every=2, log_every=1, n_steps=3))
            for n in legs:
                final = PT.run_training(cfg, corpus=corpus, n_steps=n, device="cpu")
            runs[name] = (final.step, _whole(final, mesh)[0], checkpoint.steps(ckpt))
            if rank == 0:
                runs[name] += (checkpoint.restore_params(ckpt),)
        out["run"] = runs
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()
