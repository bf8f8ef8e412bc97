"""Process start-up for the port's meshes and the training divergence guard
(port of `lb_wavenet_tpu/utils/multihost.py` and of the JAX CLI's
`_maybe_init_distributed`).

A rank learns its place from torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT) or from its
caller (rank, world size and a `file://` store, as workers started by
`torch.multiprocessing.spawn` and the tests pass them). Nothing else tells
a program about a cluster.

The backend: NCCL when every rank of the host has a card of its own, gloo
when ranks share a card (two ranks on one H100) or run on the CPU. NCCL
refuses two ranks on one device; gloo sums CUDA tensors through host
memory (`parallel.mesh.all_reduce_`).

The guard (`params_checksum`, `assert_replicated_params`): every rank of a
training mesh must hold the same parameters (the model axis: the same
replicated leaves and its own slice of the sharded ones); a silent
divergence (a non-deterministic input pipeline, a missed collective)
corrupts training without crashing. Each rank takes the checksum of JAX's
package (the same weighted sum), the sharded leaves' partial sums summed
over the model group first (a rank's own slice would make the model ranks
"diverge"), and every rank's checksum is all-gathered and compared.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def rank_device(device="cuda") -> torch.device:
    """`device` with a CUDA device resolved to this rank's card: LOCAL_RANK
    modulo the cards present (two ranks on one card share cuda:0)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch paths on the CPU")
    return torch.device("cuda", _env_int("LOCAL_RANK", 0) % torch.cuda.device_count())


def default_backend(device, local_world_size: int) -> str:
    """nccl when each of the host's ranks has a card of its own, else gloo."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def init_distributed(device="cuda", backend=None, init_method=None, rank=None,
                     world_size=None, local_world_size=None) -> str:
    """Join the default process group, once per process (a second call
    returns the running group's backend). Unset arguments come from
    torchrun's environment; a single process with no environment is rank 0
    of 1 and needs an `init_method` (e.g. `file:///tmp/store`). Returns the
    backend."""
    if dist.is_initialized():
        return dist.get_backend()
    rank = _env_int("RANK", 0) if rank is None else rank
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE", world_size)
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            raise ValueError(
                "init_distributed needs an init_method (a file:// store) or "
                "torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)")
        init_method = "env://"
    dev = rank_device(device)
    backend = backend or default_backend(dev, local_world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend


def shutdown() -> None:
    """Leave the default process group (if this process joined one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _checksum_terms(params, mesh) -> torch.Tensor:
    """(n_leaves, 2) fp32: each leaf's sum and sum of squares, in the order
    of jax.tree.leaves, the SHARDED leaves' summed over the model group (one
    collective)."""
    from ..parallel.mesh import all_reduce_flat_, sharded_dim
    from ..train import tree_leaves, tree_paths

    terms = torch.stack([torch.stack([x.float().sum(), (x.float() * x.float()).sum()])
                         for x in tree_leaves(params)])
    if mesh is not None and mesh.model > 1:
        rows = [i for i, p in enumerate(tree_paths(params)) if sharded_dim(p) is not None]
        part = terms[rows].clone()
        all_reduce_flat_([part], mesh.model_group, mesh.model)
        terms[rows] = part
    return terms


def params_checksum(params, mesh=None) -> float:
    """Order-stable scalar fingerprint of a parameter tree (fp32): the sum
    over leaves i of sum(x_i) (1 + 0.001 i) + 0.5 sum(x_i^2), JAX's weights.
    Under model sharding (`mesh` with a model axis) the sharded leaves'
    sums are taken over the whole model group, so every rank of the mesh
    gets the same number."""
    terms = _checksum_terms(params, mesh)
    acc = torch.zeros((), dtype=torch.float32, device=terms.device)
    for i in range(terms.shape[0]):
        acc = acc + terms[i, 0] * (1.0 + 0.001 * i) + terms[i, 1] * 0.5
    return float(acc)


def assert_replicated_params(params, step: int, mesh=None) -> None:
    """Raise if the ranks disagree on the parameter checksum (every rank of
    the default process group calls it; nothing happens in a process that
    runs alone)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"   # NCCL gathers card tensors
    mine = torch.tensor([params_checksum(params, mesh)], dtype=torch.float64, device=dev)
    gathered = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, mine)
    values = [float(g) for g in gathered]
    if any(v != values[0] for v in values):
        raise RuntimeError(
            f"Cross-rank parameter divergence at step {step}: checksums {values}")
