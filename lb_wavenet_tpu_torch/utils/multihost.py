"""Process start-up for the port's meshes (what serving needs of
`lb_wavenet_tpu/utils/multihost.py` and of the JAX CLI's
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

Not ported yet (ROADMAP.md A queue item 7b): `assert_replicated_params`,
the training guard that all-gathers a parameter checksum.
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
