"""The ('data', 'model') process mesh over torch.distributed (port of
`lb_wavenet_tpu/parallel/mesh.py`).

JAX lays its devices out as a (data, model) array and names the axes; here
every rank is one process and the mesh is a pair of process groups. Rank r
sits at (r // mesh_model, r % mesh_model), as JAX's device reshape puts
device r: the ranks of one `model` group share a data index (they hold the
slices of one model), the ranks of one `data` group share a model index
(they hold the same slice for different lanes).

The backend is chosen when the process group starts
(`utils.multihost.init_distributed`): NCCL when every rank has a card of its
own, gloo when ranks share a card or run on the CPU. A collective over gloo
on a CUDA tensor is staged through host memory (`all_reduce_`,
`all_gather_rows`), so two ranks can share one card. Summaries that state a
mesh print its backend (`Mesh.describe`).

Training layout (JAX's `param_pspec`, `shard_params`, `shard_batch`, which
GSPMD applies; here each rank cuts its own part): the model axis splits only
the skip-separable leaves, w_skip and b_skip on S and post.w1 on its rows
(`SHARDED`, the layout of model-sharded serving); everything else is
replicated. A data rank takes the rows data_rank::data of the global batch.
`gather_params` is the inverse a checkpoint needs. The gradient collectives
sum one flat fp32 buffer per step and group (`all_reduce_flat_`): over
gloo on a CUDA tensor every collective is a round trip through host memory.
A process that runs alone (no process group) gets `local_mesh`, a 1 x 1 mesh
whose collectives do nothing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) mesh of processes."""

    data: int                 # size of the data axis
    model: int                # size of the model axis
    data_rank: int            # this rank's coordinate on the data axis
    model_rank: int           # this rank's coordinate on the model axis
    data_group: object        # the ranks with this model index
    model_group: object       # the ranks with this data index
    device: torch.device
    backend: str

    def describe(self) -> dict:
        """The mesh as summary lines print it."""
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model, "backend": self.backend}


_SEED_STRIDE = 0x9E3779B97F4A7C15   # 64-bit golden ratio: shard seeds far apart


def data_shard_seed(seed: int, data_rank: int) -> int:
    """The sampling seed of data shard `data_rank` of a session seeded with
    `seed` (shard 0 keeps it)."""
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"mesh synthesis takes an int seed, got {type(seed).__name__}")
    return (int(seed) + data_rank * _SEED_STRIDE) % 2**63


def make_mesh(mesh_data: int = -1, mesh_model: int = 1, device="cuda") -> Mesh:
    """The (mesh_data, mesh_model) mesh over every rank of the default
    process group (mesh_data=-1: world size // mesh_model), computing on
    `device` ("cuda": this rank's card, `utils.multihost.rank_device`).
    Every rank calls it, in the same order as its other group creations."""
    from ..utils.multihost import rank_device

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs torch.distributed: call "
            "utils.multihost.init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if mesh_model < 1 or world % mesh_model:
        raise ValueError(f"mesh_model {mesh_model} must divide the world size {world}")
    if mesh_data == -1:
        mesh_data = world // mesh_model
    if mesh_data * mesh_model != world:
        raise ValueError(
            f"mesh {mesh_data}x{mesh_model} does not cover the {world} ranks "
            "(every rank belongs to the mesh)")
    model_groups = [list(range(d * mesh_model, (d + 1) * mesh_model))
                    for d in range(mesh_data)]
    data_groups = [list(range(m, world, mesh_model)) for m in range(mesh_model)]
    model_group, _ = dist.new_subgroups_by_enumeration(model_groups)
    data_group, _ = dist.new_subgroups_by_enumeration(data_groups)
    return Mesh(mesh_data, mesh_model, rank // mesh_model, rank % mesh_model,
                data_group, model_group, rank_device(device), dist.get_backend())


def local_mesh(device) -> Mesh:
    """The 1 x 1 mesh of a process that runs alone (no process group)."""
    return Mesh(1, 1, 0, 0, None, None, torch.device(device), "none")


def _staged(x: torch.Tensor, backend: str) -> bool:
    return backend == "gloo" and x.device.type == "cuda"


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum x over `group` in place (through host memory for gloo on a CUDA
    tensor); returns x."""
    if _staged(x, dist.get_backend(group)):
        host = x.cpu()
        dist.all_reduce(host, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=group)
    return x


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data shards' x concatenated along dim 0 in data-rank order, on
    every rank (x itself when the data axis has one rank)."""
    if mesh.data == 1:
        return x
    src = x.cpu() if _staged(x, mesh.backend) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.data)]
    dist.all_gather(parts, src, group=mesh.data_group)
    return torch.cat(parts, 0).to(x.device)


# The leaves the model axis splits, by path, and the dim it splits of each.
SHARDED = {("layers", "w_skip"): -1, ("layers", "b_skip"): -1, ("post", "w1"): 0}


def _map_sharded(fn, tree, path=()):
    """fn(path, leaf) over the leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_sharded(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_sharded(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def sharded_dim(path: tuple):
    """The dim the model axis splits of the leaf at `path` (a params tree's,
    or an Adam moment's or EMA's of the same structure), or None."""
    return SHARDED.get(tuple(path[-2:]))


def shard_params(tree, mesh: Mesh):
    """This rank's part of a params-shaped tree (params, Adam moments, EMA)
    on its device: the SHARDED leaves cut to the rank's slice of the model
    axis, everything else whole (JAX `shard_params` with `param_pspec`)."""
    def cut(path, x):
        x = x.to(mesh.device)
        dim = sharded_dim(path)
        if dim is None or mesh.model == 1:
            return x
        n = x.shape[dim]
        if n % mesh.model:
            raise ValueError(f"{'.'.join(map(str, path))}: {n} does not split over the "
                             f"model axis ({mesh.model})")
        k = n // mesh.model
        return x.narrow(dim, mesh.model_rank * k, k).contiguous()

    return _map_sharded(cut, tree)


def gather_params(tree, mesh: Mesh):
    """The inverse of shard_params on every rank of the model group: the
    SHARDED leaves all-gathered to full width (every rank of the group
    calls it)."""
    def full(path, x):
        dim = sharded_dim(path)
        if dim is None or mesh.model == 1:
            return x
        src = x.detach().cpu() if _staged(x, mesh.backend) else x.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.model)]
        dist.all_gather(parts, src, group=mesh.model_group)
        return torch.cat(parts, dim).to(x.device)

    return _map_sharded(full, tree)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This data rank's rows, data_rank::data, of a global batch dict
    (what each rank's loader yields with host_id = data_rank, host_count =
    data)."""
    return {k: v[mesh.data_rank::mesh.data] for k, v in batch.items()}


def all_reduce_flat_(tensors: list, group, size: int) -> list:
    """Sum every tensor of the list over `group` (of `size` ranks) with ONE
    collective: they are copied into one flat fp32 buffer, summed, and
    copied back in place. Returns the list. Nothing happens on a group of
    one rank."""
    if size == 1 or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    all_reduce_(flat, group)
    at = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[at:at + n].view_as(t))
        at += n
    return tensors
