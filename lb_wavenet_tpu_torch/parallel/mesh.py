"""The ('data', 'model') process mesh over torch.distributed (port of
`lb_wavenet_tpu/parallel/mesh.py`, the part serving needs).

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

Not ported yet (ROADMAP.md A queue item 7b): `param_pspec`, `shard_params`
and `shard_batch`, which lay out GSPMD training.
"""
from __future__ import annotations

import dataclasses

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
