"""Distributed synthesis over a (data, model) process mesh (port of
`lb_wavenet_tpu/parallel/synthesis.py`).

One process per rank (`parallel.mesh`). Every rank runs the same program on
host-replicated inputs: the GLOBAL batch, identical on every rank; it
computes its own part and gets the global classes back (all-gathered over
`data`), so that any rank (the CLI: rank 0) can deliver.

* Fleet (`fleet_generate_classes`): each data rank runs its lane shard
  through the single-device engine; the model is replicated.
* Model-sharded (`mesh_generate_classes`, `model_sharded_generate_classes`,
  `ShardedSession`): the skip split. A model rank holds its slice of w_skip
  and b_skip (on S) and of post.w1 (its rows), runs the whole stack down to
  its slice of the skip sum (the sum over layers is separable by skip
  column, so no per-layer collective) and completes the post network's
  hidden layer with ONE all-reduce per step. turbo and mega run the TP step
  (kernel B7, generate._tp_scan), pallas its fused_stack on the sliced
  w_skip, xla its layer loop. Composes with a data axis.
* Conditioning (`cond` (B, T, Cc) upsampled, `speaker_ids` (B,)) is
  host-replicated like every input: each data rank takes its lanes' rows,
  and the model ranks add the whole cond term to the gate, which is not
  split.

Where the port differs from the JAX package:
* JAX partitions its xla engine under a model axis with GSPMD, over the gate
  channels (`model_sharded_param_specs`). PyTorch has no such partitioner:
  the port's xla engine takes the skip split, as JAX's explicit-axis xla
  path does.
* `mesh_generate_classes` runs a fused engine on the model axis whatever its
  size (one rank: a one-rank all-reduce), as `ShardedSession` does in both
  packages; JAX runs it unsharded when the model axis has one device.
  `fleet_generate_classes` is the replicated path.
* Data-shard seeds: JAX folds the data index into its threefry key
  (`fold_in`), which has no counterpart here (ROADMAP: the threefry chain
  is not reproduced). The port's seeds are ints; data shard i samples with
  `data_shard_seed(seed, i)`, and shard 0 keeps the session seed. As in
  JAX, a shard's sampled stream equals a single-device run of that shard
  with that shard's seed; greedy, forced and explicit-lane-seed runs equal
  the single-device run.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ArchConfig
from ..generate import generate_classes, reset_lanes, start_stream, stream_chunk
from ..models.wavenet import params_to
from .mesh import Mesh, all_gather_rows

FUSED_ENGINES = ("pallas", "turbo", "mega")
_SEED_STRIDE = 0x9E3779B97F4A7C15   # 64-bit golden ratio: shard seeds far apart


def data_shard_seed(seed: int, data_rank: int) -> int:
    """The sampling seed of data shard `data_rank` of a session seeded with
    `seed` (shard 0 keeps it)."""
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"mesh synthesis takes an int seed, got {type(seed).__name__}")
    return (int(seed) + data_rank * _SEED_STRIDE) % 2**63


def _check_skip_split(arch: ArchConfig, n_model: int) -> None:
    if arch.skip_channels % n_model:
        raise ValueError(
            f"skip-split model sharding needs skip_channels "
            f"({arch.skip_channels}) % model axis ({n_model}) == 0")


def skip_sharded_params(params: dict, mesh: Mesh) -> dict:
    """This rank's params on its device: the skip-separable dims sliced
    (w_skip and b_skip on S, post.w1 on its rows), everything else whole.
    The counterpart of JAX's `skip_sharded_param_specs`, cut per rank."""
    s = params["layers"]["w_skip"].shape[-1]
    if s % mesh.model:
        raise ValueError(f"skip width {s} does not split over the model axis ({mesh.model})")
    sl = slice(mesh.model_rank * (s // mesh.model), (mesh.model_rank + 1) * (s // mesh.model))
    local = params_to(params, mesh.device)
    lp, pp = dict(local["layers"]), dict(local["post"])
    lp["w_skip"] = lp["w_skip"][..., sl].contiguous()
    lp["b_skip"] = lp["b_skip"][..., sl].contiguous()
    pp["w1"] = pp["w1"][sl].contiguous()
    return {**local, "layers": lp, "post": pp}


def _rows(x, mesh: Mesh, shard_b: int, dtype=None) -> Optional[torch.Tensor]:
    """This data rank's rows of a host-replicated global-batch input (in
    `dtype`, or its own)."""
    if x is None:
        return None
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    return x[mesh.data_rank * shard_b: (mesh.data_rank + 1) * shard_b].to(
        mesh.device, dtype or x.dtype)


def mesh_generate_classes(
    params: dict,
    arch: ArchConfig,
    rng: int,
    batch: int,
    n_samples: int,
    mesh: Mesh,
    engine: str = "mega",
    cond=None,
    speaker_ids=None,
    forced=None,                  # (B, T) classes, -1 = free, global batch
    temperature: float = 1.0,
    **kwargs,
) -> torch.Tensor:
    """(batch, n_samples) classes over the mesh, on every rank. `batch` is
    the GLOBAL lane count (a multiple of the data axis); array inputs are
    the global batch, identical on every rank. Fused engines and every
    engine on a model axis of more than one rank take the skip split; the
    xla engine without one is a fleet. `cond` (B, T, Cc) and `speaker_ids`
    (B,) are global-batch inputs too."""
    if batch % mesh.data:
        raise ValueError(f"global batch {batch} % data axis {mesh.data} != 0")
    if engine in FUSED_ENGINES or mesh.model > 1:
        return _skip_sharded_generate(params, arch, rng, batch, n_samples, mesh, engine,
                                      forced, temperature, cond=cond,
                                      speaker_ids=speaker_ids, **kwargs)
    return fleet_generate_classes(params, arch, rng, batch, n_samples, mesh, engine=engine,
                                  forced=forced, temperature=temperature, cond=cond,
                                  speaker_ids=speaker_ids, **kwargs)


def _skip_sharded_generate(params, arch, rng, batch, n_samples, mesh: Mesh, engine,
                           forced, temperature, cond=None, speaker_ids=None, **kwargs):
    """Model-sharded synthesis: each rank runs its data shard's lanes on
    its skip slice, one all-reduce per step over `model`; the model ranks of
    a data shard follow the same sampling chain, so they emit the same
    classes."""
    _check_skip_split(arch, mesh.model)
    if kwargs.get("return_logits"):
        raise ValueError(
            "return_logits is not supported under model-axis sharding; "
            "run the xla engine unsharded (or per shard) for logits")
    shard_b = batch // mesh.data
    cls = generate_classes(
        skip_sharded_params(params, mesh), arch, data_shard_seed(rng, mesh.data_rank),
        shard_b, n_samples, forced=_rows(forced, mesh, shard_b, torch.int32),
        cond=_rows(cond, mesh, shard_b), speaker_ids=_rows(speaker_ids, mesh, shard_b),
        temperature=temperature, engine=engine, model_axis=mesh, device=mesh.device,
        **kwargs)
    return all_gather_rows(cls, mesh)


def fleet_generate_classes(params, arch: ArchConfig, rng: int, batch: int, n_samples: int,
                           mesh: Mesh, engine: str = "mega", forced=None,
                           temperature: float = 1.0, cond=None, speaker_ids=None,
                           **kwargs) -> torch.Tensor:
    """Batch-sharded generation over the data axis, the model replicated
    (ranks of one data shard compute the same lanes)."""
    if batch % mesh.data:
        raise ValueError(f"global batch {batch} % data axis {mesh.data} != 0")
    if kwargs.get("return_logits"):
        raise ValueError("return_logits is not supported under mesh synthesis")
    shard_b = batch // mesh.data
    cls = generate_classes(
        params, arch, data_shard_seed(rng, mesh.data_rank), shard_b, n_samples,
        forced=_rows(forced, mesh, shard_b, torch.int32), cond=_rows(cond, mesh, shard_b),
        speaker_ids=_rows(speaker_ids, mesh, shard_b), temperature=temperature,
        engine=engine, device=mesh.device, **kwargs)
    return all_gather_rows(cls, mesh)


def model_sharded_generate_classes(params, arch: ArchConfig, rng: int, batch: int,
                                   n_samples: int, mesh: Mesh, engine: str = "xla",
                                   **kwargs) -> torch.Tensor:
    """Generation with the model split over the mesh's `model` axis (the
    skip split for every engine; see the module note)."""
    return mesh_generate_classes(params, arch, rng, batch, n_samples, mesh,
                                 engine=engine, **kwargs)


class ShardedSession:
    """A model-sharded STREAMING session: the streaming primitives
    (start_stream / stream_chunk / reset_lanes) on this rank's skip slice
    and data shard. turbo and mega carry the TP step's feature-major state
    (kernel B7, one all-reduce per step), pallas its RingState with the
    all-reduce at the post hidden. Ring phase and the per-lane hash follow
    absolute time, so chunked output equals the sharded one-shot run.

    Every rank constructs it and calls chunk/reset_lanes in the same order
    with the same (host-replicated, global-batch) arguments; chunk returns
    the global (B, chunk) classes on every rank.
    """

    def __init__(self, params: dict, arch: ArchConfig, batch: int, rng: int, mesh: Mesh,
                 engine: str = "mega"):
        if engine not in FUSED_ENGINES:
            raise ValueError(
                f"ShardedSession engines: {FUSED_ENGINES}; the xla engine streams "
                "through generate.stream_chunk with model_axis")
        if batch % mesh.data:
            raise ValueError(f"batch {batch} % data axis {mesh.data} != 0")
        _check_skip_split(arch, mesh.model)
        self.arch, self.mesh, self.engine, self.batch = arch, mesh, engine, batch
        self.shard_b = batch // mesh.data
        self.params = skip_sharded_params(params, mesh)
        self._tp = engine in ("turbo", "mega")
        self.stream = start_stream(
            arch, self.shard_b, data_shard_seed(rng, mesh.data_rank), engine=engine,
            params=self.params, model_axis=mesh if self._tp else None, device=mesh.device)

    @property
    def t(self) -> int:
        return self.stream.t

    def chunk(self, chunk_size: int, cond=None, speaker_ids=None, forced=None,
              temperature: float = 1.0, lane_seed=None, lane_t0=None,
              lane_inv_temp=None) -> torch.Tensor:
        """Emit the next chunk: the global (B, chunk) classes; the session
        state advances in place. `cond` (B, chunk, Cc) and `speaker_ids`
        (B,) are global-batch, as every argument."""
        m, n = self.mesh, self.shard_b
        cls, self.stream = stream_chunk(
            self.params, self.arch, self.stream, chunk_size,
            cond=_rows(cond, m, n), speaker_ids=_rows(speaker_ids, m, n),
            forced=_rows(forced, m, n, torch.int32), temperature=temperature,
            engine=self.engine, lane_seed=_rows(lane_seed, m, n, torch.int32),
            lane_t0=_rows(lane_t0, m, n, torch.int32),
            lane_inv_temp=_rows(lane_inv_temp, m, n, torch.float32), model_axis=m)
        return all_gather_rows(cls, m)

    def reset_lanes(self, lane_mask) -> None:
        """Recycle the masked lanes (global batch) to fresh t=0 sessions."""
        self.stream = reset_lanes(
            self.params, self.arch, self.stream,
            _rows(lane_mask, self.mesh, self.shard_b, torch.bool), engine=self.engine,
            model_axis=self.mesh if self._tp else None)
