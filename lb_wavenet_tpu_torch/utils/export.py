"""Serving artifacts: the streaming-synthesis programs exported once with
torch.export and served without the model code (port of
`lb_wavenet_tpu/utils/export.py`).

A serving process loads an artifact with `load_serving`: no model
construction, no tracing, the programs as they were exported. Parameters
are NOT baked in: init, step and reset take the params tree as their first
input, so one artifact serves every checkpoint of its architecture.

An artifact directory contains:
  manifest.json  arch + static choices (batch, chunk_size, engine,
                 temperature, with_cond, per_lane), torch_version,
                 cuda_version, the device and its kind, and the programs'
                 sha256
  init.pt2       (params, seed: int64) -> state
  step.pt2       (params, state[, lane][, cond]) -> (classes, updates)
  reset.pt2      (params, state, lane_mask: bool[B]) -> updates

The kernels enter the programs as custom ops (ops/library.py): on the card
the hand-written kernels run, on the CPU their plain versions. The carries
the kernels and the engines update in place stay updated in place (the
ring is never copied per call), so a program returns only the state
entries that are new tensors (`updates`), and `ServingArtifact` merges them
into the state dict, which crosses the boundary as plain tensors: the
absolute time `t` and the session seed as 0-d int64 CPU tensors, the
xla/pallas engines' torch.Generator as its state tensor.

Step programs. mega and turbo export the whole chunk, as one op call (the
turbo op loops over the chunk's steps inside, as the in-process path
does). xla and pallas export ONE sample step, which `ServingArtifact.step`
runs chunk_size times: a 1024-step chunk traced by torch.export would
unroll into a graph of ~1024 x L layers. The contract stays JAX's:
step(params, state[, cond][, lane]) -> (classes (B, chunk), state).

The model-sharded artifact (`export_sharded_serving`) splits each sample
step at its one all-reduce: `pre` runs kernel B7 through this rank's skip
slice and returns the partial product of the post network's first layer,
`ShardedServingArtifact` all-reduces it over the model axis in Python, and
`post` completes the post network, samples and feeds the next step. A
collective inside an exported graph would bind the program to a process
group that exists only in the process that exported it. A `prep` program
makes the TP step's weight views once per parameter set.

An artifact is bound to the torch version and the device type it was
exported with; `load_serving` refuses another torch version as it refuses a
file whose hash does not match its manifest.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
from typing import Optional

import torch

from ..config import ArchConfig, _from_dict
from ..ops import library  # noqa: F401  (registers the ops the programs call)
from ..ops.cuda.ar_mega import padded_stream_batch
from ..ops.numerics import compute_dtype

ARTIFACT_VERSION = 1
_MANIFEST = "manifest.json"
_INIT = "init.pt2"
_STEP = "step.pt2"
_RESET = "reset.pt2"
_PREP = "prep.pt2"
_POST = "post.pt2"
ENGINES = ("xla", "pallas", "turbo", "mega")
PER_STEP = ("xla", "pallas")   # exported as one sample step


def _i64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64)


def _stream_to_flat(stream, engine: str) -> dict:
    """generate.Stream -> plain dict of tensors."""
    if engine == "mega":
        st = dict(stream.state["carry"])
        st["seed_base"] = _i64(stream.state["seed_base"])
    elif engine == "turbo":
        st = dict(stream.state)
        st["seed_base"] = _i64(st["seed_base"])
    else:
        rs = stream.state
        st = {"embed_buf": rs.embed_buf, "bufs": rs.bufs, "prev_class": rs.prev_class,
              "rng_state": rs.rng}
    st["t"] = _i64(stream.t)
    return st


def _flat_to_stream(flat: dict, engine: str):
    from ..generate import RingState, Stream

    st = dict(flat)
    t = st.pop("t")
    if engine == "mega":
        seed_base = st.pop("seed_base")
        return Stream({"carry": st, "seed_base": seed_base}, t)
    if engine == "turbo":
        return Stream(st, t)
    return Stream(RingState(embed_buf=st["embed_buf"], bufs=st["bufs"],
                            prev_class=st["prev_class"], rng=st["rng_state"]), t)


def _updates(old: dict, new: dict) -> dict:
    """The entries of `new` that are not the tensors of `old` (those were
    updated in place)."""
    return {k: v for k, v in new.items() if v is not old.get(k)}


class _Program(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, args) -> bytes:
    """torch.export `fn` at `args`; the serialized program."""
    ep = torch.export.export(_Program(fn), tuple(args), strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _write(out_dir: str, blobs: dict, manifest: dict) -> dict:
    """Write the programs, then the manifest that binds their hashes (each
    file atomically: a crash mid-way leaves a directory that load_serving
    rejects by hash instead of serving a mixed generation)."""
    manifest["sha256"] = {n: hashlib.sha256(b).hexdigest() for n, b in blobs.items()}
    os.makedirs(out_dir, exist_ok=True)
    for name, data in blobs.items():
        tmp = os.path.join(out_dir, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(out_dir, name))
    tmp = os.path.join(out_dir, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(out_dir, _MANIFEST))
    return manifest


def _base_manifest(arch: ArchConfig, dev: torch.device, **kw) -> dict:
    return {
        "artifact_version": ARTIFACT_VERSION,
        "arch": dataclasses.asdict(arch),
        **kw,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": dev.type,
        "device_kind": _device_kind(dev),
    }


def _make_fns(arch: ArchConfig, batch: int, chunk_size: int, engine: str,
              temperature: float, with_cond: bool, per_lane: bool, device):
    from .. import generate as G

    n = 1 if engine in PER_STEP else chunk_size

    def init_fn(params, seed):
        stream = G.start_stream(arch, batch, seed, engine=engine, params=params,
                                device=device)
        return _stream_to_flat(stream, engine)

    def step_fn(params, state, *rest):
        kw, i = {}, 0
        if per_lane:
            # The (3, B) int32 lane block [seeds; lease times; f32(1/tau)
            # bits] crosses as ONE input (generate._pack_lane's layout).
            lane = rest[0]
            i = 1
            kw = dict(lane_seed=lane[0], lane_t0=lane[1],
                      lane_inv_temp=lane[2].view(torch.float32))
        cond = rest[i] if with_cond else None
        if cond is not None and n == 1:
            cond = cond[:, None]          # the step's (B, Cc) row
        classes, new = G.stream_chunk(params, arch, _flat_to_stream(state, engine), n,
                                      cond=cond, temperature=temperature, engine=engine,
                                      **kw)
        return classes, _updates(state, _stream_to_flat(new, engine))

    def reset_fn(params, state, lane_mask):
        new = G.reset_lanes(params, arch, _flat_to_stream(state, engine), lane_mask,
                            engine=engine)
        # A program needs an output: the session time, unchanged.
        return {**_updates(state, _stream_to_flat(new, engine)), "t": state["t"] + 0}

    return init_fn, step_fn, reset_fn


def export_serving(
    params,
    arch: ArchConfig,
    batch: int,
    chunk_size: int,
    out_dir: str,
    engine: str = "xla",
    temperature: float = 1.0,
    with_cond: bool = False,
    per_lane: bool = False,
) -> dict:
    """Export the streaming-synthesis session to `out_dir` on the device of
    `params`; returns the manifest. `params` gives shapes only: weights are
    not baked in. `per_lane` adds the (3, B) int32 lane block to step
    (seeds, lease times, inverse-temperature bits), so the artifact can
    back a SessionPool with per-request sampling controls."""
    if engine not in ENGINES:
        raise ValueError(f"exportable engines: xla|pallas|turbo|mega, got {engine}")
    if per_lane and temperature <= 0.0:
        raise ValueError(
            "per_lane exports need temperature > 0 (greedy lanes are "
            "expressed as inverse-temperature 0)")
    if padded_stream_batch(batch, engine) != batch:
        raise ValueError(f"engine {engine} streams batches that are multiples of "
                         f"{padded_stream_batch(1, engine)}; got {batch}")
    dev = params["embed"].device
    init_fn, step_fn, reset_fn = _make_fns(arch, batch, chunk_size, engine, temperature,
                                           with_cond, per_lane, dev)
    seed = _i64(0)
    state = init_fn(params, seed)
    step_args = [params, state]
    if per_lane:
        step_args.append(torch.zeros((3, batch), dtype=torch.int32, device=dev))
    if with_cond:
        steps = 1 if engine in PER_STEP else chunk_size
        shape = (batch, arch.cond_channels) if steps == 1 else \
            (batch, chunk_size, arch.cond_channels)
        step_args.append(torch.zeros(shape, dtype=compute_dtype(arch), device=dev))
    blobs = {
        _INIT: _export(init_fn, (params, seed)),
        _STEP: _export(step_fn, step_args),
        _RESET: _export(reset_fn, (params, state,
                                   torch.zeros((batch,), dtype=torch.bool, device=dev))),
    }
    return _write(out_dir, blobs, _base_manifest(
        arch, dev, batch=batch, chunk_size=chunk_size, engine=engine,
        temperature=temperature, with_cond=with_cond, per_lane=per_lane))


class ServingArtifact:
    """A loaded serving artifact: `init` once, then `step` forever.

    State is O(receptive field), and chunk output equals the in-process
    streaming session of the same engine bit for bit (same kernels, same
    random streams)."""

    def __init__(self, manifest: dict, programs: dict):
        self.manifest = manifest
        self.arch = _from_dict(ArchConfig, manifest["arch"])
        self._init = programs[_INIT].module()
        self._step = programs[_STEP].module()
        self._reset = programs[_RESET].module()

    def init(self, params, seed: int) -> dict:
        return dict(self._init(params, _i64(int(seed))))

    def step(self, params, state: dict, cond: Optional[torch.Tensor] = None,
             lane: Optional[torch.Tensor] = None):
        """-> (classes (B, chunk_size) int32, state); the state's tensors
        are updated in place and the new ones merged in.

        per_lane artifacts take `lane`: (3, B) int32 [seeds; lease times;
        f32(1/tau) bits], the SessionPool lane block; with_cond artifacts
        `cond` (B, chunk_size, Cc)."""
        m = self.manifest
        dev = state["bufs"].device
        extra = []
        if m["per_lane"]:
            if lane is None:
                raise ValueError("artifact was exported per_lane: pass lane (3, B) int32")
            extra.append(torch.as_tensor(lane).to(dev, torch.int32))
        elif lane is not None:
            raise ValueError("artifact was exported without per_lane")
        if m["with_cond"]:
            if cond is None:
                raise ValueError("artifact was exported with_cond: pass cond")
            cond = torch.as_tensor(cond).to(dev, compute_dtype(self.arch))
        elif cond is not None:
            raise ValueError("artifact was exported without cond")
        n = 1 if m["engine"] in PER_STEP else m["chunk_size"]   # steps per program call
        parts = []
        for i in range(0, m["chunk_size"], n):
            rest = extra + ([] if cond is None else
                            [cond[:, i] if n == 1 else cond[:, i: i + n]])
            classes, upd = self._step(params, state, *rest)
            state = {**state, **upd}
            parts.append(classes)
        return (parts[0] if len(parts) == 1 else torch.cat(parts, 1)), state

    def reset(self, params, state: dict, lane_mask) -> dict:
        """Continuous batching behind the export boundary: reset the masked
        lanes to a fresh t=0 session (generate.reset_lanes: a recycled lane
        equals a fresh session bit for bit)."""
        mask = torch.as_tensor(lane_mask).to(state["bufs"].device, torch.bool)
        return {**state, **self._reset(params, state, mask)}


# ---------------------------------------------------------------------------
# Model-sharded artifacts.

def _tp_fns(arch: ArchConfig, shard_b: int, temperature: float, with_cond: bool, device):
    from .. import generate as G

    dt = compute_dtype(arch)

    def prep_fn(params):
        return G._tp_weights(params, params["layers"], dt)

    def init_fn(params, seed):
        state = G._tp_zero_state(params, arch, shard_b)
        return {**state, "seed_base": G._seed_base(seed), "t": _i64(0)}

    def pre_fn(fm, state, *cond):
        cond_t = cond[0].to(dt).t().contiguous() if with_cond else None
        _, skip_local = G.tp_fused_stack(fm, arch, state["h"], state["bufs"], state["t"],
                                         cond_t)
        return G._tp_partial(fm, skip_local, dt)

    def post_fn(fm, state, part):
        logits = G._tp_finish(fm, part, dt)
        lane = None
        if temperature > 0.0:
            lane = torch.stack([G.derive_lane_seeds(state["seed_base"], shard_b, device),
                                torch.zeros((shard_b,), dtype=torch.int32, device=device)])
        forced = torch.full((shard_b,), -1, dtype=torch.int32, device=device)
        cls = G.sample_fm(logits, temperature, lane, state["t"], 0, forced)
        G._tp_next_frontend(fm, state, cls, dt)
        return cls, {"t": state["t"] + 1}

    def reset_fn(params, state, lane_mask):
        G._tp_reset_lanes(params, arch, G.Stream(state, state["t"]), lane_mask)
        return {"t": state["t"] + 0}

    return prep_fn, init_fn, pre_fn, post_fn, reset_fn


def export_sharded_serving(
    params,
    arch: ArchConfig,
    batch: int,
    chunk_size: int,
    out_dir: str,
    engine: str = "mega",
    temperature: float = 1.0,
    mesh_data: int = 1,
    mesh_model: int = 2,
    with_cond: bool = False,
) -> dict:
    """Export a MODEL-SHARDED streaming session (the TP step of
    parallel.synthesis.ShardedSession for turbo/mega: kernel B7 through a
    rank's skip slice, one all-reduce per sample). `params` are WHOLE (a
    rank's skip slice is cut here for the shapes); every rank runs the same
    programs on its own slice and data shard. Loading needs a process
    group of mesh_data * mesh_model ranks."""
    from ..parallel.mesh import Mesh, shard_params

    if engine not in ("turbo", "mega"):
        raise ValueError(f"sharded artifacts cover the TP engines turbo|mega, got {engine}")
    if arch.skip_channels % mesh_model:
        raise ValueError(f"skip_channels ({arch.skip_channels}) % mesh_model "
                         f"({mesh_model}) != 0")
    if batch % mesh_data:
        raise ValueError(f"batch {batch} % mesh_data {mesh_data} != 0")
    dev = params["embed"].device
    shard_b = batch // mesh_data
    # Rank (0, 0)'s slice, for the programs' shapes: every rank's is alike.
    local = shard_params(params, Mesh(mesh_data, mesh_model, 0, 0, None, None, dev, "none"))
    prep_fn, init_fn, pre_fn, post_fn, reset_fn = _tp_fns(arch, shard_b, temperature,
                                                          with_cond, dev)
    fm = prep_fn(local)
    seed = _i64(0)
    state = init_fn(local, seed)
    cond = ([torch.zeros((shard_b, arch.cond_channels), dtype=compute_dtype(arch),
                         device=dev)] if with_cond else [])
    part = pre_fn(fm, state, *cond)
    blobs = {
        _PREP: _export(prep_fn, (local,)),
        _INIT: _export(init_fn, (local, seed)),
        _STEP: _export(pre_fn, (fm, state, *cond)),
        _POST: _export(post_fn, (fm, state, part)),
        _RESET: _export(reset_fn, (local, state,
                                   torch.zeros((shard_b,), dtype=torch.bool, device=dev))),
    }
    return _write(out_dir, blobs, _base_manifest(
        arch, dev, sharded=True, batch=batch, chunk_size=chunk_size, engine=engine,
        temperature=temperature, with_cond=with_cond, mesh_data=mesh_data,
        mesh_model=mesh_model))


class ShardedServingArtifact:
    """A loaded model-sharded serving artifact, on every rank of a
    (mesh_data, mesh_model) process mesh: `place_params` once per
    checkpoint, `init` once, then `step` forever. Every rank calls each
    method in the same order with the same (global-batch) arguments; step
    returns the global (B, chunk) classes on every rank."""

    def __init__(self, manifest: dict, programs: dict, mesh=None):
        from ..parallel.mesh import make_mesh

        self.manifest = manifest
        self.arch = _from_dict(ArchConfig, manifest["arch"])
        need = manifest["mesh_data"] * manifest["mesh_model"]
        if mesh is None:
            import torch.distributed as dist

            world = dist.get_world_size() if dist.is_initialized() else 1
            if world != need:
                raise ValueError(
                    f"sharded artifact needs {need} ranks ({manifest['mesh_data']}x"
                    f"{manifest['mesh_model']} mesh); this process group has {world}")
            mesh = make_mesh(manifest["mesh_data"], manifest["mesh_model"],
                             device=manifest["device"])
        elif (mesh.data, mesh.model) != (manifest["mesh_data"], manifest["mesh_model"]):
            raise ValueError(f"sharded artifact is for a {manifest['mesh_data']}x"
                             f"{manifest['mesh_model']} mesh, got {mesh.data}x{mesh.model}")
        self.mesh = mesh
        self.shard_b = manifest["batch"] // manifest["mesh_data"]
        self._prep = programs[_PREP].module()
        self._init = programs[_INIT].module()
        self._pre = programs[_STEP].module()
        self._post = programs[_POST].module()
        self._reset = programs[_RESET].module()

    def _rows(self, x, dtype=None):
        lo = self.mesh.data_rank * self.shard_b
        x = torch.as_tensor(x)[lo: lo + self.shard_b]
        return x.to(self.mesh.device, dtype) if dtype else x.to(self.mesh.device)

    def place_params(self, params) -> dict:
        """Whole params -> this rank's skip slice and the TP step's weight
        views ({"params", "fm"}), made once per checkpoint."""
        from ..parallel.mesh import shard_params

        local = shard_params(params, self.mesh)
        return {"params": local, "fm": dict(self._prep(local))}

    def init(self, placed: dict, seed: int) -> dict:
        from ..parallel.mesh import data_shard_seed

        return dict(self._init(placed["params"],
                               _i64(data_shard_seed(int(seed), self.mesh.data_rank))))

    def step(self, placed: dict, state: dict, cond: Optional[torch.Tensor] = None):
        """-> (classes (B, chunk) int32, state) with the global batch's
        classes on every rank; cond (B, chunk, Cc) global."""
        from ..parallel.mesh import all_gather_rows, all_reduce_

        if self.manifest["with_cond"]:
            if cond is None:
                raise ValueError("artifact was exported with_cond: pass cond")
            cond = self._rows(cond, compute_dtype(self.arch))
        elif cond is not None:
            raise ValueError("artifact was exported without cond")
        fm, group = placed["fm"], self.mesh.model_group
        parts = []
        for i in range(self.manifest["chunk_size"]):
            part = self._pre(fm, state, *([] if cond is None else [cond[:, i]]))
            all_reduce_(part, group)
            cls, upd = self._post(fm, state, part)
            state = {**state, **upd}
            parts.append(cls)
        return all_gather_rows(torch.stack(parts, 1), self.mesh), state

    def reset(self, placed: dict, state: dict, lane_mask) -> dict:
        return {**state, **self._reset(placed["params"], state,
                                       self._rows(lane_mask, torch.bool))}


def load_serving(path: str, mesh=None):
    """Load an artifact directory: a ServingArtifact, or a
    ShardedServingArtifact (on the ranks of `mesh`, or of the default
    process group)."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["artifact_version"] != ARTIFACT_VERSION:
        raise ValueError(
            f"artifact version {manifest['artifact_version']} != {ARTIFACT_VERSION}")
    if manifest["torch_version"] != torch.__version__:
        raise ValueError(
            f"artifact was exported under torch {manifest['torch_version']}; this "
            f"process runs torch {torch.__version__}: re-export it here")
    programs = {}
    for name, want in manifest["sha256"].items():
        with open(os.path.join(path, name), "rb") as f:
            blob = f.read()
        got = hashlib.sha256(blob).hexdigest()
        if got != want:
            raise ValueError(
                f"artifact {name} does not match its manifest hash (mixed-generation "
                f"directory from an interrupted re-export?): {got[:12]} != {want[:12]}")
        programs[name] = torch.export.load(io.BytesIO(blob))
    if manifest.get("sharded"):
        return ShardedServingArtifact(manifest, programs, mesh)
    return ServingArtifact(manifest, programs)
