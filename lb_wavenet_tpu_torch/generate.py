"""Autoregressive synthesis engines (port of `lb_wavenet_tpu/generate.py`).

Per-layer RING BUFFERS packed into one (sum(dilations), B, C) tensor: at
step t layer l reads row offset_l + (t mod d_l), which holds h_l(t - d_l),
then overwrites it with h_l(t). PyTorch updates the ring IN PLACE where the
JAX scan carried (and XLA aliased) a new array.

Engines:
  * `naive_sample` — oracle: the full teacher-forced forward on the
    trailing receptive field for every sample (tests only).
  * engine="xla" — the plain PyTorch ring-buffer loop (the reference path).
  * engine="pallas" — the fused all-layer CUDA stack kernel per step
    (ops/cuda/ar_step.py) + post network and sampling in PyTorch.
  * engine="turbo" — one CUDA kernel launch per sample step that runs the
    whole step, sampling included (ops/cuda/ar_turbo.py); any batch.
  * engine="mega" — the whole generation loop in one CUDA kernel
    (ops/cuda/ar_mega.py); the serving default.

Model-sharded synthesis (`model_axis`: the model axis's process group, or a
`parallel.mesh.Mesh`; `parallel/synthesis.py` cuts each rank's skip slice
of w_skip, b_skip and the rows of post.w1): every rank runs the whole stack
down to its slice of the skip sum, and ONE all-reduce per sample step
completes the post network's hidden layer (`post_network_sharded`). The
xla and pallas engines keep their RingState; turbo and mega share the TP
step (`_tp_scan`): kernel B7 (ops/cuda/ar_tp.py) through the local skip
sum, then the all-reduce, sampling and the next step's frontend in
PyTorch, in mega's op order, on a feature-major carry.

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU; without a card they raise. On the CPU the kernel engines run their
kernels' plain versions.

Randomness: `rng` is an int seed (or a torch.Generator). The `xla`/`pallas`
engines sample from a torch.Generator on the device (the JAX threefry chain
is not reproduced); `turbo` and `mega` sample from the stateless per-lane
counter hash, whose bits equal the JAX package's, so per-lane seeds replay
across frameworks and devices.

Conditioning (the mel-conditioned vocoder, speaker conditioning): `cond`
is the upsampled local conditioning (B, T, Cc) at sample rate
(models/conditioning.py; `generate` upsamples `cond_frames` itself) and
`speaker_ids` (B,) index the speaker table. The xla and pallas engines add
cond @ w_cond and speaker_embed[id] @ w_gcond to every gate after the bias,
as the JAX step; the kernel engines see one folded conditioning row per
step and lane, [cond | speaker row] against [w_cond ; w_gcond]
(`_fold_gcond`, the folded weight made once per weight set).

Tacotron 2's WaveNet vocoder (arch.output_dist == "mol", ops/mol.py) runs on
the xla engine, one-shot and streaming: the previous sample goes in as a
real number (RingState.prev_class holds it, float32, and embed_buf the K-1
samples before it), the step's head gives the mixture's 3 n_mix outputs
(what return_logits returns), and the sample is drawn in the span
`mol.sample` from the per-lane counter hash: n_mix + 1 draws a lane step,
n_mix Gumbels for the component and one uniform for its logistic, with
lane seeds derived from the session seed (RingState.seed_base) unless the
caller gives them. "Classes" are then float32 samples on the 16-bit grid.
The other engines and model sharding raise (ops/mol.py ROADMAP_ENGINES).

WAVENET_MEGA_VMEM_D (as in JAX): read once by `generate_classes` and
passed to one-shot mega only, whose kernel then keeps the rings of layers
with 1 < d <= D on chip (ops/cuda/ar_mega.py); every other engine and all
streaming ignore it.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .config import ArchConfig
from .models.wavenet import (
    Params, _mm, compute_dtype, input_step, params_to, post_network, rnd,
)
from .ops.cuda import ar_mega, build
from .ops.cuda.ar_step import buffer_offsets, pallas_stack_step
from .ops.cuda.ar_tp import tp_fused_stack
from .ops.cuda.ar_turbo import turbo_generate
from .ops.cuda.ar_mega import (  # noqa: F401  (the streaming geometry is re-exported)
    LANE_TILE, MEGA_LANE_MULTIPLE, _M32, _mix32, _mul32, _u32, estack_feature_major,
    gumbel_from_bits, mega_generate, mega_zero_carry, padded_stream_batch, sample_fm,
    session_seed_base, stream_lane_multiple,
)
from .ops.cuda.train_stack import LAYER_KEYS
from .ops.mulaw import mu_law_decode
from .ops.numerics import resolve_device  # noqa: F401
from .parallel.mesh import all_reduce_
from .utils.profiling import span

Rng = Union[int, torch.Generator]


def _model_group(model_axis):
    """The process group of a model axis given as the group or as a
    parallel.mesh.Mesh (the port's counterpart of a shard_map axis name)."""
    if isinstance(model_axis, str):
        raise TypeError(
            f"model_axis={model_axis!r}: the port's model axis is a process group "
            "(or a parallel.mesh.Mesh), not an axis name; see parallel/synthesis.py")
    return getattr(model_axis, "model_group", model_axis)


def post_network_sharded(params: Params, skip_local: torch.Tensor, dt, model_axis):
    """Post network over a skip sum SHARDED on its channel dim: skip_local
    is this rank's (B, S/n) slice, post.w1 its (S/n, S) row block. The
    hidden pre-activation is completed with ONE all-reduce over the model
    axis (b1 is added once, after it); w2 and b2 are whole. The entire
    collective cost of model-sharded synthesis, per step."""
    p = params["post"]
    part = all_reduce_(_mm(torch.relu(skip_local), p["w1"], dt), _model_group(model_axis))
    hidden = torch.relu(part + p["b1"])
    return _mm(hidden, p["w2"], dt) + p["b2"]


class RingState(NamedTuple):
    """Carry of the ring-buffer engines; bufs is updated in place."""

    embed_buf: torch.Tensor     # (K-1, B, C): past input-conv embeddings
    bufs: torch.Tensor          # (sum_d, B, C) packed residual history
    prev_class: torch.Tensor    # (B,) int32: sample emitted at t-1 (mol: float32)
    # The sampling generator on the state's device; in an exported program
    # its state tensor (ops/library.py `generator_state`), advanced in place.
    rng: Union[torch.Generator, torch.Tensor]
    seed_base: Optional[int] = None   # mol: the per-lane hash's session seed


def _device_generator(rng, device):
    if isinstance(rng, torch.Generator):
        return rng
    if isinstance(rng, torch.Tensor):  # an exported init's seed input
        from .ops import library

        return library.generator_state(rng, device)
    return torch.Generator(device=device).manual_seed(int(rng))


def _ring_swap(bufs: torch.Tensor, slot, h: torch.Tensor) -> torch.Tensor:
    """Return ring row `slot` (a copy) and write h there. `slot` is an int,
    or a 0-d tensor in an exported program, whose absolute time is an
    input."""
    if isinstance(slot, torch.Tensor):
        idx = slot.reshape(1).to(bufs.device)
        tap = bufs.index_select(0, idx)[0]
        bufs.index_copy_(0, idx, h[None].to(bufs.dtype))
        return tap
    tap = bufs[slot].clone()
    bufs[slot] = h
    return tap


def init_ring_state(arch: ArchConfig, batch: int, rng: Rng,
                    dtype=torch.float32, device="cuda") -> RingState:
    dev = resolve_device(device)
    c = arch.residual_channels
    k = arch.input_kernel
    if arch.mol:   # the zero waveform: sample 0 before the start
        return RingState(
            embed_buf=torch.zeros((k - 1, batch, 1), dtype=dtype, device=dev),
            bufs=torch.zeros((sum(arch.dilations), batch, c), dtype=dtype, device=dev),
            prev_class=torch.zeros((batch,), dtype=torch.float32, device=dev),
            rng=_device_generator(rng, dev), seed_base=_seed_base(rng))
    return RingState(
        embed_buf=torch.zeros((k - 1, batch, c), dtype=dtype, device=dev),
        bufs=torch.zeros((sum(arch.dilations), batch, c), dtype=dtype,
                         device=dev),
        # The zero waveform's class Q//2 (mid-rise upper straddle).
        prev_class=torch.full((batch,), arch.quant_channels // 2,
                              dtype=torch.int32, device=dev),
        rng=_device_generator(rng, dev),
    )


def stack_step(
    params: Params,
    arch: ArchConfig,
    state: RingState,
    t: int,
    x_class: torch.Tensor,
    cond_t: Optional[torch.Tensor] = None,
    gcond: Optional[torch.Tensor] = None,
    model_axis=None,
):
    """One incremental step: class (B,) at time t -> logits (B, Q).

    Mirrors models/wavenet.forward one timestep at a time, with ring reads
    standing in for the d-shifted activations. Returns (new embed_buf,
    bufs (updated in place), logits). With `model_axis` the skip width is
    this rank's slice (w_skip's) and the post network is
    post_network_sharded. cond_t (B, Cc) and gcond (B, E), the step's
    conditioning and the lanes' speaker rows, add their products to every
    gate after the bias, in that order."""
    dt = compute_dtype(arch)
    lp = params["layers"]
    h, new_embed_buf = input_step(params, arch, state.embed_buf, x_class)
    g = lp["w_cur"].shape[-1] // 2
    skip_sum = torch.zeros((h.shape[0], lp["w_skip"].shape[-1]),
                           device=h.device)
    bufs = state.bufs
    for i, (off, d) in enumerate(zip(buffer_offsets(arch), arch.dilations)):
        # For t < d the slot still holds the zero init: the tap reaches
        # before the sequence start, where forward() pads zeros.
        h_prev = _ring_swap(bufs, off + t % d, h)
        pre = _mm(h, lp["w_cur"][i], dt) + _mm(h_prev, lp["w_prev"][i], dt) + lp["b"][i]
        if cond_t is not None:
            pre = pre + _mm(cond_t, lp["w_cond"][i], dt)
        if gcond is not None:
            pre = pre + _mm(gcond, lp["w_gcond"][i], dt)
        z = torch.tanh(pre[..., :g]) * torch.sigmoid(pre[..., g:])
        h = h + _mm(z, lp["w_res"][i], dt) + lp["b_res"][i]
        skip_sum = skip_sum + _mm(z, lp["w_skip"][i], dt) + lp["b_skip"][i]
    if model_axis is not None:
        return new_embed_buf, bufs, post_network_sharded(params, skip_sum, dt, model_axis)
    return new_embed_buf, bufs, post_network(params, skip_sum, dt)


def _sample_class(gen, logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """Draw from softmax(logits / temperature) with `gen` (a torch.Generator,
    or its state tensor in an exported program), or greedy at 0."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    if isinstance(gen, torch.Tensor):
        from .ops import library

        return library.multinomial_(gen, probs)[:, 0].to(torch.int32)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


# ---------------------------------------------------------------------------
# Per-lane counter-based sampling (serving reproducibility tier): a lane's
# noise is a stateless hash of (lane_seed, t_local, class), so a pooled
# request bit-matches a dedicated session with the same seed. The hash is
# THE SAME function as the mega kernel's (ops/cuda/ar_mega.py).

def _perlane_mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    return _mix32(_u32(x))


def perlane_gumbel(lane_seed, t_local, q: int) -> torch.Tensor:
    """(B, Q) Gumbel noise from the per-lane counter hash (batch-major):
    the kernel's feature-major bits with lease time -t_local at t = 0."""
    lane = torch.stack([torch.as_tensor(lane_seed).to(torch.int64),
                        -torch.as_tensor(t_local).to(torch.int64)])
    return gumbel_from_bits(ar_mega._perlane_bits(q, lane, 0)).t()


def _sample_class_perlane(logits, temperature: float, lane_seed, t_local,
                          lane_inv_temp=None):
    """Per-lane-hash sampling; `lane_inv_temp` (B,) f32 gives each lane its
    own inverse temperature, inv == 0 a greedy lane. inv must be the
    host-computed float32(1.0 / tau)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    gum = perlane_gumbel(lane_seed, t_local, logits.shape[-1])
    if lane_inv_temp is not None:
        inv = lane_inv_temp.to(torch.float32)[:, None]
        scores = torch.where(inv > 0.0, logits * inv + gum, logits)
    else:
        inv = torch.tensor(ar_mega._inv_temp(temperature), device=logits.device)
        scores = logits * inv + gum
    return torch.argmax(scores, dim=-1).to(torch.int32)


def perlane_mol_noise(lane_seed, t_local, n_mix: int):
    """(gumbel (B, n_mix), u (B,)) of a mol lane step from the per-lane
    counter hash: features 0 .. n_mix - 1 give the components' Gumbel noise
    and feature n_mix the logistic's uniform ((bits >> 8) + 0.5) 2^-24."""
    lane = torch.stack([torch.as_tensor(lane_seed).to(torch.int64),
                        -torch.as_tensor(t_local).to(torch.int64)])
    bits = ar_mega._perlane_bits(n_mix + 1, lane, 0)
    u = ((bits[n_mix] >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return gumbel_from_bits(bits[:n_mix]).t(), u


def _sample_mol_perlane(y, arch: ArchConfig, temperature: float, lane_seed, t_local):
    """A mol step's samples (B,) float32 from its head outputs y (B, 3 n_mix)."""
    from .ops.mol import sample_mol

    with span("mol.sample"):
        if temperature == 0.0:
            return sample_mol(y, arch.n_mix, 0.0)
        gum, u = perlane_mol_noise(lane_seed, t_local, arch.n_mix)
        return sample_mol(y, arch.n_mix, temperature, gum, u)


def _mol_engine(arch: ArchConfig, engine: str, model_axis=None, per_lane_temp=False) -> None:
    """Refuse what a mol arch does not run: every engine but xla, model
    sharding and per-lane temperatures."""
    if not arch.mol:
        return
    from .ops.mol import ROADMAP_ENGINES

    if engine != "xla" or model_axis is not None or per_lane_temp:
        raise NotImplementedError(
            f"a mol arch generates on the xla engine of one process at one temperature "
            f"(asked: engine {engine!r}{', model-sharded' if model_axis is not None else ''}"
            f"{', per-lane temperatures' if per_lane_temp else ''}); the rest is "
            f"{ROADMAP_ENGINES}")


def decode(out: torch.Tensor, arch: ArchConfig) -> torch.Tensor:
    """Waveform in [-1, 1] of generated output: mu-law classes decoded, or a
    mol arch's samples as they are."""
    return out if arch.mol else mu_law_decode(out, arch.quant_channels)


def derive_lane_seeds(seed_base, batch: int, device="cpu") -> torch.Tensor:
    """Default per-lane seeds for the fused engines' sampled path: one more
    hash round over (seed_base, lane index)."""
    b = torch.arange(batch, dtype=torch.int64, device=device)
    mixed = _mix32((_u32(torch.as_tensor(seed_base).to(device))
                    + _mul32(b, 0xB5297A4D)) & _M32)
    return (mixed & 0x7FFFFFFF).to(torch.int32)


def _pack_lane(lane_seed, lane_t0, lane_inv_temp=None):
    """(2|3, B) int32 lane block: [seeds; lease times; optional f32(1/tau)
    bits]; inv == 0 is a greedy lane."""
    if lane_seed is None:
        return None
    rows = [lane_seed.to(torch.int32), lane_t0.to(torch.int32)]
    if lane_inv_temp is not None:
        rows.append(lane_inv_temp.to(torch.float32).contiguous().view(torch.int32))
    return torch.stack(rows)


def generate_classes(
    params: Params,
    arch: ArchConfig,
    rng: Rng,
    batch: int,
    n_samples: int,
    cond: Optional[torch.Tensor] = None,
    speaker_ids: Optional[torch.Tensor] = None,
    forced: Optional[torch.Tensor] = None,     # (B, T) int32, -1 = free-running
    temperature: float = 1.0,
    return_logits: bool = False,
    engine: str = "xla",
    global_rng: bool = False,
    model_axis=None,
    device="cuda",
):
    """Sample n_samples steps. Returns classes (B, T) int32 [, logits
    (B, T, Q)].

    `forced` primes/teacher-forces: wherever forced[b, t] >= 0 the emitted
    class is overridden (the model still updates its state from it).
    Engines: "xla" | "pallas" | "turbo" | "mega". turbo and mega sample
    by default from the per-lane hash with seeds derived from the session
    seed; global_rng=True switches them to the batch-wide counter hash.
    `cond` (B, T >= n_samples, Cc) is the upsampled local conditioning,
    `speaker_ids` (B,) the speakers.

    `model_axis` (the model axis's process group or Mesh; `params` hold this
    rank's skip slice, as parallel/synthesis.py cuts them): model-sharded
    synthesis, one all-reduce per step. turbo and mega then run the TP step
    (kernel B7), which samples greedy or from the per-lane hash only.

    A mol arch (xla engine only) returns samples (B, T) float32 [, head
    outputs (B, T, 3 n_mix)]; its `forced` is (B, T) float32 samples, NaN
    free-running.
    """
    _mol_engine(arch, engine, model_axis)
    # Read here, once per call, and passed down: one-shot mega uses it.
    vmem_d = int(os.environ.get("WAVENET_MEGA_VMEM_D", "1"))
    dev = resolve_device(device)
    params = params_to(params, dev)
    if forced is not None:
        forced = torch.as_tensor(forced, dtype=torch.float32 if arch.mol else torch.int32
                                 ).to(dev)
    b = int(batch)
    cond = _as_cond(params, cond, b, n_samples, dev)
    gcond = _speaker_rows(params, speaker_ids, dev)
    if model_axis is not None:
        _model_group(model_axis)
    if model_axis is not None and engine in ("turbo", "mega"):
        if return_logits:
            raise ValueError(
                "return_logits is not supported on the model-axis fused TP "
                "path; use engine='pallas' (or 'xla') with model_axis for logits")
        if global_rng and temperature > 0.0:
            raise ValueError(
                "global_rng sampling draws from the batch-wide counter hash inside "
                "the fused kernels, which the TP path's sampler does not "
                "reproduce; use the default per-lane hash (or greedy)")
        return _generate_classes_tp(params, arch, rng, b, n_samples, forced,
                                    temperature, model_axis, cond, gcond)
    if engine == "mega":
        return _generate_classes_mega(
            params, arch, rng, b, n_samples, forced, temperature,
            return_logits, global_rng, cond, gcond, vmem_d,
        )
    if engine == "turbo":
        return _generate_classes_turbo(
            params, arch, rng, b, n_samples, forced, temperature,
            return_logits, global_rng, cond, gcond,
        )
    state = init_ring_state(arch, b, rng, device=dev)
    _, out = _run_scan_engine(
        params, arch, state, 0, n_samples, forced, temperature,
        return_logits, engine, model_axis=model_axis, cond=cond, gcond=gcond,
    )
    if return_logits:
        classes, logits = out
        return classes.t(), logits.transpose(0, 1)
    return out.t()


def _as_cond(params: Params, cond, b: int, n_steps: int, dev, exact: bool = False):
    """The upsampled conditioning as a (B, T, Cc) tensor on `dev`, checked
    to cover n_steps (exactly, for a streaming chunk), or None."""
    if cond is None:
        return None
    if "w_cond" not in params["layers"]:
        raise ValueError("cond given, but the params have no w_cond (arch.n_mels == 0)")
    cond = torch.as_tensor(cond).to(dev)
    if cond.ndim != 3 or cond.shape[0] != b or cond.shape[1] < n_steps or (
            exact and cond.shape[1] != n_steps):
        want = f"(B, {n_steps}, Cc)" if exact else f"(B, T >= {n_steps}, Cc)"
        raise ValueError(f"cond must be {want} with B = {b}, got {tuple(cond.shape)}")
    return cond


def _speaker_rows(params: Params, speaker_ids, dev):
    """The lanes' speaker embeddings (B, E), or None."""
    if speaker_ids is None:
        return None
    if "speaker_embed" not in params:
        raise ValueError("speaker_ids given, but the params have no speaker table "
                         "(arch.n_speakers == 0)")
    return params["speaker_embed"][torch.as_tensor(speaker_ids).to(dev).long()]


def _fold_gcond(lp: dict, cond_ts, gcond, n_steps: Optional[int] = None):
    """Fold the speaker rows gcond (B, E) into the conditioning that the
    kernels see (JAX `_fold_gcond`): cond_ts (T, B, Cc) (or a step's
    (B, Cc) with n_steps None) becomes [cond_ts | gcond] (.., B, Cc + E)
    and lp["w_cond"] becomes [w_cond ; w_gcond] (L, Cc + E, 2G), or with
    gcond alone gcond and w_gcond. The folded weight is made once per
    weight set (build.prepared), so the kernels' packed weights stay cached
    from chunk to chunk. Returns (lp, cond_ts)."""
    if gcond is None:
        return lp, cond_ts
    g = gcond if n_steps is None else gcond[None].expand(n_steps, *gcond.shape)
    if cond_ts is None:
        return {**lp, "w_cond": lp["w_gcond"]}, g
    w = build.prepared("fold_gcond", (lp["w_cond"], lp["w_gcond"]),
                       lambda: torch.cat([lp["w_cond"], lp["w_gcond"]], 1))
    return {**lp, "w_cond": w}, torch.cat([cond_ts, g.to(cond_ts.dtype)], -1)


def _resolve_step_fn(engine: str):
    if engine == "pallas":
        return pallas_stack_step
    if engine == "xla":
        return stack_step
    raise ValueError(f"unknown engine {engine!r}")


def _run_scan_engine(params, arch: ArchConfig, state: RingState, t0: int,
                     n_samples: int, forced, temperature: float,
                     return_logits: bool, engine: str, lane_seed=None,
                     lane_t0=None, lane_inv_temp=None, model_axis=None,
                     cond=None, gcond=None):
    """Run n_samples steps from `state` at absolute time t0 (one-shot and
    streaming chunks share it: ring phase and RNG continue exactly).

    lane_seed/lane_t0 (B,) switch sampling to the per-lane counter hash;
    lane_inv_temp (B,) f32 gives each lane its own inverse temperature.
    cond (B, T, Cc): step i reads cond[:, i] (chunk-local); gcond (B, E).
    Returns (state, classes (T, B)[, logits (T, B, Q)])."""
    step_fn = _resolve_step_fn(engine)
    classes, logits_all = [], []
    embed_buf, prev = state.embed_buf, state.prev_class
    if arch.mol and lane_seed is None:   # lane time == absolute time
        b = state.bufs.shape[1]
        lane_seed = derive_lane_seeds(state.seed_base, b, state.bufs.device)
        lane_t0 = torch.zeros((b,), dtype=torch.int32, device=state.bufs.device)
    for i in range(n_samples):
        t = t0 + i
        embed_buf, _, logits = step_fn(
            params, arch, state._replace(embed_buf=embed_buf), t, prev,
            cond_t=None if cond is None else cond[:, i], gcond=gcond,
            model_axis=model_axis,
        )
        if arch.mol:
            cls = _sample_mol_perlane(logits, arch, temperature, lane_seed,
                                      t - lane_t0.to(torch.int64))
        elif lane_seed is not None:
            cls = _sample_class_perlane(
                logits, temperature, lane_seed, t - lane_t0.to(torch.int64),
                lane_inv_temp=lane_inv_temp,
            )
        else:
            cls = _sample_class(state.rng, logits, temperature)
        if forced is not None:
            free = torch.isnan(forced[:, i]) if arch.mol else forced[:, i] < 0
            cls = torch.where(free, cls, forced[:, i])
        prev = cls
        classes.append(cls)
        if return_logits:
            logits_all.append(logits)
    state = state._replace(embed_buf=embed_buf, prev_class=prev)
    out = torch.stack(classes)
    if return_logits:
        out = (out, torch.stack(logits_all))
    return state, out


def _fused_frontend_zero(params: Params, arch: ArchConfig, batch: int):
    """(h0 (B, C), estack0 (K-1, B, C)) for the zero-class first step of the
    fused engines: only the current tap contributes to h0; the stack is
    zeros except its last row, e(0)."""
    dt = compute_dtype(arch)
    k = arch.input_kernel
    c = arch.residual_channels
    dev = params["embed"].device
    zero_cls = torch.full((batch,), arch.quant_channels // 2,
                          dtype=torch.long, device=dev)
    e0 = params["embed"][zero_cls]
    w_in = params["input_conv"]["w"]
    h0 = params["input_conv"]["b"].to(torch.float32) + _mm(e0, w_in[k - 1], dt)
    estack0 = torch.zeros((k - 1, batch, c), device=dev)
    if k > 1:
        estack0[k - 2] = e0
    return h0, estack0


def _seed_base(rng: Rng):
    """Session seed of the hash samplers, drawn on the host; bounded so
    seed_base + t stays far from int32 overflow. An exported init's seed (a
    0-d tensor) gives it as a 0-d tensor (ops/library.py `seed_base`)."""
    if isinstance(rng, torch.Tensor):
        from .ops import library

        return library.seed_base(rng)
    if not isinstance(rng, torch.Generator):
        return session_seed_base(int(rng))
    return int(torch.randint(0, np.iinfo(np.int32).max // 2, (),
                             generator=rng, device=rng.device))


def _forced_ts(forced, n: int, b: int, device) -> torch.Tensor:
    """(T, B) int32 time-major forced classes, -1 (free-running) when none."""
    if forced is None:
        return torch.full((n, b), -1, dtype=torch.int32, device=device)
    return forced[:, :n].t().contiguous()


def _cond_ts(cond, n_steps: int):
    """(B, T, Cc) -> time-major (n_steps, B, Cc), or None."""
    return None if cond is None else cond[:, :n_steps].transpose(0, 1)


def _generate_classes_mega(params, arch, rng, b, n_samples, forced,
                           temperature, return_logits, global_rng, cond=None,
                           gcond=None, vmem_d: int = 1):
    """One-shot mega: lanes padded to the kernel's lane tile (pad lanes are
    forced to class 0, conditioned on zeros, and dropped); the rings of
    layers with 1 < d <= vmem_d on chip."""
    dev = params["embed"].device
    forced_ts = _forced_ts(forced, n_samples, b, dev)
    lp, cond_ts = _fold_gcond(params["layers"], _cond_ts(cond, n_samples), gcond,
                              n_samples)
    h0, e0 = _fused_frontend_zero(params, arch, b)
    seed_base = _seed_base(rng)
    pad = (-b) % LANE_TILE
    if pad:
        forced_ts = torch.cat([
            forced_ts,
            torch.zeros((n_samples, pad), dtype=torch.int32, device=dev),
        ], 1)
        if cond_ts is not None:
            cond_ts = torch.cat([cond_ts, cond_ts.new_zeros(
                (n_samples, pad, cond_ts.shape[-1]))], 1)
        h0 = torch.cat([h0, h0[:1].expand(pad, -1)], 0)
        e0 = torch.cat([e0, e0[:, :1].expand(-1, pad, -1)], 1)
    lane = None
    if temperature > 0.0 and not global_rng:
        lane = torch.stack([
            derive_lane_seeds(seed_base, b + pad, dev),
            torch.zeros((b + pad,), dtype=torch.int32, device=dev),
        ])
    out = mega_generate(
        params, lp, arch, h0, e0, seed_base,
        forced_ts[:, None, :], cond_ts, n_samples, temperature, cond_ts is not None,
        emit_logits=return_logits, lane=lane, vmem_d=vmem_d,
    )
    if return_logits:
        classes, logits = out
        return classes[:, 0, :b].t(), logits.permute(2, 0, 1)[:b]
    return out[:, 0, :b].t()


def _generate_classes_turbo(params, arch, rng, b, n_samples, forced,
                            temperature, return_logits, global_rng, cond=None,
                            gcond=None):
    """One-shot turbo from the zero-class frontend and empty rings; per-lane
    seeds derived from the session seed unless global_rng."""
    dev = params["embed"].device
    forced_ts = _forced_ts(forced, n_samples, b, dev)
    lp, cond_ts = _fold_gcond(params["layers"], _cond_ts(cond, n_samples), gcond,
                              n_samples)
    h0, e0 = _fused_frontend_zero(params, arch, b)
    state = {"bufs": torch.zeros((sum(arch.dilations), b, arch.residual_channels),
                                 device=dev), "e": e0, "h": h0}
    seed_base = _seed_base(rng)
    lane = None
    if temperature > 0.0 and not global_rng:
        lane = torch.stack([derive_lane_seeds(seed_base, b, dev),
                            torch.zeros((b,), dtype=torch.int32, device=dev)])
    classes, logits = turbo_generate(params, lp, arch, state, 0, forced_ts,
                                     temperature, return_logits, lane, seed_base, cond_ts)
    if return_logits:
        return classes.t(), logits.transpose(0, 1)
    return classes.t()


# ---------------------------------------------------------------------------
# Model-sharded turbo/mega: the TP step (JAX `_tp_scan` and its callers).

def _tr(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _tp_weights(params: Params, lp: dict, dt: torch.dtype) -> dict:
    """Feature-major weights of the TP step, made once per weight set. The
    kernel's views are JAX's (`_tp_weights`): wcat (L, 2G, 2C), b, wrs
    (L, C+S_l, G) (the skip part is this rank's slice) and brs. The post
    network's and the frontend's matrices (w1T (S, S_l), w2T, embT, wicurT,
    wipastT) are held already rounded to the compute dtype, which their
    products would otherwise do on every step. With the folded lp["w_cond"]
    (L, Cc', 2G), wcond (L, 2G, Cc') too: the gate is not split, so every
    rank holds all of it."""
    pp, ic = params["post"], params["input_conv"]
    k = ic["w"].shape[0]

    def make():
        return {
            **({"wcond": _tr(lp["w_cond"])} if "w_cond" in lp else {}),
            "wcat": _tr(torch.cat([lp["w_cur"], lp["w_prev"]], 1)),
            "b": lp["b"][:, :, None],
            "wrs": torch.cat([_tr(lp["w_res"]), _tr(lp["w_skip"])], 1),
            "brs": torch.cat([lp["b_res"], lp["b_skip"]], 1)[:, :, None],
            "w1T": rnd(_tr(pp["w1"]), dt).contiguous(),
            "b1": pp["b1"][:, None],
            "w2T": rnd(_tr(pp["w2"]), dt).contiguous(),
            "b2": pp["b2"][:, None],
            "embT": rnd(_tr(params["embed"]), dt).contiguous(),
            "wicurT": rnd(_tr(ic["w"][k - 1]), dt).contiguous(),
            "bi": ic["b"][:, None],
            "wipastT": rnd(_tr(ic["w"][: k - 1]), dt).contiguous(),
        }

    sources = (*(lp[n] for n in LAYER_KEYS), *(pp[n] for n in ("w1", "b1", "w2", "b2")),
               params["embed"], ic["w"], ic["b"]) + ((lp["w_cond"],) if "w_cond" in lp else ())
    return build.prepared(f"tp_weights {dt}", sources, make)


def _tp_zero_state(params: Params, arch: ArchConfig, batch: int) -> dict:
    """The TP carry of a fresh session, feature-major (lanes last) as JAX's:
    empty rings (sum_d, C, B), h (C, B) and the embedding stack ((K-1)C, B)
    from the zero class."""
    h0, e0 = _fused_frontend_zero(params, arch, batch)
    return {
        "bufs": torch.zeros((sum(arch.dilations), arch.residual_channels, batch),
                            device=h0.device),
        "h": h0.t().to(torch.float32).contiguous(),
        "e_s": estack_feature_major(e0).contiguous(),
    }


def _tp_partial(fm: dict, skip_local: torch.Tensor, dt) -> torch.Tensor:
    """This rank's partial product (S, B) of the post network's first layer
    from its local skip sum: the operand of the step's one all-reduce."""
    return fm["w1T"] @ rnd(torch.relu(skip_local), dt)


def _tp_finish(fm: dict, part: torch.Tensor, dt) -> torch.Tensor:
    """(Q, B) logits from the all-reduced partial product: relu(. + b1)
    and the second layer (post_network_sharded, feature-major)."""
    hidden = torch.relu(part + fm["b1"])
    return fm["w2T"] @ rnd(hidden, dt) + fm["b2"]


def _tp_logits(fm: dict, skip_local: torch.Tensor, group, dt) -> torch.Tensor:
    """(Q, B) logits from the local skip sum, ONE all-reduce over the model
    axis between the post network's two halves."""
    return _tp_finish(fm, all_reduce_(_tp_partial(fm, skip_local, dt), group), dt)


def _tp_next_frontend(fm: dict, state: dict, cls: torch.Tensor, dt) -> None:
    """The next step's residual input from the sampled classes, in place:
    h = (bi + wicurT @ e) + sum_j wipastT[j] @ e_s[j], then the embedding
    stack shifts and takes e (mega's frontend)."""
    e_s = state["e_s"]
    c = state["h"].shape[0]
    e_next = fm["embT"][:, cls.long()]
    h = fm["bi"] + fm["wicurT"] @ e_next
    for j in range(fm["wipastT"].shape[0]):
        h = h + fm["wipastT"][j] @ rnd(e_s[j * c: (j + 1) * c], dt)
    if e_s.shape[0]:
        e_s[:-c] = e_s[c:].clone()
        e_s[-c:] = e_next
    state["h"].copy_(h)


def _tp_scan(fm: dict, arch: ArchConfig, state: dict, t0: int, forced_ts,
             temperature: float, model_axis, lane=None, cond_ts=None) -> torch.Tensor:
    """Steps t0 .. t0 + T - 1 of the TP step: kernel B7 through the LOCAL
    skip sum, one all-reduce completing the post hidden, sampling (greedy
    or the per-lane hash with the (2|3, B) lane block: ar_mega.sample_fm,
    JAX's `_perlane_gumbel_fm` noise and first-max argmax) and the next
    step's frontend, in the JAX op order. state {"bufs" (sum_d, C, B), "h"
    (C, B), "e_s" ((K-1)C, B)} is updated in place; forced_ts (T, B) int32;
    cond_ts (T, B, Cc') the folded conditioning (with fm["wcond"]), step i
    reading row i. Returns classes (T, B) int32."""
    dt = compute_dtype(arch)
    group = _model_group(model_axis)
    classes = torch.empty(forced_ts.shape, dtype=torch.int32, device=state["h"].device)
    cond_fm = None if cond_ts is None else cond_ts.transpose(1, 2).to(dt).contiguous()
    for i in range(forced_ts.shape[0]):
        t = t0 + i
        _, skip_local = tp_fused_stack(fm, arch, state["h"], state["bufs"], t,
                                       None if cond_fm is None else cond_fm[i])
        logits = _tp_logits(fm, skip_local, group, dt)
        classes[i] = sample_fm(logits, temperature, lane, t, 0, forced_ts[i])
        _tp_next_frontend(fm, state, classes[i], dt)
    return classes


def _generate_classes_tp(params, arch, rng, b, n_samples, forced, temperature,
                         model_axis, cond=None, gcond=None):
    """One-shot model-sharded turbo/mega from a fresh TP carry; per-lane
    seeds derived from the session seed when sampling."""
    dev = params["embed"].device
    state = _tp_zero_state(params, arch, b)
    lane = None
    if temperature > 0.0:
        lane = torch.stack([derive_lane_seeds(_seed_base(rng), b, dev),
                            torch.zeros((b,), dtype=torch.int32, device=dev)])
    lp, cond_ts = _fold_gcond(params["layers"], _cond_ts(cond, n_samples), gcond,
                              n_samples)
    fm = _tp_weights(params, lp, compute_dtype(arch))
    return _tp_scan(fm, arch, state, 0, _forced_ts(forced, n_samples, b, dev),
                    temperature, model_axis, lane, cond_ts).t()


def _tp_stream_chunk(params, arch, stream, chunk_size: int, forced, temperature: float,
                     model_axis, lane_seed=None, lane_t0=None, lane_inv_temp=None,
                     cond=None, gcond=None):
    """One model-sharded chunk of the TP step at ABSOLUTE time stream.t + i
    (ring slots and the per-lane hash), so chunked output equals the
    one-shot TP run; the carry is updated in place."""
    st = stream.state
    b = st["h"].shape[-1]
    lp, cond_ts = _fold_gcond(params["layers"], _cond_ts(cond, chunk_size), gcond,
                              chunk_size)
    fm = _tp_weights(params, lp, compute_dtype(arch))
    forced_ts = _forced_ts(forced, chunk_size, b, st["h"].device)
    classes = _tp_scan(fm, arch, st, stream.t, forced_ts, temperature, model_axis,
                       _pack_lane(lane_seed, lane_t0, lane_inv_temp), cond_ts)
    return classes.t(), Stream(st, stream.t + chunk_size)


def _tp_reset_lanes(params, arch, stream, mask):
    """reset_lanes of the TP carry, in place: the masked lanes (columns)
    take empty rings and the zero-class frontend."""
    st = stream.state
    h0, e0 = _fused_frontend_zero(params, arch, st["h"].shape[-1])
    col = mask[None, :]
    st["bufs"].masked_fill_(mask[None, None, :], 0.0)
    st["h"].copy_(torch.where(col, h0.t(), st["h"]))
    st["e_s"].copy_(torch.where(col, estack_feature_major(e0), st["e_s"]))
    return stream


class Stream(NamedTuple):
    """Carried state of a streaming session: a RingState (xla/pallas), a
    {"bufs", "e", "h", "seed_base"} dict (turbo), a {"carry", "seed_base"}
    dict (mega) or, for model-sharded turbo/mega, the feature-major TP
    carry {"bufs", "h", "e_s", "seed_base"}. Pass the SAME engine (and
    model axis) to every stream_chunk of a session. Chunks update the state
    in place."""

    state: object
    t: int  # absolute sample index of the next step


def start_stream(arch: ArchConfig, batch: int, rng: Rng, engine: str = "xla",
                 params: Optional[Params] = None,
                 model_axis=None, device="cuda") -> Stream:
    """Open a streaming session (see stream_chunk). turbo and mega need
    `params` to seed their carry; mega needs batch % MEGA_LANE_MULTIPLE == 0
    (open it at padded_stream_batch and slice the pad lanes off, as
    SessionPool does), turbo streams at any batch. With `model_axis`
    (params: this rank's skip slice) turbo and mega carry the TP step's
    state instead, at any batch; xla and pallas keep their RingState. A mol
    arch streams on xla only."""
    _mol_engine(arch, engine, model_axis)
    dev = resolve_device(device)
    if engine in ("mega", "turbo"):
        if params is None:
            raise ValueError(f"start_stream(engine='{engine}') needs params")
        params = params_to(params, dev)
        if model_axis is not None:
            _model_group(model_axis)
            state = _tp_zero_state(params, arch, batch)
            state["seed_base"] = _seed_base(rng)
            return Stream(state, 0)
        h0, e0 = _fused_frontend_zero(params, arch, batch)
        if engine == "mega":
            state = {"carry": mega_zero_carry(arch, h0, e0)}
        else:
            state = {"bufs": torch.zeros((sum(arch.dilations), batch,
                                          arch.residual_channels), device=dev),
                     "e": e0, "h": h0}
        state["seed_base"] = _seed_base(rng)
        return Stream(state, 0)
    if engine not in ("xla", "pallas"):
        raise ValueError(f"unknown engine {engine!r}")
    return Stream(init_ring_state(arch, batch, rng, device=dev), 0)


def _as_lanes(x, dtype, device):
    return None if x is None else torch.as_tensor(x).to(device, dtype)


def stream_chunk(
    params: Params,
    arch: ArchConfig,
    stream: Stream,
    chunk_size: int,
    cond: Optional[torch.Tensor] = None,
    speaker_ids: Optional[torch.Tensor] = None,
    forced: Optional[torch.Tensor] = None,     # (B, chunk), -1 = free-running
    temperature: float = 1.0,
    engine: str = "xla",
    return_logits: bool = False,
    lane_seed=None,                             # (B,) int32 per-lane seeds
    lane_t0=None,                               # (B,) int32 lane lease times
    global_rng: bool = False,
    model_axis=None,
    lane_inv_temp=None,                         # (B,) f32 1/tau (0 = greedy)
):
    """Emit the next chunk_size samples; returns (classes (B, chunk)[,
    logits (B, chunk, Q)], new_stream). The session state is updated in
    place; ring phase and sampling counters continue across chunks, so the
    concatenated output equals one generate_classes call of the same
    length. turbo and mega default to per-lane seeds derived from the
    session seed (lane time == absolute time); explicit lane_seed/lane_t0
    override them; global_rng=True uses the batch-wide counter hash.
    `model_axis` as in generate_classes (turbo/mega: the TP step, greedy or
    per-lane sampling only). `cond` (B, chunk_size, Cc) covers exactly this
    chunk (the caller slices the upsampled conditioning to the chunk's
    span); `speaker_ids` (B,) as in generate_classes."""
    _mol_engine(arch, engine, model_axis, lane_inv_temp is not None)
    tp = model_axis is not None and engine in ("mega", "turbo")
    if model_axis is not None:
        _model_group(model_axis)
    if tp and return_logits:
        raise ValueError("return_logits is not supported on the model-axis fused TP path")
    if tp and global_rng and temperature > 0.0:
        raise ValueError(
            "global_rng sampling is not available under model-axis streaming; "
            "use per-lane seeds (the default) or greedy")
    if forced is not None and forced.shape[1] != chunk_size:
        raise ValueError(
            f"stream_chunk forced must be (B, {chunk_size}), got "
            f"{tuple(forced.shape)}"
        )
    if (lane_seed is None) != (lane_t0 is None):
        raise ValueError("pass lane_seed and lane_t0 together")
    if lane_inv_temp is not None:
        if temperature <= 0.0:
            raise ValueError(
                "lane_inv_temp needs a sampled session (static "
                "temperature > 0); greedy lanes are inv == 0"
            )
        if global_rng:
            raise ValueError("lane_inv_temp needs per-lane sampling, "
                             "not global_rng")
    if tp:
        dev = stream.state["h"].device
        b_dev = stream.state["h"].shape[-1]
    elif engine == "mega":
        carry = stream.state["carry"]
        dev = carry["h_s"].device
        b_dev = carry["h_s"].shape[-1]
    elif engine == "turbo":
        dev = stream.state["h"].device
        b_dev = stream.state["h"].shape[0]
    else:
        dev = stream.state.bufs.device
    params = params_to(params, dev)
    b_lanes = b_dev if (tp or engine in ("mega", "turbo")) else stream.state.bufs.shape[1]
    cond = _as_cond(params, cond, b_lanes, chunk_size, dev, exact=True)
    gcond = _speaker_rows(params, speaker_ids, dev)
    lane_seed = _as_lanes(lane_seed, torch.int32, dev)
    lane_t0 = _as_lanes(lane_t0, torch.int32, dev)
    lane_inv_temp = _as_lanes(lane_inv_temp, torch.float32, dev)
    if forced is not None:
        forced = torch.as_tensor(forced).to(dev, torch.float32 if arch.mol else torch.int32)

    if engine in ("mega", "turbo") and lane_seed is None and (
            temperature > 0.0 and not global_rng):
        # The one-shot default: per-lane hash, seeds derived from the session
        # seed, lane time == absolute time (chunked output equals one-shot).
        lane_seed = derive_lane_seeds(stream.state["seed_base"], b_dev, dev)
        lane_t0 = torch.zeros((b_dev,), dtype=torch.int32, device=dev)
    if tp:
        return _tp_stream_chunk(params, arch, stream, chunk_size, forced, temperature,
                                model_axis, lane_seed, lane_t0, lane_inv_temp, cond, gcond)
    if engine == "mega":
        return _mega_stream_chunk(
            params, arch, stream, chunk_size, forced, temperature,
            return_logits, lane_seed, lane_t0, lane_inv_temp, cond, gcond,
        )
    if engine == "turbo":
        return _turbo_stream_chunk(
            params, arch, stream, chunk_size, forced, temperature,
            return_logits, lane_seed, lane_t0, lane_inv_temp, cond, gcond,
        )
    if lane_inv_temp is not None and lane_seed is None:
        raise ValueError(
            "lane_inv_temp on the scan engines needs explicit "
            "lane_seed/lane_t0 (the per-lane sampling path)"
        )
    new_state, out = _run_scan_engine(
        params, arch, stream.state, stream.t, chunk_size, forced,
        temperature, return_logits, engine, lane_seed=lane_seed,
        lane_t0=lane_t0, lane_inv_temp=lane_inv_temp, model_axis=model_axis,
        cond=cond, gcond=gcond,
    )
    new_stream = Stream(new_state, stream.t + chunk_size)
    if return_logits:
        classes, logits = out
        return classes.t(), logits.transpose(0, 1), new_stream
    return out.t(), new_stream


def _mega_stream_chunk(params, arch, stream: Stream, chunk_size: int, forced,
                       temperature: float, return_logits: bool,
                       lane_seed=None, lane_t0=None, lane_inv_temp=None,
                       cond=None, gcond=None):
    """One mega chunk: the whole chunk in ONE launch, carrying (ring, staged
    pairs, frontend) between chunks at ABSOLUTE time stream.t + step; the
    chunk's cond row t is read at its chunk-local step t."""
    carry = stream.state["carry"]
    b = carry["h_s"].shape[-1]
    dev = carry["h_s"].device
    if b % LANE_TILE:
        raise ValueError(
            f"mega streaming needs batch % {LANE_TILE} == 0, got {b}; open "
            "the session at padded_stream_batch(batch, 'mega')"
        )
    forced_ts = _forced_ts(forced, chunk_size, b, dev)
    lp, cond_ts = _fold_gcond(params["layers"], _cond_ts(cond, chunk_size), gcond,
                              chunk_size)
    out = mega_generate(
        params, lp, arch, None, None,
        stream.state["seed_base"], forced_ts[:, None, :], cond_ts, chunk_size,
        temperature, cond_ts is not None, emit_logits=return_logits, streaming=True,
        carry=carry, t0=stream.t,
        lane=_pack_lane(lane_seed, lane_t0, lane_inv_temp),
    )
    if return_logits:
        classes, logits, new_carry = out
    else:
        classes, new_carry = out
    new_stream = Stream(
        {"carry": new_carry, "seed_base": stream.state["seed_base"]},
        stream.t + chunk_size,
    )
    cls_bt = classes[:, 0, :].t()
    if return_logits:
        return cls_bt, logits.permute(2, 0, 1), new_stream
    return cls_bt, new_stream


def _turbo_stream_chunk(params, arch, stream: Stream, chunk_size: int, forced,
                        temperature: float, return_logits: bool, lane_seed=None,
                        lane_t0=None, lane_inv_temp=None, cond=None, gcond=None):
    """One turbo chunk: a launch per step at ABSOLUTE time stream.t + i
    (ring slots and sampling counters follow absolute time, so chunked
    output continues the one-shot sequence), carrying (rings, embedding
    stack, h) between chunks in place."""
    st = stream.state
    b = st["h"].shape[0]
    forced_ts = _forced_ts(forced, chunk_size, b, st["h"].device)
    lp, cond_ts = _fold_gcond(params["layers"], _cond_ts(cond, chunk_size), gcond,
                              chunk_size)
    classes, logits = turbo_generate(
        params, lp, arch, st, stream.t, forced_ts, temperature,
        return_logits, _pack_lane(lane_seed, lane_t0, lane_inv_temp), st["seed_base"],
        cond_ts,
    )
    new_stream = Stream(st, stream.t + chunk_size)
    if return_logits:
        return classes.t(), logits.transpose(0, 1), new_stream
    return classes.t(), new_stream


def reset_lanes(params: Params, arch: ArchConfig, stream: Stream,
                lane_mask, engine: str = "xla", model_axis=None) -> Stream:
    """Continuous batching: reset the masked lanes to a fresh session start,
    in place. Each ring slot is read before it is written, so a lane whose
    ring columns are zero sees exactly the zero pre-start context of a t=0
    session at any global phase: a recycled lane's greedy/teacher-forced
    (and per-lane sampled) output equals a fresh session's. With
    `model_axis`, turbo and mega reset the TP carry (params: this rank's
    skip slice)."""
    # masked_fill_/where rather than boolean indexing: no host sync.
    if model_axis is not None and engine in ("mega", "turbo"):
        dev = stream.state["h"].device
        return _tp_reset_lanes(params_to(params, dev), arch, stream,
                               torch.as_tensor(lane_mask).to(dev, torch.bool))
    if engine in ("xla", "pallas"):
        rs: RingState = stream.state
        mask = torch.as_tensor(lane_mask).to(rs.bufs.device, torch.bool)
        rs.embed_buf.masked_fill_(mask[None, :, None], 0.0)
        rs.bufs.masked_fill_(mask[None, :, None], 0.0)
        rs.prev_class.masked_fill_(mask, 0.0 if arch.mol else arch.quant_channels // 2)
        return stream
    if engine == "mega":
        carry = stream.state["carry"]
        dev = carry["h_s"].device
        col = torch.as_tensor(lane_mask).to(dev, torch.bool)[None, :]
        params = params_to(params, dev)
        h0, e0 = _fused_frontend_zero(params, arch, carry["h_s"].shape[-1])
        carry["bufs"].masked_fill_(col, 0.0)
        carry["hstate"].masked_fill_(col, 0.0)
        carry["h_s"].copy_(torch.where(col, h0.t(), carry["h_s"]))
        carry["e_s"].copy_(
            torch.where(col, estack_feature_major(e0), carry["e_s"])
        )
        return stream
    if engine == "turbo":
        st = stream.state
        dev = st["h"].device
        mask = torch.as_tensor(lane_mask).to(dev, torch.bool)
        params = params_to(params, dev)
        h0, e0 = _fused_frontend_zero(params, arch, st["h"].shape[0])
        st["bufs"].masked_fill_(mask[None, :, None], 0.0)
        st["e"].copy_(torch.where(mask[None, :, None], e0, st["e"]))
        st["h"].copy_(torch.where(mask[:, None], h0, st["h"]))
        return stream
    raise ValueError(f"unknown engine {engine!r}")


def generate_streaming(params: Params, arch: ArchConfig, rng: Rng, batch: int,
                       chunk_size: int, n_chunks: Optional[int] = None,
                       temperature: float = 1.0, engine: str = "xla",
                       device="cuda"):
    """Host-side generator of decoded wav chunks (B, chunk_size) in [-1, 1]
    — unbounded when n_chunks is None."""
    stream = start_stream(arch, batch, rng, engine=engine, params=params,
                          device=device)
    i = 0
    while n_chunks is None or i < n_chunks:
        classes, stream = stream_chunk(
            params, arch, stream, chunk_size, temperature=temperature,
            engine=engine,
        )
        yield decode(classes, arch)
        i += 1


def generate(params: Params, arch: ArchConfig, rng: Rng, batch: int,
             n_samples: int, cond_frames=None, speaker_ids=None, forced=None,
             temperature: float = 1.0, engine: str = "xla",
             global_rng: bool = False, device="cuda") -> torch.Tensor:
    """Synthesize waveforms (B, n_samples) in [-1, 1]; `forced` primes the
    generator (forced[b, t] >= 0 is emitted and fed back, -1 free-runs).
    `cond_frames` (B, F, n_mels) frame-rate features are upsampled once
    (models/conditioning.upsample_cond, F * hop >= n_samples) and condition
    every step; `speaker_ids` (B,) pick the speakers. A mol arch's samples
    come as they are (xla engine only)."""
    cond = None
    if cond_frames is not None:
        from .models.conditioning import upsample_cond

        dev = resolve_device(device)
        params = params_to(params, dev)
        frames = torch.as_tensor(cond_frames, dtype=torch.float32).to(dev)
        cond = upsample_cond(params["upsampler"], arch, frames, compute_dtype(arch))
    classes = generate_classes(
        params, arch, rng, batch, n_samples, cond=cond, speaker_ids=speaker_ids,
        forced=forced, temperature=temperature, engine=engine,
        global_rng=global_rng, device=device,
    )
    return decode(classes, arch)


def naive_sample(params: Params, arch: ArchConfig, rng: Rng, batch: int,
                 n_samples: int, temperature: float = 1.0,
                 return_logits: bool = False, device="cuda"):
    """Oracle sampler: the full-context forward per emitted sample, O(T R)
    work, drawing from the same generator sequence as the xla engine."""
    from .models.wavenet import forward

    dev = resolve_device(device)
    params = params_to(params, dev)
    gen = _device_generator(rng, dev)
    zero_cls = arch.quant_channels // 2
    history = torch.full((batch, n_samples + 1), zero_cls, dtype=torch.int32,
                         device=dev)
    all_logits = []
    for t in range(n_samples):
        window = history[:, : t + 1][:, -arch.receptive_field:]
        logits = forward(params, arch, window)[:, -1]
        all_logits.append(logits)
        history[:, t + 1] = _sample_class(gen, logits, temperature)
    classes = history[:, 1:]
    if return_logits:
        return classes, torch.stack(all_logits, dim=1)
    return classes
