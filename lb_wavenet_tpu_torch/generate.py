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
  * engine="mega" — the whole generation loop in one CUDA kernel
    (ops/cuda/ar_mega.py); the serving default.

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU; without a card they raise. On the CPU the kernel engines run their
kernels' plain versions.

Randomness: `rng` is an int seed (or a torch.Generator). The `xla`/`pallas`
engines sample from a torch.Generator on the device (the JAX threefry chain
is not reproduced); `mega` samples from the stateless per-lane counter hash,
whose bits equal the JAX package's, so per-lane seeds replay across
frameworks and devices.

Not ported yet (raise NotImplementedError, see ROADMAP.md): turbo,
model_axis, cond/speaker_ids, and the TPU VMEM-ring layout
WAVENET_MEGA_VMEM_D > 1.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .config import ArchConfig
from .models.wavenet import (
    Params, _mm, compute_dtype, input_step, params_to, post_network,
)
from .ops.cuda import ar_mega
from .ops.cuda.ar_step import buffer_offsets, pallas_stack_step
from .ops.cuda.ar_mega import (
    LANE_TILE, _M32, _mix32, _mul32, _u32, estack_feature_major,
    gumbel_from_bits, mega_generate, mega_zero_carry,
)
from .ops.mulaw import mu_law_decode

Rng = Union[int, torch.Generator]


def resolve_device(device) -> torch.device:
    """The torch.device to run on; a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch paths on the CPU"
        )
    return dev


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


class RingState(NamedTuple):
    """Carry of the ring-buffer engines; bufs is updated in place."""

    embed_buf: torch.Tensor     # (K-1, B, C): past input-conv embeddings
    bufs: torch.Tensor          # (sum_d, B, C) packed residual history
    prev_class: torch.Tensor    # (B,) int32: sample emitted at t-1
    rng: torch.Generator        # sampling generator on the state's device


def _device_generator(rng: Rng, device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(int(rng))


def init_ring_state(arch: ArchConfig, batch: int, rng: Rng,
                    dtype=torch.float32, device="cuda") -> RingState:
    dev = resolve_device(device)
    c = arch.residual_channels
    k = arch.input_kernel
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
    model_axis: Optional[str] = None,
):
    """One incremental step: class (B,) at time t -> logits (B, Q).

    Mirrors models/wavenet.forward one timestep at a time, with ring reads
    standing in for the d-shifted activations. Returns (new embed_buf,
    bufs (updated in place), logits)."""
    if cond_t is not None or gcond is not None:
        raise _not_ported("conditioning", "A9")
    if model_axis is not None:
        raise _not_ported("model_axis", "A12")
    dt = compute_dtype(arch)
    lp = params["layers"]
    h, new_embed_buf = input_step(params, arch, state.embed_buf, x_class)
    g = lp["w_cur"].shape[-1] // 2
    skip_sum = torch.zeros((h.shape[0], lp["w_skip"].shape[-1]),
                           device=h.device)
    bufs = state.bufs
    for i, (off, d) in enumerate(zip(buffer_offsets(arch), arch.dilations)):
        slot = off + t % d
        # For t < d the slot still holds the zero init: the tap reaches
        # before the sequence start, where forward() pads zeros.
        h_prev = bufs[slot].clone()
        bufs[slot] = h
        pre = _mm(h, lp["w_cur"][i], dt) + _mm(h_prev, lp["w_prev"][i], dt) + lp["b"][i]
        z = torch.tanh(pre[..., :g]) * torch.sigmoid(pre[..., g:])
        h = h + _mm(z, lp["w_res"][i], dt) + lp["b_res"][i]
        skip_sum = skip_sum + _mm(z, lp["w_skip"][i], dt) + lp["b_skip"][i]
    return new_embed_buf, bufs, post_network(params, skip_sum, dt)


def _sample_class(gen: torch.Generator, logits: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
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


def _check_env():
    if int(os.environ.get("WAVENET_MEGA_VMEM_D", "1")) > 1:
        raise _not_ported("the TPU VMEM-ring layout (WAVENET_MEGA_VMEM_D > 1)",
                          "B2")


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
    model_axis: Optional[str] = None,
    device="cuda",
):
    """Sample n_samples steps. Returns classes (B, T) int32 [, logits
    (B, T, Q)].

    `forced` primes/teacher-forces: wherever forced[b, t] >= 0 the emitted
    class is overridden (the model still updates its state from it).
    Engines: "xla" | "pallas" | "mega". mega samples
    by default from the per-lane hash with seeds derived from the session
    seed; global_rng=True switches it to the batch-wide counter hash.
    """
    _check_env()
    if cond is not None or speaker_ids is not None:
        raise _not_ported("conditioning", "A9")
    if model_axis is not None:
        raise _not_ported("model_axis", "A12")
    if engine == "turbo":
        raise _not_ported("engine 'turbo'", "B6")
    dev = resolve_device(device)
    params = params_to(params, dev)
    if forced is not None:
        forced = torch.as_tensor(forced, dtype=torch.int32).to(dev)
    b = int(batch)
    if engine == "mega":
        return _generate_classes_mega(
            params, arch, rng, b, n_samples, forced, temperature,
            return_logits, global_rng,
        )
    state = init_ring_state(arch, b, rng, device=dev)
    _, out = _run_scan_engine(
        params, arch, state, 0, n_samples, forced, temperature,
        return_logits, engine,
    )
    if return_logits:
        classes, logits = out
        return classes.t(), logits.transpose(0, 1)
    return out.t()


def _resolve_step_fn(engine: str):
    if engine == "pallas":
        return pallas_stack_step
    if engine == "xla":
        return stack_step
    raise ValueError(f"unknown engine {engine!r}")


def _run_scan_engine(params, arch: ArchConfig, state: RingState, t0: int,
                     n_samples: int, forced, temperature: float,
                     return_logits: bool, engine: str, lane_seed=None,
                     lane_t0=None, lane_inv_temp=None):
    """Run n_samples steps from `state` at absolute time t0 (one-shot and
    streaming chunks share it: ring phase and RNG continue exactly).

    lane_seed/lane_t0 (B,) switch sampling to the per-lane counter hash;
    lane_inv_temp (B,) f32 gives each lane its own inverse temperature.
    Returns (state, classes (T, B)[, logits (T, B, Q)])."""
    step_fn = _resolve_step_fn(engine)
    classes, logits_all = [], []
    embed_buf, prev = state.embed_buf, state.prev_class
    for i in range(n_samples):
        t = t0 + i
        embed_buf, _, logits = step_fn(
            params, arch, state._replace(embed_buf=embed_buf), t, prev
        )
        if lane_seed is not None:
            cls = _sample_class_perlane(
                logits, temperature, lane_seed, t - lane_t0.to(torch.int64),
                lane_inv_temp=lane_inv_temp,
            )
        else:
            cls = _sample_class(state.rng, logits, temperature)
        if forced is not None:
            cls = torch.where(forced[:, i] >= 0, forced[:, i], cls)
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


def _seed_base(rng: Rng) -> int:
    """Session seed of the hash samplers, drawn on the host; bounded so
    seed_base + t stays far from int32 overflow."""
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator().manual_seed(int(rng))
    return int(torch.randint(0, np.iinfo(np.int32).max // 2, (),
                             generator=gen, device=gen.device))


def _generate_classes_mega(params, arch, rng, b, n_samples, forced,
                           temperature, return_logits, global_rng):
    """One-shot mega: lanes padded to the kernel's lane tile (pad lanes are
    forced to class 0 and dropped)."""
    dev = params["embed"].device
    if forced is None:
        forced_ts = torch.full((n_samples, b), -1, dtype=torch.int32, device=dev)
    else:
        forced_ts = forced[:, :n_samples].t()
    h0, e0 = _fused_frontend_zero(params, arch, b)
    seed_base = _seed_base(rng)
    pad = (-b) % LANE_TILE
    if pad:
        forced_ts = torch.cat([
            forced_ts,
            torch.zeros((n_samples, pad), dtype=torch.int32, device=dev),
        ], 1)
        h0 = torch.cat([h0, h0[:1].expand(pad, -1)], 0)
        e0 = torch.cat([e0, e0[:, :1].expand(-1, pad, -1)], 1)
    lane = None
    if temperature > 0.0 and not global_rng:
        lane = torch.stack([
            derive_lane_seeds(seed_base, b + pad, dev),
            torch.zeros((b + pad,), dtype=torch.int32, device=dev),
        ])
    out = mega_generate(
        params, params["layers"], arch, h0, e0, seed_base,
        forced_ts[:, None, :], None, n_samples, temperature, False,
        emit_logits=return_logits, lane=lane,
    )
    if return_logits:
        classes, logits = out
        return classes[:, 0, :b].t(), logits.permute(2, 0, 1)[:b]
    return out[:, 0, :b].t()


class Stream(NamedTuple):
    """Carried state of a streaming session: a RingState (xla/pallas) or a
    {"carry", "seed_base"} dict (mega). Pass the SAME engine to every
    stream_chunk of a session. Chunks update the state in place."""

    state: object
    t: int  # absolute sample index of the next step


MEGA_LANE_MULTIPLE = LANE_TILE


def stream_lane_multiple(engine: str) -> int:
    """Lane-count granularity of a streaming session: the mega kernel's lane
    tile (on every device, so a session pads alike on the CPU and the card);
    the other engines stream at any batch."""
    return MEGA_LANE_MULTIPLE if engine == "mega" else 1


def padded_stream_batch(batch: int, engine: str) -> int:
    """Smallest engine-streamable session batch >= `batch` (pad lanes are
    free-running throwaways, sliced off by the caller)."""
    m = stream_lane_multiple(engine)
    return -(-batch // m) * m


def start_stream(arch: ArchConfig, batch: int, rng: Rng, engine: str = "xla",
                 params: Optional[Params] = None,
                 model_axis: Optional[str] = None, device="cuda") -> Stream:
    """Open a streaming session (see stream_chunk). mega needs `params` to
    seed its carry and batch % MEGA_LANE_MULTIPLE == 0 (open it at
    padded_stream_batch and slice the pad lanes off, as SessionPool does)."""
    _check_env()
    if model_axis is not None:
        raise _not_ported("model_axis", "A12")
    if engine == "turbo":
        raise _not_ported("engine 'turbo'", "B6")
    dev = resolve_device(device)
    if engine == "mega":
        if params is None:
            raise ValueError("start_stream(engine='mega') needs params")
        params = params_to(params, dev)
        h0, e0 = _fused_frontend_zero(params, arch, batch)
        state = {"carry": mega_zero_carry(arch, h0, e0),
                 "seed_base": _seed_base(rng)}
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
    model_axis: Optional[str] = None,
    lane_inv_temp=None,                         # (B,) f32 1/tau (0 = greedy)
):
    """Emit the next chunk_size samples; returns (classes (B, chunk)[,
    logits (B, chunk, Q)], new_stream). The session state is updated in
    place; ring phase and sampling counters continue across chunks, so the
    concatenated output equals one generate_classes call of the same
    length. mega defaults to per-lane seeds derived from the session seed
    (lane time == absolute time); explicit lane_seed/lane_t0 override
    them; global_rng=True uses the batch-wide counter hash."""
    if cond is not None or speaker_ids is not None:
        raise _not_ported("conditioning", "A9")
    if model_axis is not None:
        raise _not_ported("model_axis", "A12")
    if engine == "turbo":
        raise _not_ported("engine 'turbo'", "B6")
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
    if engine == "mega":
        carry = stream.state["carry"]
        dev = carry["h_s"].device
    else:
        dev = stream.state.bufs.device
    params = params_to(params, dev)
    lane_seed = _as_lanes(lane_seed, torch.int32, dev)
    lane_t0 = _as_lanes(lane_t0, torch.int32, dev)
    lane_inv_temp = _as_lanes(lane_inv_temp, torch.float32, dev)
    if forced is not None:
        forced = torch.as_tensor(forced).to(dev, torch.int32)

    if engine == "mega":
        if lane_seed is None and temperature > 0.0 and not global_rng:
            b_dev = carry["h_s"].shape[-1]
            lane_seed = derive_lane_seeds(stream.state["seed_base"], b_dev, dev)
            lane_t0 = torch.zeros((b_dev,), dtype=torch.int32, device=dev)
        return _mega_stream_chunk(
            params, arch, stream, chunk_size, forced, temperature,
            return_logits, lane_seed, lane_t0, lane_inv_temp,
        )
    if lane_inv_temp is not None and lane_seed is None:
        raise ValueError(
            "lane_inv_temp on the scan engines needs explicit "
            "lane_seed/lane_t0 (the per-lane sampling path)"
        )
    new_state, out = _run_scan_engine(
        params, arch, stream.state, stream.t, chunk_size, forced,
        temperature, return_logits, engine, lane_seed=lane_seed,
        lane_t0=lane_t0, lane_inv_temp=lane_inv_temp,
    )
    new_stream = Stream(new_state, stream.t + chunk_size)
    if return_logits:
        classes, logits = out
        return classes.t(), logits.transpose(0, 1), new_stream
    return out.t(), new_stream


def _mega_stream_chunk(params, arch, stream: Stream, chunk_size: int, forced,
                       temperature: float, return_logits: bool,
                       lane_seed=None, lane_t0=None, lane_inv_temp=None):
    """One mega chunk: the whole chunk in ONE launch, carrying (ring, staged
    pairs, frontend) between chunks at ABSOLUTE time stream.t + step."""
    carry = stream.state["carry"]
    b = carry["h_s"].shape[-1]
    dev = carry["h_s"].device
    if b % LANE_TILE:
        raise ValueError(
            f"mega streaming needs batch % {LANE_TILE} == 0, got {b}; open "
            "the session at padded_stream_batch(batch, 'mega')"
        )
    if forced is None:
        forced_ts = torch.full((chunk_size, b), -1, dtype=torch.int32,
                               device=dev)
    else:
        forced_ts = forced.t()
    out = mega_generate(
        params, params["layers"], arch, None, None,
        stream.state["seed_base"], forced_ts[:, None, :], None, chunk_size,
        temperature, False, emit_logits=return_logits, streaming=True,
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


def reset_lanes(params: Params, arch: ArchConfig, stream: Stream,
                lane_mask, engine: str = "xla",
                model_axis: Optional[str] = None) -> Stream:
    """Continuous batching: reset the masked lanes to a fresh session start,
    in place. Each ring slot is read before it is written, so a lane whose
    ring columns are zero sees exactly the zero pre-start context of a t=0
    session at any global phase: a recycled lane's greedy/teacher-forced
    (and per-lane sampled) output equals a fresh session's."""
    if model_axis is not None:
        raise _not_ported("model_axis", "A12")
    # masked_fill_/where rather than boolean indexing: no host sync.
    if engine in ("xla", "pallas"):
        rs: RingState = stream.state
        mask = torch.as_tensor(lane_mask).to(rs.bufs.device, torch.bool)
        rs.embed_buf.masked_fill_(mask[None, :, None], 0.0)
        rs.bufs.masked_fill_(mask[None, :, None], 0.0)
        rs.prev_class.masked_fill_(mask, arch.quant_channels // 2)
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
        raise _not_ported("engine 'turbo'", "B6")
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
        yield mu_law_decode(classes, arch.quant_channels)
        i += 1


def generate(params: Params, arch: ArchConfig, rng: Rng, batch: int,
             n_samples: int, cond_frames=None, speaker_ids=None, forced=None,
             temperature: float = 1.0, engine: str = "xla",
             global_rng: bool = False, device="cuda") -> torch.Tensor:
    """Synthesize waveforms (B, n_samples) in [-1, 1]; `forced` primes the
    generator (forced[b, t] >= 0 is emitted and fed back, -1 free-runs)."""
    if cond_frames is not None:
        raise _not_ported("conditioning", "A9")
    classes = generate_classes(
        params, arch, rng, batch, n_samples, speaker_ids=speaker_ids,
        forced=forced, temperature=temperature, engine=engine,
        global_rng=global_rng, device=device,
    )
    return mu_law_decode(classes, arch.quant_channels)


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
