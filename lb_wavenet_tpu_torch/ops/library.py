"""The sampling kernels as torch custom ops (`torch.ops.wn.*`), so that a
program exported with torch.export (utils/export.py) calls them.

torch.export cannot trace into a ctypes launch, so the kernel wrappers
(ops/cuda/ar_mega.py `mega_generate`, ar_turbo.py `turbo_generate`,
ar_step.py `fused_stack`, ar_tp.py `tp_fused_stack`) call these ops while a
program is being exported (`torch.compiler.is_exporting()`) and keep their
direct calls otherwise. Each op has two registrations, picked by the
dispatcher from its tensors' device: "cuda" calls the same launcher as the
in-process path (the hand-written kernel), "cpu" its plain version. On the
card every tensor is a CUDA tensor, so the kernel runs; no registration
falls back to the other. The carries the kernels update in place are
declared in `mutates_args`, and a program exported by torch.export (its
default, non-functional IR) keeps those updates in place: the ring is not
copied per call.

Three host-side ops carry the session randomness across the export
boundary: `seed_base` (the hash samplers' session seed), `generator_state`
and `multinomial_` (the xla/pallas engines' torch.Generator, held as its
state tensor and advanced in place).

The absolute time `t0` and `seed_base` cross as 0-d int64 CPU tensors. The
model architecture crosses as its JSON string. Weights cross as one list in
a fixed order (`flat_weights`).

Importing this module registers the ops. It imports no model code, so a
process that serves an artifact needs neither the model nor the code that
exported it.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import List, Optional

import torch
from torch.library import custom_op

from ..config import ArchConfig, _from_dict
from .cuda import ar_mega, ar_step, ar_tp, ar_turbo

LAYER = ("w_cur", "w_prev", "b", "w_res", "w_skip", "b_res", "b_skip")
POST = ("w1", "b1", "w2", "b2")
TP = ("wcat", "b", "wrs", "brs")


def arch_json(arch: ArchConfig) -> str:
    return json.dumps(dataclasses.asdict(arch), sort_keys=True)


@functools.lru_cache(maxsize=None)
def _arch(js: str) -> ArchConfig:
    return _from_dict(ArchConfig, json.loads(js))


def flat_weights(params: dict, lp: dict) -> list:
    """The weights a sampling kernel reads, in the ops' order: the layers'
    (lp: params["layers"], or with the folded conditioning weight), the post
    network's, the embedding and the input conv's, then w_cond if any."""
    pp, ic = params["post"], params["input_conv"]
    out = [lp[k] for k in LAYER] + [pp[k] for k in POST] + [params["embed"], ic["w"], ic["b"]]
    return out + ([lp["w_cond"]] if "w_cond" in lp else [])


def _unflat(ws: List[torch.Tensor]):
    n = len(LAYER)
    lp = dict(zip(LAYER, ws[:n]))
    if len(ws) > n + len(POST) + 3:
        lp["w_cond"] = ws[-1]
    params = {"post": dict(zip(POST, ws[n: n + len(POST)])), "embed": ws[n + len(POST)],
              "input_conv": {"w": ws[n + len(POST) + 1], "b": ws[n + len(POST) + 2]}}
    return params, lp


def _t(x) -> torch.Tensor:
    """A host int (or 0-d tensor) as the ops' 0-d int64 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.reshape(()).to("cpu", torch.int64)
    return torch.tensor(int(x), dtype=torch.int64)


# ---------------------------------------------------------------------------
# B2 mega: the whole chunk.

@custom_op("wn::mega_generate", mutates_args=("bufs", "hstate", "h_s", "e_s"))
def _mega(bufs: torch.Tensor, hstate: torch.Tensor, h_s: torch.Tensor, e_s: torch.Tensor,
          weights: List[torch.Tensor], arch: str, t0: torch.Tensor, seed_base: torch.Tensor,
          forced: torch.Tensor, temperature: float, lane: Optional[torch.Tensor],
          cond: Optional[torch.Tensor]) -> torch.Tensor:
    raise ValueError("wn::mega_generate runs on cpu or cuda tensors")


def _mega_impl(run):
    def impl(bufs, hstate, h_s, e_s, weights, arch, t0, seed_base, forced, temperature,
             lane, cond):
        params, lp = _unflat(weights)
        carry = {"bufs": bufs, "hstate": hstate, "h_s": h_s, "e_s": e_s}
        classes, _ = run(params, lp, _arch(arch), carry, int(t0), forced, temperature,
                         False, lane, int(seed_base), cond=cond)
        return classes
    return impl


_mega.register_kernel("cpu")(_mega_impl(ar_mega.mega_generate_plain))
_mega.register_kernel("cuda")(_mega_impl(ar_mega.mega_generate_cuda))


@_mega.register_fake
def _(bufs, hstate, h_s, e_s, weights, arch, t0, seed_base, forced, temperature, lane, cond):
    return forced.new_empty(forced.shape, dtype=torch.int32)


def mega_generate(params, lp, arch, carry: dict, t0, forced, temperature: float, lane,
                  seed_base, cond=None) -> torch.Tensor:
    """ar_mega.mega_generate's call (classes (T, B) int32) through the op."""
    return _mega(carry["bufs"], carry["hstate"], carry["h_s"], carry["e_s"],
                 flat_weights(params, lp), arch_json(arch), _t(t0), _t(seed_base), forced,
                 float(temperature), lane, cond)


# ---------------------------------------------------------------------------
# B6 turbo: one launch per step, T steps per call.

@custom_op("wn::turbo_generate", mutates_args=("bufs", "h", "e"))
def _turbo(bufs: torch.Tensor, h: torch.Tensor, e: torch.Tensor, weights: List[torch.Tensor],
           arch: str, t0: torch.Tensor, seed_base: torch.Tensor, forced: torch.Tensor,
           temperature: float, lane: Optional[torch.Tensor],
           cond: Optional[torch.Tensor]) -> torch.Tensor:
    raise ValueError("wn::turbo_generate runs on cpu or cuda tensors")


def _turbo_impl(run):
    def impl(bufs, h, e, weights, arch, t0, seed_base, forced, temperature, lane, cond):
        params, lp = _unflat(weights)
        classes, _ = run(params, lp, _arch(arch), {"bufs": bufs, "h": h, "e": e}, int(t0),
                         forced, temperature, False, lane, int(seed_base), cond=cond)
        return classes
    return impl


_turbo.register_kernel("cpu")(_turbo_impl(ar_turbo.turbo_generate_plain))
_turbo.register_kernel("cuda")(_turbo_impl(ar_turbo.turbo_generate_cuda))


@_turbo.register_fake
def _(bufs, h, e, weights, arch, t0, seed_base, forced, temperature, lane, cond):
    return forced.new_empty(forced.shape, dtype=torch.int32)


def turbo_generate(params, lp, arch, state: dict, t0, forced, temperature: float, lane,
                   seed_base, cond=None) -> torch.Tensor:
    """ar_turbo.turbo_generate's call (classes (T, B) int32) through the op."""
    return _turbo(state["bufs"], state["h"], state["e"], flat_weights(params, lp),
                  arch_json(arch), _t(t0), _t(seed_base), forced, float(temperature), lane,
                  cond)


# ---------------------------------------------------------------------------
# B1 fused_stack and B7 tp_fused_stack: one step of the L layers.

@custom_op("wn::fused_stack", mutates_args=("bufs",))
def _stack(h0: torch.Tensor, bufs: torch.Tensor, t: torch.Tensor, weights: List[torch.Tensor],
           arch: str, cond_t: Optional[torch.Tensor]) -> torch.Tensor:
    raise ValueError("wn::fused_stack runs on cpu or cuda tensors")


def _stack_impl(h0, bufs, t, weights, arch, cond_t):
    lp = dict(zip(LAYER, weights))
    if len(weights) > len(LAYER):
        lp["w_cond"] = weights[-1]
    return ar_step.fused_stack(lp, _arch(arch), h0, bufs, int(t), cond_t)[1]


_stack.register_kernel("cpu")(_stack_impl)
_stack.register_kernel("cuda")(_stack_impl)


@_stack.register_fake
def _(h0, bufs, t, weights, arch, cond_t):
    return h0.new_empty((h0.shape[0], weights[LAYER.index("w_skip")].shape[-1]))


def fused_stack(lp, arch, h0, bufs, t, cond_t=None):
    """ar_step.fused_stack through the op: (bufs, skip_sum)."""
    ws = [lp[k] for k in LAYER] + ([lp["w_cond"]] if cond_t is not None else [])
    return bufs, _stack(h0, bufs, _t(t), ws, arch_json(arch), cond_t)


@custom_op("wn::tp_fused_stack", mutates_args=("bufs",))
def _tp(h0: torch.Tensor, bufs: torch.Tensor, t: torch.Tensor, fm: List[torch.Tensor],
        arch: str, cond_t: Optional[torch.Tensor]) -> torch.Tensor:
    raise ValueError("wn::tp_fused_stack runs on cpu or cuda tensors")


def _tp_impl(h0, bufs, t, fm, arch, cond_t):
    w = dict(zip(TP, fm))
    if len(fm) > len(TP):
        w["wcond"] = fm[-1]
    return ar_tp.tp_fused_stack(w, _arch(arch), h0, bufs, int(t), cond_t)[1]


_tp.register_kernel("cpu")(_tp_impl)
_tp.register_kernel("cuda")(_tp_impl)


@_tp.register_fake
def _(h0, bufs, t, fm, arch, cond_t):
    return h0.new_empty((fm[TP.index("wrs")].shape[1] - h0.shape[0], h0.shape[1]))


def tp_fused_stack(fm, arch, h0, bufs, t, cond_t=None):
    """ar_tp.tp_fused_stack through the op: (bufs, skip_local)."""
    ws = [fm[k] for k in TP] + ([fm["wcond"]] if cond_t is not None else [])
    return bufs, _tp(h0, bufs, _t(t), ws, arch_json(arch), cond_t)


# ---------------------------------------------------------------------------
# Session randomness on the host.

@custom_op("wn::seed_base", mutates_args=())
def _seed_base(seed: torch.Tensor) -> torch.Tensor:
    from ..ops.cuda.ar_mega import session_seed_base

    return torch.tensor(session_seed_base(int(seed)), dtype=torch.int64)


@_seed_base.register_fake
def _(seed):
    return torch.empty((), dtype=torch.int64)


def seed_base(seed: torch.Tensor) -> torch.Tensor:
    """The hash samplers' session seed of an int seed (generate._seed_base)."""
    return _seed_base(_t(seed))


@functools.lru_cache(maxsize=None)
def _state_bytes(device: str) -> int:
    return torch.Generator(device=device).get_state().numel()


@custom_op("wn::generator_state", mutates_args=())
def _gen_state(seed: torch.Tensor, device: str) -> torch.Tensor:
    return torch.Generator(device=device).manual_seed(int(seed)).get_state()


@_gen_state.register_fake
def _(seed, device):
    return torch.empty((_state_bytes(device),), dtype=torch.uint8)


def generator_state(seed, device) -> torch.Tensor:
    """The state (a CPU uint8 tensor) of torch.Generator(device) seeded
    with `seed`."""
    return _gen_state(_t(seed), str(torch.device(device).type))


@custom_op("wn::multinomial_", mutates_args=("state",))
def _multinomial(state: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    gen = torch.Generator(device=probs.device)
    gen.set_state(state)
    out = torch.multinomial(probs, 1, generator=gen)
    state.copy_(gen.get_state())
    return out


@_multinomial.register_fake
def _(state, probs):
    return probs.new_empty((probs.shape[0], 1), dtype=torch.int64)


def multinomial_(state: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """torch.multinomial(probs, 1) drawn from, and advancing, the generator
    held as `state`: the same draws as the torch.Generator it was made
    from."""
    return _multinomial(state, probs)
