"""Training engine: the teacher-forced train step and the host loop (port of
`lb_wavenet_tpu/train.py`) on one device.

A step is eager PyTorch: the loss of a batch (the production path runs the
input frontend, the dilated stack and the post network + masked CE through
the CUDA kernel pairs of `ops/cuda/frontend.py`, `ops/cuda/train_stack.py`
and `ops/cuda/post_loss.py`), its
gradient by autograd (`value_and_grads`), then Adam. Adam is written on tensors and follows
optax's `chain(clip_by_global_norm, adam(schedule))` step for step: the
learning rate is read at the update count BEFORE it increments (so with
warmup the first update has lr 0), the bias corrections use count + 1, eps
is added to sqrt(nu_hat), and clipping scales by max_norm / |g| only when
|g| >= max_norm. Gradient accumulation equals the one-shot step up to
float rounding (see `value_and_grads`).

The state is a NamedTuple of tensor dicts; a step returns a new state and
leaves the old one intact. Entry points run on the card unless the caller
passes device="cpu" (then the kernels' plain versions run).

`run_training` evaluates on a held-out corpus every train.eval_every steps
(eval.py). Not ported yet, and raising NotImplementedError (ROADMAP.md A):
model and sequence parallelism (mesh_model > 1, mesh_data > 1,
seq_parallel; A queue item 7b), TensorBoard (A queue item 8) and mel/speaker
conditioning (A queue item 4b).
"""
from __future__ import annotations

import math
import time
from typing import Any, NamedTuple, Optional

import torch

from .config import ArchConfig, Config, TrainConfig
from .data import Batch, Corpus, load_corpus, make_batches, prefetch
from .generate import resolve_device
from .models.wavenet import (
    compute_dtype, forward, init_params, input_frontend, masked_loss_sums,
    post_network,
)
from .utils import checkpoint as ckpt_lib
from .utils.metrics import MetricsLogger


class TrainState(NamedTuple):
    params: dict
    opt_state: dict          # {"count": int, "mu": tree, "nu": tree}
    step: int
    ema: Optional[dict] = None  # EMA copy of params (ema_decay > 0)


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts and lists of the same structure
    (keys in sorted order, as tree_leaves)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(first)}
    if isinstance(first, list):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(first))]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order, list items in order (the order of
    jax.tree.leaves)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def make_lr_schedule(train: TrainConfig):
    """count -> learning rate: linear warmup, then constant / cosine /
    linear / exponential decay (optax's schedules, `lr_at` below)."""
    if train.lr_schedule not in ("constant", "cosine", "linear", "exponential"):
        raise ValueError(f"Unknown lr_schedule {train.lr_schedule!r}")
    return lambda count: lr_at(train, count)


def lr_at(train: TrainConfig, step: int) -> float:
    """The learning rate at `step`; decay_steps = 0 decays over the
    post-warmup remainder of the run, down to learning_rate * lr_min_ratio."""
    base = train.learning_rate
    warm = max(train.warmup_steps, 0)
    decay = train.decay_steps or max(train.n_steps - warm, 1)
    if step < warm:
        return base * step / warm
    s = step - warm
    sc = min(s, decay)
    kind = train.lr_schedule
    if kind == "constant":
        return base
    if kind == "cosine":
        a = train.lr_min_ratio
        return base * ((1 - a) * 0.5 * (1 + math.cos(math.pi * sc / decay)) + a)
    if kind == "linear":
        end = base * train.lr_min_ratio
        return base + (end - base) * sc / decay
    if kind == "exponential":
        ratio = train.lr_min_ratio if train.lr_min_ratio > 0 else 0.01
        return base * ratio ** (s / decay)
    raise ValueError(f"Unknown lr_schedule {kind!r}")


class Adam:
    """Adam with the config's schedule and optional global-norm clipping,
    on dicts of fp32 tensors (optax.adam, eps = 1e-8, eps_root = 0)."""

    eps = 1e-8

    def __init__(self, train: TrainConfig):
        self.lr = make_lr_schedule(train)
        self.b1, self.b2 = train.adam_b1, train.adam_b2
        self.clip = train.grad_clip_norm

    def init(self, params: dict) -> dict:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, grads: dict, state: dict):
        """(updates, new state) for `grads`."""
        if self.clip > 0:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(grads)))
            if not bool(g_norm < self.clip):
                grads = tree_map(lambda g: (g / g_norm) * self.clip, grads)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
        count = state["count"]
        dev = tree_leaves(grads)[0].device
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=dev) ** (count + 1)
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=dev) ** (count + 1)
        step_size = -self.lr(count)

        def upd(m, v):
            return step_size * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps))

        return tree_map(upd, mu, nu), {"count": count + 1, "mu": mu, "nu": nu}


def make_optimizer(train: TrainConfig) -> Adam:
    return Adam(train)


def init_state(rng, arch: ArchConfig, train: TrainConfig, device="cpu") -> TrainState:
    """Fresh parameters (the port's own init stream), zero Adam moments,
    step 0 and, with ema_decay > 0, an EMA copy of the parameters."""
    params = init_params(rng, arch, device)
    ema = tree_map(torch.clone, params) if train.ema_decay > 0 else None
    return TrainState(params, make_optimizer(train).init(params), 0, ema)


def forward_fused(params: dict, arch: ArchConfig, x_classes, cond_frames=None,
                  speaker_ids=None, tapcat: bool = False, return_skip: bool = False,
                  fused_frontend: bool = False):
    """forward() with the dilated stack run by the training-stack kernel
    pair (ops/cuda/train_stack.py): same logits to float rounding.
    `fused_frontend` also runs the frontend through its kernel pair."""
    from .ops.cuda.train_stack import make_fused_stack

    if cond_frames is not None or speaker_ids is not None:
        raise NotImplementedError(
            "conditioned training waits for the mel/speaker slice "
            "(ROADMAP.md A queue item 4b)")
    dt = compute_dtype(arch)
    h0 = input_frontend(params, arch, x_classes, dt, fused_frontend)
    skip = make_fused_stack(arch, tapcat=tapcat)(params["layers"], h0)
    return skip if return_skip else post_network(params, skip, dt)


def _batch_logits(params, arch: ArchConfig, batch: dict, remat: bool,
                  fused_stack: bool, tapcat: bool, return_skip: bool = False,
                  fused_frontend: bool = False):
    kw = dict(cond_frames=batch.get("mel"), speaker_ids=batch.get("speaker"),
              return_skip=return_skip, fused_frontend=fused_frontend)
    if fused_stack:
        return forward_fused(params, arch, batch["inputs"], tapcat=tapcat, **kw)
    return forward(params, arch, batch["inputs"], remat=remat, **kw)


def loss_sums_fn(params, arch: ArchConfig, window_size: int, batch: dict,
                 train: TrainConfig):
    """(masked-CE numerator, mask denominator) of one (micro)batch. With
    train.fused_post the post network + CE run through the post-loss kernel
    pair (ops/cuda/post_loss.py) on the skip sum; with train.fused_frontend
    the frontend runs through its kernel pair (ops/cuda/frontend.py).
    train.mm_embed_grad is accepted and changes nothing (models/wavenet.py)."""
    if train.fused_post:
        from .ops.cuda.post_loss import fused_post_loss

        skip = _batch_logits(params, arch, batch, train.remat, train.fused_stack,
                             train.tapcat, return_skip=True,
                             fused_frontend=train.fused_frontend)
        num = fused_post_loss(params["post"], skip, batch["targets"], batch["mask"],
                              window_size, compute_dtype=arch.compute_dtype)
        return num, batch["mask"].to(torch.float32).sum()
    logits = _batch_logits(params, arch, batch, train.remat, train.fused_stack,
                           train.tapcat, fused_frontend=train.fused_frontend)
    return masked_loss_sums(logits, batch["targets"], batch["mask"], window_size)


def _grad(out: torch.Tensor, params: dict) -> dict:
    grads = iter(torch.autograd.grad(out, tree_leaves(params)))
    return tree_map(lambda _: next(grads), params)


def _apply_updates(state: TrainState, grads: dict, train: TrainConfig) -> TrainState:
    """Optimizer + EMA + step bump."""
    updates, opt_state = make_optimizer(train).update(grads, state.opt_state)
    with torch.no_grad():
        params = tree_map(lambda p, u: p + u, state.params, updates)
        ema = state.ema
        if train.ema_decay > 0:
            d = train.ema_decay
            ema = tree_map(lambda e, p: e * d + p * (1.0 - d), state.ema, params)
    return TrainState(params, opt_state, state.step + 1, ema)


def value_and_grads(params: dict, batch: dict, arch: ArchConfig, train: TrainConfig):
    """(loss, gradients) of the masked-mean CE of `batch` at `params`.
    With grad_accum = k > 1 the batch runs as k microbatches (micro i takes
    rows i::k): their numerators' gradients and both sums are added, then
    divided once by the summed mask (exact: the denominator has no
    parameter dependence)."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    k = train.grad_accum
    if k <= 1:
        num, den = loss_sums_fn(params, arch, train.window_size, batch, train)
        loss = num / torch.clamp(den, min=1.0)
        return loss.detach(), _grad(loss, params)
    b = batch["inputs"].shape[0]
    if b % k:
        raise ValueError(f"batch_size {b} is not divisible by grad_accum {k}")
    g_sum = tree_map(torch.zeros_like, params)
    num = den = torch.zeros((), dtype=torch.float32, device=batch["inputs"].device)
    for i in range(k):
        micro = {key: v[i::k] for key, v in batch.items()}
        n_i, d_i = loss_sums_fn(params, arch, train.window_size, micro, train)
        g_sum = tree_map(torch.add, g_sum, _grad(n_i, params))
        num, den = num + n_i.detach(), den + d_i.detach()
    d = torch.clamp(den, min=1.0)
    return num / d, tree_map(lambda g: g / d, g_sum)


def train_step(state: TrainState, batch: dict, arch: ArchConfig, train: TrainConfig):
    """One optimizer step on `batch` (a dict from batch_to_device):
    (new state, loss)."""
    loss, grads = value_and_grads(state.params, batch, arch, train)
    return _apply_updates(state, grads, train), loss


def batch_to_device(batch: Batch, device) -> dict:
    """A host batch as tensors on `device`."""
    d = {"inputs": batch.inputs, "targets": batch.targets, "mask": batch.mask}
    if batch.mel is not None:
        d["mel"] = batch.mel
    if batch.speaker is not None:
        d["speaker"] = batch.speaker
    return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in d.items()}


def _check_supported(arch: ArchConfig, train: TrainConfig) -> None:
    if train.mesh_model > 1 or train.mesh_data > 1 or train.seq_parallel:
        raise NotImplementedError(
            "model, data and sequence parallelism (train.mesh_model > 1, "
            "mesh_data > 1, seq_parallel) wait for ROADMAP.md A queue item 7b; "
            "the port trains on one device")
    if train.tensorboard_dir:
        raise NotImplementedError(
            "the TensorBoard stream is not ported (ROADMAP.md A queue item 8); "
            "metrics go to JSONL")
    if arch.use_local_cond or arch.use_global_cond:
        raise NotImplementedError(
            "conditioned training waits for the mel/speaker slice "
            "(ROADMAP.md A queue item 4b)")


def _eval_record(state: TrainState, arch: ArchConfig, train: TrainConfig,
                 eval_corpus: Corpus, dev) -> dict:
    """The in-training evaluation of the params (and of the EMA copy),
    through the fused stack when the step uses it."""
    from .eval import evaluate

    kw = dict(max_batches=train.eval_batches, fused=train.fused_stack,
              tapcat=train.tapcat and train.fused_stack, device=dev)
    batch = train.eval_batch_size or train.batch_size
    ev = evaluate(state.params, arch, eval_corpus, batch, **kw)
    record = {f"eval_{k}": v for k, v in ev.items()}
    if train.ema_decay > 0:
        ev_ema = evaluate(state.ema, arch, eval_corpus, batch, **kw)
        record.update(eval_ema_nll=ev_ema["nll"], eval_ema_accuracy=ev_ema["accuracy"])
    return record


def run_training(
    config: Config,
    corpus: Optional[Corpus] = None,
    n_steps: Optional[int] = None,
    eval_corpus: Optional[Corpus] = None,
    device: Any = "cuda",
) -> TrainState:
    """Full training run: data, resume, loop, checkpoints, metrics, and
    every train.eval_every steps an evaluation of the held-out corpus
    (`eval_corpus`, or train.eval_dir), logged as eval_* records (plus
    eval_ema_nll / eval_ema_accuracy with an EMA) and kept out of
    step_time_ms."""
    arch, train = config.arch, config.train
    _check_supported(arch, train)
    dev = resolve_device(device)
    if corpus is None:
        corpus = load_corpus(train.data_dir, arch, train.window_size)
    if eval_corpus is None and train.eval_dir:
        eval_corpus = load_corpus(train.eval_dir, arch, train.window_size)
    state = init_state(train.seed, arch, train, dev)
    manager = ckpt_lib.make_manager(train.checkpoint_dir)
    state, start_step = ckpt_lib.restore_if_available(manager, state)
    batches = prefetch(make_batches(corpus, train, start_step=start_step))
    metrics = MetricsLogger(train.metrics_path)
    total = n_steps if n_steps is not None else train.n_steps
    samples_per_step = train.batch_size * train.window_size
    t_last = time.perf_counter()
    try:
        for i in range(start_step, total):
            batch = batch_to_device(next(batches), dev)
            state, loss = train_step(state, batch, arch, train)
            if (i + 1) % train.log_every == 0 or i + 1 == total:
                loss_v = float(loss)  # waits for the step
                now = time.perf_counter()
                dt = now - t_last
                t_last = now
                n_logged = min(train.log_every, i + 1 - start_step) or 1
                metrics.log(step=i + 1, loss=loss_v, lr=lr_at(train, i + 1),
                            samples_per_sec=samples_per_step * n_logged / dt,
                            step_time_ms=1000.0 * dt / n_logged)
            if eval_corpus is not None and train.eval_every > 0 and (
                    (i + 1) % train.eval_every == 0 or i + 1 == total):
                metrics.log(step=i + 1, **_eval_record(state, arch, train, eval_corpus, dev))
                t_last = time.perf_counter()  # eval time is not step time
            if i + 1 == total or (train.checkpoint_every > 0
                                  and (i + 1) % train.checkpoint_every == 0):
                ckpt_lib.save(manager, state, i + 1)
    finally:
        batches.close()
        metrics.close()
    return state
