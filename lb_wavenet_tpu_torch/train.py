"""Training engine: the teacher-forced train step and the host loop (port of
`lb_wavenet_tpu/train.py`), on one device or across ranks.

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

Mel and speaker conditioning train as in the JAX package: a batch's mel
frames go through the upsampler (`upsample_cond_train`, one float32
product per contraction), speakers through the embedding table broadcast
over time, and the fused stack takes both as one cond row [mel | speaker]
against [w_cond ; w_gcond] (`forward_fused`); autograd carries d cond on
to the upsampler's stages, w_cond, w_gcond and the speaker table.

`run_training` evaluates on a held-out corpus (a directory or a pack file)
every train.eval_every steps (eval.py), and with train.tensorboard_dir
mirrors its metrics as TensorBoard scalars (utils/metrics.py).

A mol arch (Tacotron 2's WaveNet vocoder, arch.output_dist == "mol") trains
on the same step: samples in through the scalar frontend, the stack (the
fused kernel pair with train.fused_stack), then the mixture head and its
masked NLL through the head kernel pair (ops/cuda/post_mol.py; its plain
version on the CPU) inside the span `mol.head`. train.fused_frontend and
train.fused_post are the softmax model's kernel pairs and raise for it;
data-parallel training takes it, sequence- and model-parallel training
and evaluation raise (ops/mol.py ROADMAP_REST).

Training across ranks (one process per rank, `parallel.mesh`; JAX gets the
first from GSPMD and the others from shard_map):
  * data-parallel (mesh_data > 1): each data rank loads rows
    data_rank::data of the global batch, takes the gradients of the masked-CE
    NUMERATOR and the sums (num, den) on them, and one flat all-reduce over
    the data group sums all of it; the result is divided once by max(den,
    1), and every rank applies the same Adam/EMA update (`make_dp_train_step`);
  * sequence-parallel (train.seq_parallel): the data axis shards time
    (parallel/halo.py, the masked frontend and training-stack kernels);
    every rank loads the whole batch (`seq_batch_to_device`), and the
    gradients and sums are all-reduced over the axis (`make_sp_train_step`);
  * skip-split model-parallel (mesh_model > 1): each model rank holds its
    slice of w_skip, b_skip and post.w1 (`parallel.mesh.shard_params`), runs
    the whole stack down to its skip slice, and one all-reduce over the
    model group completes the post network's hidden layer
    (`make_tp_train_step`); composes with a data axis.
Gradient accumulation (grad_accum = k) takes a rank's rows i::k as micro i
on every path and reduces once per step. A process that runs alone trains
on the 1 x 1 mesh (sequence parallelism over one rank included).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from .config import ArchConfig, Config, TrainConfig
from .data import Batch, Corpus, load_corpus, make_batches, prefetch
from .generate import resolve_device
from .models.conditioning import upsample_cond_train
from .models.wavenet import (
    _mm, compute_dtype, forward, init_params, input_frontend, masked_loss_sums,
    post_network,
)
from .parallel.mesh import (
    Mesh, all_reduce_, all_reduce_flat_, gather_params, local_mesh, make_mesh, shard_params,
    sharded_dim,
)
from .utils import checkpoint as ckpt_lib
from .utils import multihost
from .utils.metrics import MetricsLogger
from .utils.profiling import span


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


def tree_paths(tree, path=()) -> list:
    """The leaves' paths (tuples of keys and list indices) in the order of
    tree_leaves."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in tree_paths(v, path + (i,))]
    return [path]


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
    def update(self, grads: dict, state: dict, g_norm=None):
        """(updates, new state) for `grads`. With clipping, `g_norm` is the
        global norm when `grads` hold only a part of it (a model rank's
        slices); by default the norm of `grads`."""
        if self.clip > 0:
            if g_norm is None:
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
                  fused_frontend: bool = False, cond=None, input_mask=None):
    """forward() with the dilated stack run by the training-stack kernel
    pair (ops/cuda/train_stack.py): same logits to float rounding.
    `fused_frontend` also runs the frontend through its kernel pair.

    Conditioning as JAX's forward_fused builds it: frame-rate `cond_frames`
    (B, F, n_mels), upsampled here (upsample_cond_train, output in the
    compute dtype), or pre-upsampled `cond` (B, >= T, Cc), not both; cut to
    T and carried in float32. `speaker_ids` (B,) add speaker_embed[id]
    broadcast over T after the mel channels, against [w_cond ; w_gcond]
    (w_gcond alone without mel): one cond row and one w_cond for the
    conditioned stack kernels. `input_mask` (B, T) is the sequence-parallel
    halo mask (parallel/halo.py): the masked frontend, then the masked
    stack, which keeps the residual stream's masked rows exactly 0."""
    from .ops.cuda.train_stack import make_fused_stack

    if cond is not None and cond_frames is not None:
        raise ValueError("pass cond_frames OR pre-upsampled cond, not both")
    dt = compute_dtype(arch)
    b, t = x_classes.shape
    lp = dict(params["layers"])
    if cond_frames is not None:
        cond = upsample_cond_train(params["upsampler"], arch, cond_frames, dt)
    if cond is not None:
        cond = cond[:, :t].to(torch.float32)
    if speaker_ids is not None:
        table = params["speaker_embed"]
        ids = torch.as_tensor(speaker_ids).to(table.device).long()
        gts = table[ids][:, None, :].expand(b, t, table.shape[-1]).to(torch.float32)
        if cond is not None:
            cond = torch.cat([cond, gts], -1)
            lp["w_cond"] = torch.cat([lp["w_cond"], lp["w_gcond"]], 1)
        else:
            cond, lp["w_cond"] = gts, lp["w_gcond"]
    h0 = input_frontend(params, arch, x_classes, dt, fused_frontend, input_mask=input_mask)
    stack = make_fused_stack(arch, has_cond=cond is not None, tapcat=tapcat,
                             has_mask=input_mask is not None)
    extra = [v for v in (cond, input_mask) if v is not None]
    skip = stack(lp, h0, *extra)
    return skip if return_skip else post_network(params, skip, dt)


def batch_cond(params, arch: ArchConfig, batch: dict):
    """The batch's mel frames upsampled for the teacher-forced forward
    (upsample_cond_train, in the compute dtype, cut to the inputs' length),
    or None."""
    if batch.get("mel") is None:
        return None
    cond = upsample_cond_train(params["upsampler"], arch, batch["mel"], compute_dtype(arch))
    return cond[:, : batch["inputs"].shape[1]]


def _batch_logits(params, arch: ArchConfig, batch: dict, remat: bool,
                  fused_stack: bool, tapcat: bool, return_skip: bool = False,
                  fused_frontend: bool = False):
    kw = dict(cond=batch_cond(params, arch, batch), speaker_ids=batch.get("speaker"),
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
    train.mm_embed_grad is accepted and changes nothing (models/wavenet.py).
    A mol arch's loss is the masked MoL NLL through the head kernel pair
    (`_mol_loss_sums`)."""
    if arch.mol:
        return _mol_loss_sums(params, arch, window_size, batch, train)
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


def _check_mol(arch: ArchConfig, train: TrainConfig) -> None:
    """Refuse the softmax model's kernel pairs for a mol arch."""
    for knob in ("fused_frontend", "fused_post"):
        if getattr(train, knob):
            raise ValueError(
                f"train.{knob} is the mu-law softmax model's kernel pair; a mol arch "
                f"(arch.output_dist='mol') takes samples as real numbers through its scalar "
                f"frontend and its loss through the MoL head pair: set train.{knob}=false")


def _mol_loss_sums(params, arch: ArchConfig, window_size: int, batch: dict,
                   train: TrainConfig):
    """(masked MoL NLL numerator, mask denominator) of one (micro)batch: the
    skip sum (the fused stack with train.fused_stack), then the head and
    the NLL through the head kernel pair, in the span `mol.head`."""
    from .ops.cuda.post_mol import mol_head_loss

    _check_mol(arch, train)
    skip = _batch_logits(params, arch, batch, train.remat, train.fused_stack, train.tapcat,
                         return_skip=True)
    with span("mol.head"):
        num = mol_head_loss(params["mol"], skip, batch["targets"], batch["mask"], window_size,
                            compute_dtype=arch.compute_dtype)
    return num, batch["mask"].to(torch.float32).sum()


def _grad(out: torch.Tensor, params: dict) -> dict:
    """d out / d params as a tree; a leaf the loss does not reach (the
    speaker table of a batch without speaker ids) gets zeros, as JAX's."""
    with span("train.backward"):
        grads = iter(torch.autograd.grad(out, tree_leaves(params), allow_unused=True,
                                         materialize_grads=True))
    return tree_map(lambda _: next(grads), params)


def _apply_updates(state: TrainState, grads: dict, train: TrainConfig,
                   g_norm=None) -> TrainState:
    """Optimizer + EMA + step bump (`g_norm`: Adam.update's)."""
    with span("train.optimizer"), torch.no_grad():
        updates, opt_state = make_optimizer(train).update(grads, state.opt_state, g_norm)
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
        with span("train.forward"):
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
        with span("train.forward"):
            n_i, d_i = loss_sums_fn(params, arch, train.window_size, micro, train)
        g_sum = tree_map(torch.add, g_sum, _grad(n_i, params))
        num, den = num + n_i.detach(), den + d_i.detach()
    d = torch.clamp(den, min=1.0)
    return num / d, tree_map(lambda g: g / d, g_sum)


def train_step(state: TrainState, batch: dict, arch: ArchConfig, train: TrainConfig):
    """One optimizer step on `batch` (a dict from batch_to_device):
    (new state, loss)."""
    with span("train.step"):
        loss, grads = value_and_grads(state.params, batch, arch, train)
        return _apply_updates(state, grads, train), loss


# ---- training across ranks ---------------------------------------------------

def num_grads(params: dict, batch: dict, train: TrainConfig, sums_fn):
    """The accumulable form of a step on this rank's rows: (gradients of the
    masked-CE numerator, num, den), all detached, from sums_fn(params,
    batch) -> (num, den). With grad_accum = k > 1, micro i takes rows i::k."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    k = max(train.grad_accum, 1)
    b = batch["inputs"].shape[0]
    if b % k:
        raise ValueError(f"batch_size {b} is not divisible by grad_accum {k}")
    g_sum, num, den = None, 0.0, 0.0
    for i in range(k):
        micro = batch if k == 1 else {key: v[i::k] for key, v in batch.items()}
        with span("train.forward"):
            n_i, d_i = sums_fn(params, micro)
        g = _grad(n_i, params)
        g_sum = g if g_sum is None else tree_map(torch.add, g_sum, g)
        num, den = num + n_i.detach(), den + d_i.detach().to(torch.float32)
    return g_sum, num, den


def _reduced_step(train: TrainConfig, sums_fn, groups, g_norm=None):
    """step(state, batch) -> (state, loss) of the multi-rank paths: this
    rank's numerator gradients and (num, den) (`num_grads`), summed over
    each (group, size, keep) of `groups` in turn (the leaves whose path
    `keep` takes, and the sums where keep(None)), one flat buffer per group;
    divided once by max(den, 1); then Adam and EMA (with clipping, by
    g_norm(grads) when given)."""
    def step(state: TrainState, batch: dict):
        with span("train.step"):
            g, num, den = num_grads(state.params, batch, train, sums_fn)
            paths, leaves = tree_paths(g), tree_leaves(g)
            sums = torch.stack([num, den])
            with span("train.allreduce"):
                for group, size, keep in groups:
                    picked = [x for p, x in zip(paths, leaves) if keep(p)]
                    all_reduce_flat_(picked + ([sums] if keep(None) else []), group, size)
            d = torch.clamp(sums[1], min=1.0)
            grads = tree_map(lambda x: x / d, g)
            norm = g_norm(grads) if g_norm is not None and train.grad_clip_norm > 0 else None
            return _apply_updates(state, grads, train, norm), sums[0] / d

    return step


def make_dp_train_step(mesh: Mesh, arch: ArchConfig, train: TrainConfig):
    """Data-parallel step(state, batch) -> (state, loss) on this data
    rank's rows of the global batch: the windowed loss, its numerator's
    gradients and both sums summed over the data group in one collective,
    divided once; the same Adam/EMA update on every rank."""
    def sums(p, b):
        return loss_sums_fn(p, arch, train.window_size, b, train)

    return _reduced_step(train, sums, [(mesh.data_group, mesh.data, lambda p: True)])


def make_sp_train_step(mesh: Mesh, arch: ArchConfig, train: TrainConfig):
    """Sequence-parallel step(state, batch) -> (state, loss): the data axis
    shards time (parallel/halo.py; batches from seq_batch_to_device, the
    whole batch on every rank). Each rank's numerator gradients and sums
    are summed over the axis in one collective; the upsampler's gradient
    adds the ranks' cond slices. grad_accum takes batch rows i::k (time
    stays sharded within each micro). Model ranks, if any, are replicas."""
    from .parallel.halo import sequence_parallel_loss_sums

    def sums(p, b):
        return sequence_parallel_loss_sums(
            p, arch, b["inputs"], b["targets"], b["mask"], mesh, cond_frames=b.get("mel"),
            speaker_ids=b.get("speaker"), remat=train.remat, fused_stack=train.fused_stack,
            tapcat=train.tapcat, fused_frontend=train.fused_frontend,
            fused_post=train.fused_post)

    return _reduced_step(train, sums, [(mesh.data_group, mesh.data, lambda p: True)])


class _HiddenSum(torch.autograd.Function):
    """The post network's hidden layer summed over the model group (each
    rank holds its skip slice's part). Every rank's loss then sees the same
    hidden, so the cotangent arriving here is the same on every rank and
    is each part's own: the backward passes it through."""

    @staticmethod
    def forward(ctx, h_part, mesh):
        out = h_part.clone()
        if mesh.model > 1:
            all_reduce_(out, mesh.model_group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


# The post leaves after the hidden sum: every model rank computes their whole
# gradient (the others' are partial: summed over the model group).
_AFTER_HIDDEN_SUM = {("post", "b1"), ("post", "w2"), ("post", "b2")}


def _global_norm(grads: dict, mesh: Mesh):
    """The global norm of a model rank's gradients: the sharded leaves'
    squares summed over the model group."""
    sq_rep = sq_sh = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for p, g in zip(tree_paths(grads), tree_leaves(grads)):
        if sharded_dim(p) is None:
            sq_rep = sq_rep + torch.sum(g * g)
        else:
            sq_sh = sq_sh + torch.sum(g * g)
    all_reduce_flat_([sq_sh], mesh.model_group, mesh.model)
    return torch.sqrt(sq_rep + sq_sh)


def make_tp_train_step(mesh: Mesh, arch: ArchConfig, train: TrainConfig):
    """Skip-split model-parallel step(state, batch) -> (state, loss) on this
    rank's sharded state (`shard_params`) and its data rank's rows: the
    whole stack (fused kernels or not) down to the rank's skip slice,
    arch.skip_channels // model wide; the post network's first product on
    the slice for the last W positions only; ONE all-reduce of the (B, W, S)
    hidden over the model group (`_HiddenSum`); the rest of the post network
    and the CE in plain PyTorch, as JAX runs them in XLA. Gradients: the
    replicated leaves before the hidden sum summed over the model group, the
    sharded ones kept; then everything, with num and den, summed over the
    data group. Clipping takes the global norm (`_global_norm`)."""
    if arch.skip_channels % mesh.model:
        raise ValueError(
            f"skip-split TP training needs skip_channels ({arch.skip_channels}) % model axis "
            f"({mesh.model}) == 0")
    arch_local = dataclasses.replace(arch, skip_channels=arch.skip_channels // mesh.model)
    dt = compute_dtype(arch)
    w = train.window_size

    def sums(p, b):
        skip = _batch_logits(p, arch_local, b, train.remat, train.fused_stack, train.tapcat,
                             return_skip=True, fused_frontend=train.fused_frontend)
        pp = p["post"]
        h_part = _mm(torch.relu(skip[:, -w:]), pp["w1"], dt)
        h2 = torch.relu(_HiddenSum.apply(h_part, mesh) + pp["b1"])
        logits = _mm(h2, pp["w2"], dt) + pp["b2"]
        ce = -torch.log_softmax(logits, dim=-1)
        ce = ce.gather(-1, b["targets"].long()[..., None])[..., 0]
        mask = b["mask"].to(torch.float32)
        return (ce * mask).sum(), mask.sum()

    def before_sum(p):
        return p is not None and sharded_dim(p) is None and tuple(p) not in _AFTER_HIDDEN_SUM

    return _reduced_step(train, sums, [(mesh.model_group, mesh.model, before_sum),
                                       (mesh.data_group, mesh.data, lambda p: True)],
                         g_norm=lambda grads: _global_norm(grads, mesh))


def seq_batch_to_device(batch: Batch, mesh: Mesh, window_size: int, device) -> dict:
    """A host batch as the sequence-parallel step takes it, on `device`:
    the windowed (targets, mask) expanded over the whole input length (only
    the last `window_size` positions train, as masked_loss scores them),
    time zero-padded to a multiple of the data axis (later positions:
    causally inert, and masked). Mel frames and speaker ids whole."""
    import numpy as np

    with span("train.to_device"):
        n = mesh.data
        inputs = np.asarray(batch.inputs)
        b, t = inputs.shape
        tp = -(-t // n) * n
        inp = np.zeros((b, tp), inputs.dtype)
        inp[:, :t] = inputs
        tgt = np.zeros((b, tp), np.int32)
        tgt[:, t - window_size: t] = batch.targets
        msk = np.zeros((b, tp), np.float32)
        msk[:, t - window_size: t] = batch.mask
        out = {"inputs": inp, "targets": tgt, "mask": msk}
        if batch.mel is not None:
            out["mel"] = np.asarray(batch.mel)
        if batch.speaker is not None:
            out["speaker"] = np.asarray(batch.speaker)
        return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in out.items()}


def _train_mesh(train: TrainConfig, device) -> Mesh:
    """The mesh run_training trains on: (mesh_data, mesh_model) over the
    ranks of the running process group, or the 1 x 1 mesh of a process
    that runs alone."""
    if dist.is_initialized():
        return make_mesh(train.mesh_data, train.mesh_model, device=device)
    if train.mesh_data in (-1, 1) and train.mesh_model == 1:
        return local_mesh(resolve_device(device))
    raise ValueError(
        f"train.mesh_data={train.mesh_data} x mesh_model={train.mesh_model} needs that many "
        "ranks: start them under torchrun (`cli train`), or join a process group first "
        "(utils.multihost.init_distributed)")


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's part of a whole train state: params, Adam moments and
    EMA through shard_params."""
    opt = dict(state.opt_state, mu=shard_params(state.opt_state["mu"], mesh),
               nu=shard_params(state.opt_state["nu"], mesh))
    ema = None if state.ema is None else shard_params(state.ema, mesh)
    return TrainState(shard_params(state.params, mesh), opt, state.step, ema)


def gather_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The whole train state on every rank of the model group (the inverse
    of shard_state; every rank calls it)."""
    opt = dict(state.opt_state, mu=gather_params(state.opt_state["mu"], mesh),
               nu=gather_params(state.opt_state["nu"], mesh))
    ema = None if state.ema is None else gather_params(state.ema, mesh)
    return TrainState(gather_params(state.params, mesh), opt, state.step, ema)


def batch_to_device(batch: Batch, device) -> dict:
    """A host batch as tensors on `device`."""
    with span("train.to_device"):
        d = {"inputs": batch.inputs, "targets": batch.targets, "mask": batch.mask}
        if batch.mel is not None:
            d["mel"] = batch.mel
        if batch.speaker is not None:
            d["speaker"] = batch.speaker
        return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in d.items()}


def _check_supported(arch: ArchConfig, train: TrainConfig) -> None:
    if arch.mol:
        from .ops.mol import ROADMAP_REST

        _check_mol(arch, train)
        if train.seq_parallel or train.mesh_model > 1 or train.eval_dir or train.eval_every:
            raise NotImplementedError(
                "a mol arch trains on one rank or data-parallel, without in-training "
                f"evaluation; the rest is {ROADMAP_REST}")
    if train.seq_parallel and train.mesh_model > 1 and (
            train.fused_stack or train.fused_post or train.fused_frontend):
        raise ValueError(
            "seq_parallel with mesh_model > 1 and fused kernels is not supported; drop one "
            "of the three (the TP train step covers fused + model sharding, the SP step "
            "fused + time sharding)")


def _eval_record(state: TrainState, arch: ArchConfig, train: TrainConfig,
                 eval_corpus: Corpus, dev, fused: bool) -> dict:
    """The in-training evaluation of the (whole) params and of the EMA copy,
    through the fused stack when `fused`."""
    from .eval import evaluate

    kw = dict(max_batches=train.eval_batches, fused=fused, tapcat=train.tapcat and fused,
              device=dev)
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
    """Full training run: mesh, data, resume, loop, checkpoints, metrics,
    and every train.eval_every steps an evaluation of the held-out corpus
    (`eval_corpus`, or train.eval_dir), logged as eval_* records (plus
    eval_ema_nll / eval_ema_accuracy with an EMA) and kept out of
    step_time_ms, as checkpoint saves are.

    Across ranks (a running process group; `_train_mesh`) every rank calls
    it: the sequence-parallel, the model-parallel or the data-parallel
    step, in that order of precedence (JAX's routes); the loader unsharded
    (sequence-parallel) or split by data rank (every model rank of one data
    row loads the same rows); metrics and evaluation on rank (0, 0), the
    evaluation unsharded on the whole params (unfused under model
    sharding), with the numbers of a single-device `evaluate`; before every
    checkpoint the divergence guard on every rank, then rank (0, 0) writes
    the whole state (the sharded leaves and their moments gathered), and
    every rank waits at a barrier; a restore re-slices. Returns this rank's
    state (its slices under model sharding)."""
    arch, train = config.arch, config.train
    _check_supported(arch, train)
    mesh = _train_mesh(train, device)
    dev = mesh.device
    lead = (mesh.data_rank, mesh.model_rank) == (0, 0)
    # Model sharding holds the skip split; a sequence-parallel run's model
    # ranks (unfused only, as in JAX) are replicas.
    sharded = mesh.model > 1 and not train.seq_parallel
    if train.seq_parallel:
        step_fn = make_sp_train_step(mesh, arch, train)
    elif sharded:
        step_fn = make_tp_train_step(mesh, arch, train)
    elif mesh.data > 1:
        step_fn = make_dp_train_step(mesh, arch, train)
    else:
        step_fn = None
    if corpus is None:
        corpus = load_corpus(train.data_dir, arch, train.window_size)
    if eval_corpus is None and train.eval_dir:
        eval_corpus = load_corpus(train.eval_dir, arch, train.window_size)
    state = init_state(train.seed, arch, train, dev)
    manager = ckpt_lib.make_manager(train.checkpoint_dir)
    state, start_step = ckpt_lib.restore_if_available(manager, state)
    if sharded:
        state = shard_state(state, mesh)
    loader = (0, 1) if train.seq_parallel else (mesh.data_rank, mesh.data)
    batches = prefetch(make_batches(corpus, train, host_id=loader[0], host_count=loader[1],
                                    start_step=start_step, with_mel=arch.use_local_cond))
    metrics = MetricsLogger(train.metrics_path, enabled=lead,
                            tensorboard_dir=train.tensorboard_dir)
    total = n_steps if n_steps is not None else train.n_steps
    samples_per_step = train.batch_size * train.window_size
    t_last = time.perf_counter()
    try:
        for i in range(start_step, total):
            if train.seq_parallel:
                batch = seq_batch_to_device(next(batches), mesh, train.window_size, dev)
            else:
                batch = batch_to_device(next(batches), dev)
            if step_fn is None:
                state, loss = train_step(state, batch, arch, train)
            else:
                state, loss = step_fn(state, batch)
            if (i + 1) % train.log_every == 0 or i + 1 == total:
                loss_v = float(loss)  # waits for the step
                now = time.perf_counter()
                dt = now - t_last
                t_last = now
                n_logged = min(train.log_every, i + 1 - start_step) or 1
                metrics.log(step=i + 1, loss=loss_v, lr=lr_at(train, i + 1),
                            samples_per_sec=samples_per_step * n_logged / dt,
                            step_time_ms=1000.0 * dt / n_logged)
            whole = None
            if eval_corpus is not None and train.eval_every > 0 and (
                    (i + 1) % train.eval_every == 0 or i + 1 == total):
                whole = gather_state(state, mesh) if sharded else state
                if lead:
                    metrics.log(step=i + 1, **_eval_record(
                        whole, arch, train, eval_corpus, dev,
                        fused=train.fused_stack and mesh.model == 1))
                t_last = time.perf_counter()  # eval time is not step time
            if i + 1 == total or (train.checkpoint_every > 0
                                  and (i + 1) % train.checkpoint_every == 0):
                multihost.assert_replicated_params(state.params, i + 1,
                                                   mesh if sharded else None)
                if whole is None:
                    whole = gather_state(state, mesh) if sharded else state
                if lead:
                    ckpt_lib.save(manager, whole, i + 1)
                if dist.is_initialized():
                    dist.barrier()
                t_last = time.perf_counter()  # nor is a checkpoint's
    finally:
        batches.close()
        metrics.close()
    return state
