"""The numbers that decide `correct`, worked out by the reference.

Serving (`served_gap`): each sampled greedy request's served classes are
run through the reference teacher-forced (the input of step t is the class
served at t - 1, the zero waveform's class Q // 2 at t = 0, zero context
before it); a served class should be the reference's best at its step, and
the number is the widest gap by which a served class's logit lies below
the reference's best. The control (`control_gap`) reads, on the same
classes, the gap of the class the lower precision puts first.

Training (`train_numbers`): the reference follows the program's first
three steps from the same weights on the same waves (its own batches,
`loader.batches`), with Adam as optax takes it, and compares each step's
loss, the first gradient per leaf, and each leaf's change after three
steps; norms by the worst leaf, each gap over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the leaf numbers.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import loader, model


def _request_logits(params, arch, classes, prec):
    q = arch["quant_channels"]
    dev = params["embed"].device
    cls = torch.as_tensor(np.asarray(classes, np.int64), device=dev)
    x = torch.cat([torch.full((1,), q // 2, dtype=torch.int64, device=dev), cls[:-1]])[None]
    with torch.no_grad():
        return model.logits(params, arch, x, prec)[0], cls


def served_gap(params, arch, classes) -> float:
    """Widest gap below the reference's best of the served classes."""
    lg, cls = _request_logits(params, arch, classes, "bfloat16" if arch["compute_dtype"]
                              == "bfloat16" else "float32")
    return float((lg.max(-1).values - lg.gather(-1, cls[:, None])[:, 0]).max())


def control_gap(params, arch, classes, control_prec: str) -> float:
    """Widest gap below the reference's best of the classes the control
    (the reference in `control_prec`) puts first at each step."""
    ref_prec = "bfloat16" if arch["compute_dtype"] == "bfloat16" else "float32"
    lg, _ = _request_logits(params, arch, classes, ref_prec)
    lc, _ = _request_logits(params, arch, classes, control_prec)
    pick = lc.argmax(-1)
    return float((lg.max(-1).values - lg.gather(-1, pick[:, None])[:, 0]).max())


def leaves(tree, path=()) -> list:
    """[(path, tensor)] in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    return [(path, tree)]


def reference_steps(params, arch, train, waves, seed, steps, prec, device, rows=None,
                    start=None):
    """(losses, first gradient leaves, parameter leaves after `steps`) of
    the reference's Adam steps; `rows` keeps only that many rows of each
    batch (a fault: part of the batch left out, the mean over the rest).
    `start` ({"steps": k, "params", "mu", "nu": leaf dicts}) takes the
    reference on from another's state after its first k steps: the losses
    and gradient are then those of steps k + 1 onwards."""
    model.set_precision()
    p = {path: t.detach().clone().to(device) for path, t in leaves(params)}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    done = 0
    if start is not None:
        done = start["steps"]
        p, mu, nu = ({k: start[part][k].detach().clone().to(device) for k in p}
                     for part in ("params", "mu", "nu"))
    tree = _rebuild(params, p)
    b1, b2, lr, eps = train["adam_b1"], train["adam_b2"], train["learning_rate"], 1e-8
    losses, g_first = [], None
    for s, batch in enumerate(loader.batches(waves, arch, train["batch_size"],
                                             train["window_size"], seed, steps, device)):
        if s < done:
            continue
        if rows is not None:
            batch = {k: v[:rows] for k, v in batch.items()}
        for v in p.values():
            v.requires_grad_(True)
        loss = model.masked_loss(tree, arch, batch, train["window_size"], prec)
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True,
                                    materialize_grads=True)
        losses.append(float(loss.detach()))
        g = dict(zip(p.keys(), grads))
        if g_first is None:
            g_first = {k: v.detach().clone() for k, v in g.items()}
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** (s + 1), 1 - b2 ** (s + 1)
            for k in p:
                mu[k] = (1 - b1) * g[k] + b1 * mu[k]
                nu[k] = (1 - b2) * g[k] * g[k] + b2 * nu[k]
                p[k] = (p[k].detach() - lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)))
        tree = _rebuild(params, p)
    return losses, g_first, {k: v.detach() for k, v in p.items()}


def _rebuild(template, flat: dict):
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return flat[path]

    return walk(template, ())


def leaf_gap(got: dict, want: dict, keep) -> float:
    """Worst leaf of |norm(got) - norm(want)| / max(norm(want), median leaf
    norm of want), over the leaves `keep` accepts."""
    norms = {k: float(torch.linalg.vector_norm(v.float())) for k, v in want.items()}
    med = float(np.median([norms[k] for k in keep]))
    worst = 0.0
    for k in keep:
        g = float(torch.linalg.vector_norm(got[k].float().to(want[k].device)))
        gap = abs(g - norms[k]) / max(norms[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def train_numbers(prog: dict, ref: tuple, params0: dict) -> dict:
    """The compared numbers from the program's readings `prog` (losses,
    first gradient and parameters after the steps, as leaf dicts) and the
    reference's `ref` (reference_steps): the loss gap of the worst step
    (`loss_gap`) and of the first (`loss1_gap`, before any update), the
    first gradient's and the change's gaps by the worst leaf."""
    r_loss, r_g, r_p = ref
    gn = {k: float(torch.linalg.vector_norm(v)) for k, v in r_g.items()}
    med = float(np.median(list(gn.values())))
    keep = [k for k in r_g if gn[k] >= 1e-3 * med]
    p0 = {k: v.to(r_p[k].device) for k, v in params0.items()}
    r_change = {k: r_p[k] - p0[k] for k in keep}
    p_change = {k: prog["params"][k].to(r_p[k].device) - p0[k] for k in keep}
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], r_loss)]
    gaps = [x if math.isfinite(x) else math.inf for x in gaps]
    return {
        "loss_gap": max(gaps),
        "loss1_gap": gaps[0],
        "loss_gaps": gaps,
        "grad_gap": leaf_gap(prog["grad"], r_g, keep),
        "change_gap": leaf_gap(p_change, r_change, keep),
        "leaves_compared": len(keep),
        "leaves_left_out": len(r_g) - len(keep),
    }
