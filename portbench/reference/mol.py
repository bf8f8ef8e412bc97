"""The plain reference of Tacotron 2's WaveNet vocoder (the `tacotron2_mol`
configuration), in plain PyTorch: the benchmark's own copy, beside
`model.py`, whose products, rounding, shift and upsampler it uses.

It imports nothing of the program. Written from the equations of Shen et
al. (arXiv 1712.05884, section 2.3) and PixelCNN++ (arXiv 1701.05517):
the previous sample (a real number) through a width-K causal conv from one
channel to C, in float32; the gated stack as `model.skip_sum` runs it; a
ReLU of the skip sum and one linear map to 3 M outputs, [mixture logits |
means | log-scales]; the loss the discretised mixture's NLL of the 16-bit
target (half-bin 1 / 65535, log-scales clamped at -7, the edge cases x <
-0.999 and x > 0.999, the mid-bin density where the bin's mass is <= 1e-5).

Batches are derived from the raw waves again: 16-bit PCM (round(x 32768)
clipped to int16), inputs and targets k / 32768 on `loader.py`'s window
geometry, order and mask, log-mel frames over each window's input span.
`prec` as in `model.py` ("float32", "bfloat16", or "fp8" for the control).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import checks, loader, model

N_BINS = 65536


def pcm16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(np.asarray(x, np.float64) * 32768.0), -32768, 32767).astype(np.int32)


def head_outputs(params: dict, arch: dict, x: torch.Tensor, prec: str,
                 cond=None) -> torch.Tensor:
    """Samples x (B, T), x[:, t] the input of step t -> (B, T, 3 M)."""
    w_in, b_in = params["input_conv"]["w"], params["input_conv"]["b"]
    k_taps = w_in.shape[0]
    xs = x.to(torch.float32)[..., None]
    h = b_in
    for k in range(k_taps):
        h = h + model.shift(xs, k_taps - 1 - k) * w_in[k, 0]
    lp = params["layers"]
    g = lp["w_cur"].shape[-1] // 2
    total = lp["b_skip"].sum(0)
    for i, d in enumerate(model.dilations(arch)):
        pre = (model.mm(h, lp["w_cur"][i], prec) + model.mm(model.shift(h, d), lp["w_prev"][i], prec)
               + lp["b"][i])
        if cond is not None:
            pre = pre + model.mm(cond, lp["w_cond"][i], prec)
        z = torch.tanh(pre[..., :g]) * torch.sigmoid(pre[..., g:])
        total = total + model.mm(z, lp["w_skip"][i], prec)
        h = h + model.mm(z, lp["w_res"][i], prec) + lp["b_res"][i]
    return model.mm(torch.relu(total), params["mol"]["w"], prec) + params["mol"]["b"]


def nll(y: torch.Tensor, x: torch.Tensor, n_mix: int) -> torch.Tensor:
    """(...,) NLL of samples x under the discretised mixtures y (..., 3 M)."""
    logits, means = y[..., :n_mix], y[..., n_mix: 2 * n_mix]
    log_scales = torch.clamp(y[..., 2 * n_mix: 3 * n_mix], min=-7.0)
    inv = torch.exp(-log_scales)
    xc = x[..., None] - means
    half = 1.0 / (N_BINS - 1)
    plus_in, min_in, mid_in = inv * (xc + half), inv * (xc - half), inv * xc
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    mid = mid_in - log_scales - 2.0 * F.softplus(mid_in) - math.log((N_BINS - 1) / 2)
    inner = torch.where(cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)), mid)
    xe = x[..., None].expand_as(xc)
    log_p = torch.where(xe < -0.999, F.logsigmoid(plus_in),
                        torch.where(xe > 0.999, F.logsigmoid(-min_in), inner))
    return -torch.logsumexp(log_p + torch.log_softmax(logits, -1), -1)


def masked_loss(params: dict, arch: dict, batch: dict, window: int, prec: str) -> torch.Tensor:
    """Mean NLL over the last `window` positions where the mask is 1."""
    cond = None
    if batch.get("mel") is not None:
        cond = model.upsample(params["upsampler"], arch, batch["mel"])[:, : batch["inputs"].shape[1]]
    y = head_outputs(params, arch, batch["inputs"], prec, cond)[:, -window:]
    loss = nll(y, batch["targets"], arch["n_mix"]) * batch["mask"]
    return loss.sum() / torch.clamp(batch["mask"].sum(), min=1.0)


def broaden(params: dict, arch: dict, shift: float) -> dict:
    """A copy of params whose head bias raises every log-scale by `shift`:
    a mixture of broad components, where bf16 rounding does not decide the
    gradient (at the seeded weights a few sharp components, log-scales of
    -5 to -7, carry most of it and move with the rounding of their
    means)."""
    p = {k: v for k, v in params.items()}
    m = arch["n_mix"]
    b = params["mol"]["b"].clone()
    b[2 * m: 3 * m] += shift
    p["mol"] = dict(params["mol"], b=b)
    return p


def diff_gap(got: dict, want: dict) -> float:
    """Worst leaf of norm(got - want) / max(norm(want), median leaf norm of
    want): a gap in direction as well as in size."""
    norms = {k: float(torch.linalg.vector_norm(v.float())) for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    worst = 0.0
    for k, v in want.items():
        d = float(torch.linalg.vector_norm(got[k].float().to(v.device) - v.float()))
        gap = d / max(norms[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def batches(waves, arch: dict, batch: int, w: int, seed: int, steps: int, device) -> list:
    """The first `steps` batches of the recipe over 16-bit samples."""
    r = model.receptive_field(arch)
    pcm = [pcm16(x) for x in waves]
    counts = [loader.n_windows(len(e), w) for e in pcm]
    prefix = np.concatenate([[0], np.cumsum(counts)])
    n = int(prefix[-1])
    perms: dict = {}
    out = []
    for s in range(steps):
        rows = []
        for k in range(batch):
            g = s * batch + k
            ep = g // n
            if ep not in perms:
                perms[ep] = np.random.default_rng(np.random.SeedSequence([seed, ep])).permutation(n)
            pick = int(perms[ep][g % n])
            fi = int(np.searchsorted(prefix, pick, side="right")) - 1
            rows.append(loader.window(pcm[fi], w, r, pick - int(prefix[fi])) + (fi,))
        b = {"inputs": np.stack([x[0] for x in rows]).astype(np.float32) / 32768.0,
             "targets": np.stack([x[1] for x in rows]).astype(np.float32) / 32768.0,
             "mask": np.stack([x[2] for x in rows])}
        b = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
             for k, v in b.items()}
        if arch["n_mels"] > 0:
            hop, n_in = math.prod(arch["upsample_factors"]), r - 1 + w
            segs = np.zeros((batch, n_in), np.float32)
            for j, (_, _, _, t0, fi) in enumerate(rows):
                lo, hi = max(t0 - r, 0), min(t0 - r + n_in, len(waves[fi]))
                segs[j, lo - (t0 - r): hi - (t0 - r)] = waves[fi][lo:hi]
            b["mel"] = loader.log_mel(torch.from_numpy(segs), arch["n_mels"], hop,
                                      arch["sample_rate"])[:, : -(-n_in // hop)].to(device)
        out.append(b)
    return out


def reference_steps(params, arch, train, waves, seed, steps, prec, device, rows=None):
    """(losses, first gradient leaves, parameter leaves after `steps`) of
    the reference's Adam steps on the mol recipe (`checks.reference_steps`'
    Adam); `rows` keeps only that many rows of each batch (the fault)."""
    model.set_precision()
    p = {path: t.detach().clone().to(device) for path, t in checks.leaves(params)}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, lr, eps = train["adam_b1"], train["adam_b2"], train["learning_rate"], 1e-8
    losses, g_first = [], None
    for s, batch in enumerate(batches(waves, arch, train["batch_size"], train["window_size"],
                                      seed, steps, device)):
        if rows is not None:
            batch = {k: v[:rows] for k, v in batch.items()}
        for v in p.values():
            v.requires_grad_(True)
        loss = masked_loss(checks._rebuild(params, p), arch, batch, train["window_size"], prec)
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
                p[k] = p[k].detach() - lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps))
    return losses, g_first, {k: v.detach() for k, v in p.items()}


def generation_gap(params, arch: dict, samples: torch.Tensor, program_y: torch.Tensor,
                   prec: str, frames=None) -> float:
    """The widest gap between the program's head outputs of generated steps
    (B, T, 3 M) and the reference's teacher-forced forward over the same
    samples (the input of step t the sample of step t - 1, 0 at t = 0), over
    the root mean square of the reference's outputs."""
    x = torch.cat([torch.zeros_like(samples[:, :1]), samples[:, :-1]], 1)
    cond = None
    if frames is not None:
        cond = model.upsample(params["upsampler"], arch, frames)[:, : x.shape[1]]
    with torch.no_grad():
        want = head_outputs(params, arch, x, prec, cond)
    gap = (program_y.to(want.device) - want).abs().max()
    return float(gap / want.pow(2).mean().sqrt())
