"""The discretised mixture of logistics (MoL) output of Tacotron 2's WaveNet
vocoder (Shen et al., arXiv 1712.05884, section 2.3), in plain PyTorch:
the masked negative log-likelihood, its gradient written out, and the
sampler. The CPU path of the model, and the plain version of the head
kernel pair (ops/cuda/post_mol.py).

The head's 3 M outputs a position are [mixture logits (M) | means (M) |
raw log-scales (M)] for M = arch.n_mix components (PixelCNN++'s layout,
arXiv 1701.05517). Samples x lie in [-1, 1] on a grid of N = 65536 (16-bit)
bins; a bin's half-width is taken as 1 / (N - 1), as PixelCNN++ takes it.
With log-scales clamped below at -7, s = exp(-log_scale), c = x - mean:

    plus = s (c + 1/(N-1)),  minus = s (c - 1/(N-1)),  mid = s c
    x < -0.999:  log p_i = log sigmoid(plus)
    x >  0.999:  log p_i = log(1 - sigmoid(minus))
    otherwise:   log(sigmoid(plus) - sigmoid(minus)) where that is > 1e-5,
                 else the mid-bin log-density less log((N - 1) / 2):
                 mid - log_scale - 2 softplus(mid) - log((N - 1) / 2)
    NLL = -logsumexp_i(log p_i + log_softmax(logits)_i)

All of it in float32. `mol_nll_bwd` gives the gradient of the masked sum
with respect to the 3 M outputs in closed form (the head kernel's backward
computes the same expressions); the tests hold it against autograd of the
plain reference (reference/mol_wavenet.py).

Sampling (`sample_mol`): the component by Gumbel-max over the mixture
logits (M Gumbel draws), then the component's logistic at one uniform u:
x = mean + exp(log_scale) (log u - log(1 - u)), clamped to [-1, 1] and
rounded to the 16-bit grid of the corpus (k / 32768, k in [-32768, 32767]).
Temperature tau > 0 divides the logits and scales the logistic's width;
tau = 0 is greedy: the most likely component's mean, rounded to the grid.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

N_BINS = 65536          # 16-bit samples
LOG_SCALE_MIN = -7.0
EDGE = 0.999
DELTA_MIN = 1e-5
PCM_SCALE = 32768.0     # the corpus's grid: int16 / 32768

# What a mol arch does not run yet, as the raise sites name it.
ROADMAP_ENGINES = ("ROADMAP.md A item 10: the in-kernel MoL sampler for mega with scalar-input "
                   "feedback (then SessionPool and HTTP serving), and turbo, pallas and tp")
ROADMAP_PACK = "ROADMAP.md A item 11: packed corpora of 16-bit linear samples for mol archs"
ROADMAP_REST = ("ROADMAP.md A item 12: mol evaluation, and sequence- and model-parallel "
                "mol training")


def split_head(y: torch.Tensor, n_mix: int):
    """(..., 3 M) head outputs -> (logits, means, log_scales before the
    clamp), each (..., M)."""
    return y[..., :n_mix], y[..., n_mix: 2 * n_mix], y[..., 2 * n_mix: 3 * n_mix]


def _terms(y: torch.Tensor, x: torch.Tensor, n_mix: int):
    """The per-component quantities of the NLL at targets x (...,)."""
    logit, mean, raw = split_head(y.to(torch.float32), n_mix)
    ls = torch.clamp(raw, min=LOG_SCALE_MIN)
    inv = torch.exp(-ls)
    c = x.to(torch.float32)[..., None] - mean
    half = 1.0 / (N_BINS - 1)
    plus, minus, mid = inv * (c + half), inv * (c - half), inv * c
    return logit, raw, ls, plus, minus, mid


def _log_probs(y, x, n_mix):
    """(log p_i (..., M), case masks, terms) of the discretised logistics."""
    logit, raw, ls, plus, minus, mid = _terms(y, x, n_mix)
    cdf_plus, cdf_min = torch.sigmoid(plus), torch.sigmoid(minus)
    delta = cdf_plus - cdf_min
    log_cdf_plus = plus - F.softplus(plus)
    log_one_minus_cdf_min = -F.softplus(minus)
    log_pdf_mid = mid - ls - 2.0 * F.softplus(mid) - math.log((N_BINS - 1) / 2)
    low = (x.to(torch.float32) < -EDGE)[..., None].expand_as(plus)
    high = (x.to(torch.float32) > EDGE)[..., None].expand_as(plus)
    wide = delta > DELTA_MIN
    inner = torch.where(wide, torch.log(torch.clamp(delta, min=1e-12)), log_pdf_mid)
    lp = torch.where(low, log_cdf_plus, torch.where(high, log_one_minus_cdf_min, inner))
    return lp, (low, high, wide), (logit, raw, ls, plus, minus, mid, cdf_plus, cdf_min, delta)


def mol_nll(y: torch.Tensor, x: torch.Tensor, n_mix: int) -> torch.Tensor:
    """(...,) negative log-likelihood of samples x under the mixture the
    head outputs y (..., 3 M) give."""
    lp, _, t = _log_probs(y, x, n_mix)
    return -torch.logsumexp(lp + torch.log_softmax(t[0], -1), -1)


def mol_nll_bwd(y: torch.Tensor, x: torch.Tensor, n_mix: int,
                weight: torch.Tensor) -> torch.Tensor:
    """d (sum weight * NLL) / d y, (..., 3 M) float32, in closed form; weight
    (...,) is mask times the upstream cotangent."""
    lp, (low, high, wide), t = _log_probs(y, x, n_mix)
    logit, raw, ls, plus, minus, mid, cdf_plus, cdf_min, delta = t
    log_mix = torch.log_softmax(logit, -1)
    resp = torch.softmax(lp + log_mix, -1)            # posterior of each component
    d_logit = torch.softmax(logit, -1) - resp
    # d log p_i / d plus, / d minus, / d mid in each case; then through
    # plus = s (c + h), minus = s (c - h), mid = s c with s = exp(-ls):
    # d/d mean = -s (d/dplus + d/dminus + d/dmid), d/d ls = -(plus d/dplus +
    # minus d/dminus + mid d/dmid) (- 1 for the mid-bin density's own -ls).
    zero = torch.zeros_like(plus)
    sp, sm, sd = torch.sigmoid(-plus), torch.sigmoid(minus), torch.sigmoid(mid)
    safe = torch.clamp(delta, min=1e-12)
    g_plus_in = torch.where(wide, cdf_plus * sp / safe, zero)
    g_minus_in = torch.where(wide, -cdf_min * (1.0 - cdf_min) / safe, zero)
    g_mid_in = torch.where(wide, zero, 1.0 - 2.0 * sd)
    g_ls_in = torch.where(wide, zero, -torch.ones_like(plus))
    g_plus = torch.where(low, sp, torch.where(high, zero, g_plus_in))
    g_minus = torch.where(low, zero, torch.where(high, -sm, g_minus_in))
    g_mid = torch.where(low | high, zero, g_mid_in)
    g_ls = torch.where(low | high, zero, g_ls_in)
    inv = torch.exp(-ls)
    dlp_mean = -inv * (g_plus + g_minus + g_mid)
    dlp_ls = g_ls - (plus * g_plus + minus * g_minus + mid * g_mid)
    d_mean = -resp * dlp_mean
    d_raw = torch.where(raw >= LOG_SCALE_MIN, -resp * dlp_ls, zero)
    w = weight.to(torch.float32)[..., None]
    return torch.cat([d_logit * w, d_mean * w, d_raw * w], -1)


def masked_nll_sum(y: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                   n_mix: int) -> torch.Tensor:
    """sum of mask * NLL, a 0-dim float32 tensor (the masked loss's
    numerator: gradient accumulation adds these and the mask sums)."""
    return (mol_nll(y, targets, n_mix) * mask.to(torch.float32)).sum()


def to_grid(x: torch.Tensor) -> torch.Tensor:
    """x clamped to [-1, 1] and rounded to the 16-bit grid k / 32768."""
    k = torch.round(torch.clamp(x, -1.0, 1.0) * PCM_SCALE)
    return torch.clamp(k, -PCM_SCALE, PCM_SCALE - 1.0) / PCM_SCALE


def sample_mol(y: torch.Tensor, n_mix: int, temperature: float, gumbel=None,
               u=None) -> torch.Tensor:
    """(B,) samples of the mixtures y (B, 3 M): `gumbel` (B, M) noise picks
    the component (Gumbel-max over logits / tau), `u` (B,) in (0, 1) draws
    its logistic; at tau = 0 (greedy) neither is used."""
    logit, mean, raw = split_head(y.to(torch.float32), n_mix)
    ls = torch.clamp(raw, min=LOG_SCALE_MIN)
    if temperature == 0.0:
        k = torch.argmax(logit, -1, keepdim=True)
        return to_grid(mean.gather(-1, k)[..., 0])
    k = torch.argmax(logit / temperature + gumbel, -1, keepdim=True)
    m, s = mean.gather(-1, k)[..., 0], ls.gather(-1, k)[..., 0]
    x = m + temperature * torch.exp(s) * (torch.log(u) - torch.log1p(-u))
    return to_grid(x)


def pcm16(wave) -> "numpy.ndarray":  # noqa: F821
    """Float waves in [-1, 1] -> int32 16-bit PCM values in [-32768, 32767]
    (an int16 file read as int16 / 32768 comes back exactly)."""
    import numpy as np

    w = np.asarray(wave, dtype=np.float32)
    return np.clip(np.round(w.astype(np.float64) * PCM_SCALE), -PCM_SCALE,
                   PCM_SCALE - 1).astype(np.int32)
