"""Plain reference of Tacotron 2's WaveNet vocoder: the teacher-forced
forward, the discretised mixture-of-logistics NLL and the sampler's
distribution, in plain `torch` and float32.

Written from the equations of Shen et al., "Natural TTS Synthesis by
Conditioning WaveNet on Mel Spectrogram Predictions" (arXiv 1712.05884,
section 2.3), with the mixture of PixelCNN++ (arXiv 1701.05517) as Parallel
WaveNet (arXiv 1711.10433) uses it. It imports nothing of the port.

The model. The previous sample x[t - 1] (a real number in [-1, 1)) goes
through a width-K causal convolution from one channel to C; 30 gated
residual layers with dilations 2^(k mod 10) follow, each
    pre = h W_cur + h[t - d] W_prev + b + cond W_cond
    z = tanh(pre[:G]) * sigmoid(pre[G:])
    h <- h + z W_res + b_res,  skip <- skip + z W_skip + b_skip;
the skip sum goes through a ReLU and one linear map to 3 M outputs a
position, [mixture logits | means | log-scales] of M logistics. The
conditioning is 80-bin log-mel frames at a hop of 300 samples (12.5 ms at
24 kHz), upsampled by a projection over the bins and one stage per factor:
a nearest-neighbour repeat by f, a SAME convolution of 2f + 1 taps, and a
leaky ReLU of slope 0.4.

The loss of a sample x under the mixture (N = 65536 bins, log-scales
clamped below at -7, half-bin 1 / (N - 1), s = exp(-log_scale)):
    log p_i = log sigmoid(s (x - mu + 1/(N-1)))              if x < -0.999
            = log(1 - sigmoid(s (x - mu - 1/(N-1))))          if x >  0.999
            = log(cdf_plus - cdf_min)                         if that > 1e-5
            = s (x - mu) - log_scale - 2 softplus(s (x - mu)) - log((N-1)/2)
    NLL = -logsumexp_i(log p_i + log softmax(logits)_i).

Departures from the paper, each where it publishes nothing or the
repository chose otherwise:
- widths C = G = 64, S = 256 and Cc = 64, input kernel K = 2: the paper
  publishes none; these are the repository's;
- the upsampler's two stages are 15 and 20 (hop 300) in the repository's
  stage form above, not the paper's unpublished transposed convolutions;
- the log-mel is the repository's (HTK filterbank over the Hann-windowed
  STFT, n_fft 1024, log clamped at 1e-5), not the paper's 50 ms window and
  125 Hz-7.6 kHz band;
- the input conv's products are taken in float32 whatever `prec` says (a
  16-bit sample rounded to bf16 would lose half its bits); `prec` rounds the
  operands of the stack's and the head's products only;
- sampling at temperature tau divides the logits by tau and scales the
  logistic's width by tau; samples are clamped to [-1, 1] and rounded to
  the 16-bit grid k / 32768.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

N_BINS = 65536
LOG_SCALE_MIN = -7.0


def set_precision() -> None:
    """Float32 products in full float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "float32":
        return x
    if prec == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown precision {prec!r}")


def mm(x: torch.Tensor, w: torch.Tensor, prec: str = "float32") -> torch.Tensor:
    """x @ w with both operands rounded to `prec`, float32 sums."""
    return _round(x, prec) @ _round(w, prec)


def delay(x: torch.Tensor, d: int) -> torch.Tensor:
    """(B, T, C) -> y[:, t] = x[:, t - d], zeros before the start."""
    if d == 0:
        return x
    return torch.cat([x.new_zeros((x.shape[0], d, x.shape[2])), x[:, : x.shape[1] - d]], 1)


def dilations(arch: dict) -> list:
    return [2 ** (k % arch["n_layers_per_block"])
            for k in range(arch["n_blocks"] * arch["n_layers_per_block"])]


def upsample(up: dict, factors, frames: torch.Tensor) -> torch.Tensor:
    """(B, F, n_mels) log-mel frames -> (B, F * hop, Cc), float32."""
    h = frames.to(torch.float32) @ up["proj_w"] + up["proj_b"]
    for f, stage in zip(factors, up["stages"]):
        h = h.repeat_interleave(f, dim=1)
        t = h.shape[1]
        padded = F.pad(h, (0, 0, f, f))
        out = stage["b"] + sum(padded[:, k: k + t] @ stage["w"][k] for k in range(2 * f + 1))
        h = F.leaky_relu(out, 0.4)
    return h


def head_outputs(params: dict, arch: dict, x: torch.Tensor, cond=None,
                 prec: str = "float32") -> torch.Tensor:
    """Teacher-forced: samples x (B, T), x[:, t] the input of step t (the
    sample before the one step t predicts) -> (B, T, 3 M) head outputs."""
    w_in, b_in = params["input_conv"]["w"], params["input_conv"]["b"]
    k_taps = w_in.shape[0]
    xs = x.to(torch.float32)[..., None]
    h = b_in + sum(delay(xs, k_taps - 1 - k) * w_in[k, 0] for k in range(k_taps))
    lp = params["layers"]
    g = lp["w_cur"].shape[-1] // 2
    skip = lp["b_skip"].sum(0)
    for i, d in enumerate(dilations(arch)):
        pre = mm(h, lp["w_cur"][i], prec) + mm(delay(h, d), lp["w_prev"][i], prec) + lp["b"][i]
        if cond is not None:
            pre = pre + mm(cond, lp["w_cond"][i], prec)
        z = torch.tanh(pre[..., :g]) * torch.sigmoid(pre[..., g:])
        skip = skip + mm(z, lp["w_skip"][i], prec)
        h = h + mm(z, lp["w_res"][i], prec) + lp["b_res"][i]
    return mm(torch.relu(skip), params["mol"]["w"], prec) + params["mol"]["b"]


def mixture(y: torch.Tensor, n_mix: int):
    """The sampler's distribution of head outputs y (..., 3 M): (component
    probabilities, means, scales), each (..., M); a component's logistic
    has CDF sigmoid((x - mean) / scale)."""
    logits, means, raw = y[..., :n_mix], y[..., n_mix: 2 * n_mix], y[..., 2 * n_mix:]
    return torch.softmax(logits, -1), means, torch.exp(torch.clamp(raw, min=LOG_SCALE_MIN))


def nll(y: torch.Tensor, x: torch.Tensor, n_mix: int) -> torch.Tensor:
    """(...,) negative log-likelihood of x under the discretised mixture."""
    logits, means, raw = y[..., :n_mix], y[..., n_mix: 2 * n_mix], y[..., 2 * n_mix:]
    log_scale = torch.clamp(raw, min=LOG_SCALE_MIN)
    inv = torch.exp(-log_scale)
    xc = x[..., None] - means
    half = 1.0 / (N_BINS - 1)
    plus_in, min_in, mid_in = inv * (xc + half), inv * (xc - half), inv * xc
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = F.logsigmoid(plus_in)
    log_one_minus_cdf_min = F.logsigmoid(-min_in)
    log_pdf_mid = mid_in - log_scale - 2.0 * F.softplus(mid_in) - math.log((N_BINS - 1) / 2)
    inner = torch.where(cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
                        log_pdf_mid)
    xe = x[..., None].expand_as(xc)
    log_p = torch.where(xe < -0.999, log_cdf_plus,
                        torch.where(xe > 0.999, log_one_minus_cdf_min, inner))
    return -torch.logsumexp(log_p + torch.log_softmax(logits, -1), -1)


def masked_loss(params: dict, arch: dict, batch: dict, window: int,
                prec: str = "float32", cond=None) -> torch.Tensor:
    """Mean NLL over the last `window` positions where the mask is 1 (the
    mask's sum clamped at 1); `cond` (B, >= T, Cc) the upsampled frames."""
    x = batch["inputs"]
    if cond is not None:
        cond = cond[:, : x.shape[1]]
    y = head_outputs(params, arch, x, cond, prec)[:, -window:]
    loss = nll(y, batch["targets"].to(torch.float32), arch["n_mix"]) * batch["mask"]
    return loss.sum() / torch.clamp(batch["mask"].sum(), min=1.0)


def sample(y: torch.Tensor, n_mix: int, temperature: float, gumbel=None, u=None):
    """Samples (B,) of the mixtures y (B, 3 M) at the given noise: the
    component argmax(logits / tau + gumbel), then its logistic's inverse
    CDF at u, scaled by tau; greedy (tau = 0) the likeliest component's
    mean. Clamped to [-1, 1] and rounded to k / 32768."""
    probs, means, scales = mixture(y, n_mix)
    if temperature == 0.0:
        k = probs.argmax(-1, keepdim=True)
        x = means.gather(-1, k)[..., 0]
    else:
        k = (y[..., :n_mix] / temperature + gumbel).argmax(-1, keepdim=True)
        x = (means.gather(-1, k)[..., 0]
             + temperature * scales.gather(-1, k)[..., 0] * torch.log(u / (1 - u)))
    q = torch.round(torch.clamp(x, -1.0, 1.0) * 32768.0)
    return torch.clamp(q, -32768.0, 32767.0) / 32768.0
