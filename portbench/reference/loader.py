"""The reference's own derivation of training batches from the raw waves.

The benchmark hands the program and the reference the same float waves;
the program's loader encodes them, orders the windows and cuts them, and
this module does all of that again: mu-law classes (mu = Q - 1, the
mid-rise quantizer), windows of R - 1 + W inputs and W targets (every
sample but a file's first is a target of exactly one window; a target is
masked unless it is real and its whole receptive field lies in the file),
each epoch a permutation of all (file, window) pairs drawn from
SeedSequence([seed, epoch]), batch row k of step s the pair at position
s * B + k, and a mel-conditioned arch's log-mel frames of the float wave
over each window's input span (HTK mel filterbank over the magnitude STFT
of a Hann window, reflect-padded centred frames, log clamped at 1e-5).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def mu_law_encode(x: np.ndarray, q: int) -> np.ndarray:
    mu = q - 1
    x = np.clip(x.astype(np.float32), -1.0, 1.0)
    denom = np.float32(math.log1p(float(mu)))
    comp = np.sign(x) * np.log1p(np.float32(mu) * np.abs(x)) / denom
    return np.clip(np.floor((comp + np.float32(1.0)) / np.float32(2.0) * np.float32(mu)
                            + np.float32(0.5)), 0, mu).astype(np.int32)


def n_windows(file_len: int, window: int) -> int:
    return 0 if file_len < 2 else -(-(file_len - 1) // window)


def window(enc: np.ndarray, w: int, r: int, index: int):
    """(inputs [R - 1 + W], targets [W], mask [W]) of window `index`."""
    n = len(enc)
    t0 = 1 + index * w
    t1 = min(t0 + w, n)
    idx = np.arange(t0 - r, t0 + w - 1)
    ok = (idx >= 0) & (idx < n)
    inputs = np.where(ok, enc[np.clip(idx, 0, n - 1)], 0)
    tgt = np.arange(t0, t0 + w)
    real = tgt < t1
    targets = np.where(real, enc[np.clip(tgt, 0, n - 1)], 0)
    mask = (real & (tgt - r >= 0)).astype(np.float32)
    return inputs.astype(np.int32), targets.astype(np.int32), mask, t0


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int) -> np.ndarray:
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    hz = to_hz(np.linspace(to_mel(0.0), to_mel(sample_rate / 2.0), n_mels + 2))
    fb = np.zeros((len(freqs), n_mels), np.float32)
    for m in range(n_mels):
        up = (freqs - hz[m]) / max(hz[m + 1] - hz[m], 1e-9)
        down = (hz[m + 2] - freqs) / max(hz[m + 2] - hz[m + 1], 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def log_mel(wav: torch.Tensor, n_mels: int, hop: int, sample_rate: int,
            n_fft: int = 1024) -> torch.Tensor:
    """(B, T) float waves -> (B, ceil(T / hop), n_mels) log-mel frames."""
    n, pad = wav.shape[1], n_fft // 2
    i = torch.arange(-pad, n + pad, device=wav.device).abs() % max(2 * (n - 1), 1)
    x = wav[:, torch.where(i >= n, 2 * (n - 1) - i, i)]
    frames = x.unfold(1, n_fft, hop)[:, : -(-n // hop)]
    win = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(wav.device)
    spec = torch.fft.rfft(frames * win, dim=-1).abs()
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate)).to(wav.device)
    return torch.log(torch.clamp(spec @ fb, min=1e-5))


def batches(waves, arch: dict, batch: int, w: int, seed: int, steps: int, device) -> list:
    """The first `steps` batches of the recipe, as dicts of tensors."""
    r = 1 + (arch["input_kernel"] - 1) + sum(
        2 ** i for _ in range(arch["n_blocks"]) for i in range(arch["n_layers_per_block"]))
    enc = [mu_law_encode(x, arch["quant_channels"]) for x in waves]
    counts = [n_windows(len(e), w) for e in enc]
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
            rows.append(window(enc[fi], w, r, pick - int(prefix[fi])) + (fi,))
        b = {"inputs": np.stack([x[0] for x in rows]), "targets": np.stack([x[1] for x in rows]),
             "mask": np.stack([x[2] for x in rows])}
        b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        if arch["n_mels"] > 0:
            hop, n_in = math.prod(arch["upsample_factors"]), r - 1 + w
            segs = np.zeros((batch, n_in), np.float32)
            for j, (_, _, _, t0, fi) in enumerate(rows):
                lo, hi = max(t0 - r, 0), min(t0 - r + n_in, len(waves[fi]))
                segs[j, lo - (t0 - r): hi - (t0 - r)] = waves[fi][lo:hi]
            # On the host, where the program's loader computes them too.
            b["mel"] = log_mel(torch.from_numpy(segs), arch["n_mels"], hop,
                               arch["sample_rate"])[:, : -(-n_in // hop)].to(device)
        out.append(b)
    return out
