"""Log-mel spectrogram frontend (port of `lb_wavenet_tpu/ops/mel.py`).

The local-conditioning features of the vocoder: an HTK mel filterbank over
the magnitude STFT, log-compressed. Frames are centred (reflect padding),
so frame i corresponds to sample i * hop. The filterbank is numpy, as in
the JAX package (the port keeps its own copy of it); the spectrogram runs
on torch tensors on any device (`torch.fft.rfft`). It is computed once per
utterance, outside the sample loop.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int, fmin: float = 0.0,
                   fmax: float = None) -> np.ndarray:
    """Triangular HTK mel filterbank, shape (n_fft // 2 + 1, n_mels)."""
    fmax = fmax or sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of numpy's "reflect" padding of a length-n signal by `pad`
    each side, for any pad (a pad past the signal's end reflects again:
    the signal's mirror sequence with period 2 (n - 1))."""
    i = torch.arange(-pad, n + pad, device=device).abs() % max(2 * (n - 1), 1)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def log_mel_spectrogram(wav: torch.Tensor, n_mels: int = 80, n_fft: int = 1024,
                        hop: int = 256, sample_rate: int = 16000) -> torch.Tensor:
    """Waveform (B, T) -> log-mel frames (B, ceil(T / hop), n_mels), float32,
    on the waveform's device."""
    wav = torch.as_tensor(wav, dtype=torch.float32)
    if wav.ndim == 1:
        wav = wav[None]
    pad = n_fft // 2
    x = wav[:, _reflect_index(wav.shape[1], pad, wav.device)]
    n_frames = -(-wav.shape[1] // hop)
    frames = x.unfold(1, n_fft, hop)[:, :n_frames]          # (B, n_frames, n_fft)
    window = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(wav.device)
    spec = torch.fft.rfft(frames * window, dim=-1).abs()
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate)).to(wav.device)
    mel = spec @ fb
    return torch.log(torch.clamp(mel, min=1e-5))
