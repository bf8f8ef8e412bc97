"""Local (mel) conditioning frontend: the learned upsampler from frame rate
to sample rate (port of `lb_wavenet_tpu/models/conditioning.py`).

Each stage repeats every frame f times (nearest neighbour) and smooths with
a learned SAME convolution of kernel 2f + 1, then a leaky ReLU (slope
0.4); one stage per factor of `arch.upsample_factors`, whose product is
the hop size. The stack runs once per utterance, outside the sample loop,
in float32 whatever the compute dtype; only its output is cast to the
compute dtype (it halves the per-step stream the samplers read). As the
JAX package leaves it to XLA's convolutions, the port leaves it to plain
PyTorch. Every contraction (the projection over mel bins, each
convolution over its taps and input channels) is written as a fixed
sequence of float32 multiplies and adds over whole time rows, in (tap,
channel) order: a library matmul or convolution may sum in another order
for another input length, and then a streamed upsampling (a window of
frames at a time) would not equal the one-shot one bit for bit. Here an
output sample's arithmetic does not depend on the input's length.

Parameters keep the JAX layout: proj_w (n_mels, Cc), proj_b (Cc,) and a
list of stages {"w": (2f+1, Cc, Cc) as (tap, in, out), "b": (Cc,)}.
"""
from __future__ import annotations

import math
from typing import Union

import torch

from ..config import ArchConfig
from .wavenet import _generator


def init_upsampler_params(rng: Union[int, torch.Generator], arch: ArchConfig,
                          device="cpu") -> dict:
    """Random upsampler parameters in the JAX layout (the port's own RNG
    stream)."""
    gen = _generator(rng)
    cc = arch.cond_channels

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=gen) / math.sqrt(fan_in)).to(device)

    params = {
        "proj_w": normal((arch.n_mels, cc), float(arch.n_mels)),
        "proj_b": torch.zeros((cc,), device=device),
        "stages": [],
    }
    for f in arch.upsample_factors:
        k = 2 * f + 1  # the smoothing kernel spans one original frame each side
        params["stages"].append({"w": normal((k, cc, cc), float(k * cc)),
                                 "b": torch.zeros((cc,), device=device)})
    return params


def _contract(x: torch.Tensor, w: torch.Tensor, acc=None) -> torch.Tensor:
    """acc + x (.., K) @ w (K, N), as K multiplies and adds in k order (no
    library reduction: the same arithmetic for every row at any length)."""
    for i in range(w.shape[0]):
        term = x[..., i: i + 1] * w[i]
        acc = term if acc is None else acc + term
    return acc


def upsample_cond(params: dict, arch: ArchConfig, frames: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """(B, F, n_mels) frame features -> (B, F * hop, Cc) in `dtype`,
    computed in float32."""
    h = _contract(frames.to(torch.float32), params["proj_w"].to(torch.float32))
    h = h + params["proj_b"]
    for f, stage in zip(arch.upsample_factors, params["stages"]):
        h = torch.repeat_interleave(h, f, dim=1)                # (B, T, Cc)
        w = stage["w"].to(torch.float32)                        # (tap, in, out)
        t = h.shape[1]
        hp = torch.nn.functional.pad(h, (0, 0, f, f))           # SAME: f zeros each side
        out = None
        for k in range(w.shape[0]):
            out = _contract(hp[:, k: k + t], w[k], out)
        h = torch.nn.functional.leaky_relu(out + stage["b"], 0.4)
    return h.to(dtype)


def cond_halo_frames(arch: ArchConfig) -> int:
    """Frames of context (each side) after which chunked upsampling is
    exact: stage s depends on +-1 frame at its input rate, 1 / (f_1 ...
    f_{s-1}) original frames, so the radius is 1 + 1/f_1 + ... < 2."""
    r, p = 0.0, 1
    for f in arch.upsample_factors:
        r += 1.0 / p
        p *= f
    return int(math.ceil(r))


class StreamingUpsampler:
    """Incremental frame-rate mel -> sample-rate conditioning.

    `feed` (B, F, n_mels) frames and get back the conditioning samples that
    became final (they have cond_halo_frames of lookahead); `finish` flushes
    the tail with true end-of-sequence semantics. The concatenated output
    equals one upsample_cond over all frames, at a fixed latency of
    cond_halo_frames * hop samples."""

    def __init__(self, params: dict, arch: ArchConfig, dtype: torch.dtype = torch.float32):
        self.params = params
        self.arch = arch
        self.dtype = dtype
        self.pad = cond_halo_frames(arch)
        self._buf = None   # (B, n, n_mels): left halo + not-yet-final frames
        self._left = 0     # halo frames at the buffer head (already emitted)
        self._done = False

    def _empty(self):
        b = 1 if self._buf is None else self._buf.shape[0]
        dev = self.params["proj_w"].device
        return torch.zeros((b, 0, self.arch.cond_channels), dtype=self.dtype, device=dev)

    def _emit(self, n_frames: int) -> torch.Tensor:
        h = upsample_cond(self.params, self.arch, self._buf, self.dtype)
        hop = self.arch.hop_size
        out = h[:, self._left * hop: (self._left + n_frames) * hop]
        keep_from = max(self._left + n_frames - self.pad, 0)
        self._buf = self._buf[:, keep_from:]
        self._left = self._left + n_frames - keep_from
        return out

    def feed(self, frames) -> torch.Tensor:
        """Add (B, F, n_mels) frames; return the newly final conditioning
        (B, S, Cc), possibly S == 0 while the lookahead builds."""
        if self._done:
            raise ValueError("StreamingUpsampler already finished")
        frames = torch.as_tensor(frames, dtype=torch.float32,
                                 device=self.params["proj_w"].device)
        self._buf = frames if self._buf is None else torch.cat([self._buf, frames], 1)
        emit = self._buf.shape[1] - self._left - self.pad
        if emit <= 0:
            return self._empty()
        return self._emit(emit)

    def finish(self) -> torch.Tensor:
        """Flush: the remaining frames are final (true sequence end)."""
        if self._done:
            raise ValueError("StreamingUpsampler already finished")
        self._done = True
        if self._buf is None:
            return self._empty()
        emit = self._buf.shape[1] - self._left
        if emit <= 0:
            return self._empty()
        return self._emit(emit)
