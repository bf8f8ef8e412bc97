"""Sequence parallelism for the dilated convolution: recompute with a halo
(port of `lb_wavenet_tpu/parallel/halo.py`).

The mesh's `data` axis shards TIME: rank i of the axis scores positions
[i T_l, (i + 1) T_l) of a (B, T) window, T = n T_l. It runs the forward over
its chunk extended to the left by the halo, the R - 1 samples its first
position's receptive field reaches back, and recomputes the halo's
activations itself; no per-layer exchange.

Where the port differs from the JAX package: JAX's ranks hold time shards of
the batch and pass the halo's classes and cond to the right neighbour with
`ppermute`. Here every rank holds the whole batch (JAX's sequence-parallel
loader is unsharded too), so rank i slices its own window [i T_l - (R - 1),
(i + 1) T_l) of the inputs zero-padded on the left: no collective at all.
Rank 0's halo lies before the sequence; its mask is 0 there (JAX's
wraparound tail is masked the same way), and the masked forward
(`models/wavenet.py` `input_mask`, the masked frontend and training-stack
kernels on the fused path) keeps the residual stream's masked rows exactly
0, as the unsharded forward's zero padding. The conditioning is upsampled
once from the whole batch's frames on every rank and sliced the same way,
so the upsampler's gradient flows through each rank's slice and the
gradient sum over the axis (the train step's all-reduce) adds the slices,
as the transpose of JAX's shard_map does.

`sequence_parallel_logits` and `sequence_parallel_loss_sums` return THIS
rank's part (its T_l positions' logits; its numerator and denominator),
differentiable; the sum over the axis of the sums is JAX's psum'd
(num, den). Speaker ids are time-independent and replicated.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import ArchConfig
from ..models.wavenet import compute_dtype, forward
from .mesh import Mesh


def check_chunking(arch: ArchConfig, t: int, n: int, axis_name: str = "data") -> None:
    """Each chunk must cover the halo it would send to its right neighbour
    (JAX's `_check_chunking`, the same two errors)."""
    if t % n:
        raise ValueError(f"sequence length {t} must divide across {n} '{axis_name}' shards")
    halo = arch.receptive_field - 1
    if t // n < halo:
        raise ValueError(
            f"per-shard chunk {t // n} < halo {halo} (= receptive_field - 1):"
            f" a chunk must cover the halo it sends to its right neighbor —"
            f" use longer sequences or fewer shards")


def upsample_for_sp(params, arch: ArchConfig, cond_frames: torch.Tensor, t: int):
    """The whole batch's cond (B, t, Cc) in the compute dtype, upsampled once
    (`upsample_cond_train`). Past the frames' coverage (time zero-padded to a
    multiple of the axis) the upsampled cond is padded with ZEROS, never
    with zero frames, which would carry the projection's bias into the real
    tail through the same conv window."""
    from ..models.conditioning import upsample_cond_train

    cond = upsample_cond_train(params["upsampler"], arch, cond_frames, compute_dtype(arch))
    cond = cond[:, :t]
    if cond.shape[1] < t:
        cond = torch.nn.functional.pad(cond, (0, 0, 0, t - cond.shape[1]))
    return cond


def halo_window(x: torch.Tensor, rank: int, t_l: int, halo: int) -> torch.Tensor:
    """Rows [rank t_l - halo, (rank + 1) t_l) of x (B, T, ...) along time,
    zeros before position 0."""
    pad = [0, 0] * (x.dim() - 2) + [halo, 0]
    return torch.nn.functional.pad(x, pad)[:, rank * t_l: rank * t_l + t_l + halo]


def halo_mask(b: int, t_l: int, halo: int, rank: int, device) -> torch.Tensor:
    """(B, halo + t_l) fp32: 1, but 0 over rank 0's halo (before the
    sequence)."""
    mask = torch.ones((b, halo + t_l), dtype=torch.float32, device=device)
    if rank == 0:
        mask[:, :halo] = 0.0
    return mask


def _local(params, arch: ArchConfig, x, mesh: Mesh, cond, speaker_ids, remat, fused_stack,
           tapcat, fused_frontend, return_skip):
    """This rank's halo-extended forward, cut to its t_l positions:
    (B, t_l, Q) logits, or the skip sum (B, t_l, S) with return_skip."""
    halo = arch.receptive_field - 1
    b, t = x.shape
    t_l, i = t // mesh.data, mesh.data_rank
    x_ext = halo_window(x, i, t_l, halo)
    cond_ext = None if cond is None else halo_window(cond, i, t_l, halo)
    mask = halo_mask(b, t_l, halo, i, x.device)
    if fused_stack:
        from ..train import forward_fused

        out = forward_fused(params, arch, x_ext, cond=cond_ext, speaker_ids=speaker_ids,
                            tapcat=tapcat, input_mask=mask, fused_frontend=fused_frontend,
                            return_skip=return_skip)
    else:
        out = forward(params, arch, x_ext, input_mask=mask, cond=cond_ext,
                      speaker_ids=speaker_ids, remat=remat, fused_frontend=fused_frontend,
                      return_skip=return_skip)
    return out[:, halo:]


def sequence_parallel_logits(params, arch: ArchConfig, x: torch.Tensor, mesh: Mesh,
                             cond_frames: Optional[torch.Tensor] = None,
                             speaker_ids: Optional[torch.Tensor] = None, remat: bool = False,
                             fused_stack: bool = False, tapcat: bool = False,
                             fused_frontend: bool = False) -> torch.Tensor:
    """This rank's (B, T_l, Q) logits of the time-sharded teacher-forced
    forward of x (B, T), T divisible by the data axis: positions [i T_l,
    (i + 1) T_l) of `forward(params, arch, x)` up to float associativity
    (the same sums per position)."""
    check_chunking(arch, x.shape[1], mesh.data)
    cond = (upsample_for_sp(params, arch, cond_frames, x.shape[1])
            if cond_frames is not None else None)
    return _local(params, arch, x, mesh, cond, speaker_ids, remat, fused_stack, tapcat,
                  fused_frontend, False)


def sequence_parallel_loss_sums(params, arch: ArchConfig, x: torch.Tensor,
                                targets: torch.Tensor, loss_mask: torch.Tensor, mesh: Mesh,
                                cond_frames: Optional[torch.Tensor] = None,
                                speaker_ids: Optional[torch.Tensor] = None,
                                remat: bool = False, fused_stack: bool = False,
                                tapcat: bool = False, fused_frontend: bool = False,
                                fused_post: bool = False):
    """This rank's (sum of masked CE, sum of mask) over its T_l positions of
    a time-sharded window: x, targets, loss_mask (B, T) score EVERY position
    and the mask excludes those without a full receptive field
    (`seq_batch_to_device`). Their sum over the data axis is JAX's (num,
    den). `fused_post` runs the post-loss kernel pair with window_size =
    T_l: no skipped head, the mask carries all the exclusion."""
    check_chunking(arch, x.shape[1], mesh.data)
    cond = (upsample_for_sp(params, arch, cond_frames, x.shape[1])
            if cond_frames is not None else None)
    t_l, i = x.shape[1] // mesh.data, mesh.data_rank
    tgt = targets[:, i * t_l: (i + 1) * t_l]
    m = loss_mask[:, i * t_l: (i + 1) * t_l].to(torch.float32)
    out = _local(params, arch, x, mesh, cond, speaker_ids, remat, fused_stack, tapcat,
                 fused_frontend, fused_post)
    if fused_post:
        from ..ops.cuda.post_loss import fused_post_loss

        num = fused_post_loss(params["post"], out.contiguous(), tgt, m, t_l,
                              compute_dtype=arch.compute_dtype)
    else:
        ce = -torch.log_softmax(out, dim=-1)
        num = (ce.gather(-1, tgt.long()[..., None])[..., 0] * m).sum()
    return num, m.sum()
