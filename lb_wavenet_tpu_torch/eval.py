"""Evaluation: teacher-forced metrics over a held-out corpus (port of
`lb_wavenet_tpu/eval.py`).

  * nll             masked mean cross-entropy, nats per predicted sample (the
                    training loss's semantics),
  * bits_per_sample nll / ln 2,
  * accuracy        top-1 next-sample accuracy under teacher forcing.

Aggregation is exact through masked sums: the last batch is padded with
zero-mask rows, so the result does not depend on the eval batch size.
Windows are visited in corpus-index order. Evaluation runs under
`torch.inference_mode()`, so the training kernels' autograd Functions keep
no saved tensors (the stack's stored layer inputs are 0.8 GB at WaveNet-30,
B = 8). Entry points run on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import math
from typing import Any, Iterator, Optional

import numpy as np
import torch

from .config import ArchConfig, TrainConfig
from .data import Batch, Corpus, load_corpus, mel_frames
from .generate import resolve_device
from .models.wavenet import forward, params_to


def eval_step(params, batch: dict, arch: ArchConfig, window_size: int,
              fused: bool = False, tapcat: bool = False):
    """Masked sums of one batch: (nll_sum, correct_sum, mask_sum), 0-dim
    fp32 tensors. `fused` runs the forward through the training-stack
    kernel (train.forward_fused); logits[:, -W + j] predicts targets[:, j].
    Mel frames are upsampled as in training (train.batch_cond)."""
    from .train import batch_cond, forward_fused

    with torch.inference_mode():
        cond = batch_cond(params, arch, batch)
        if fused:
            logits = forward_fused(params, arch, batch["inputs"], cond=cond,
                                   speaker_ids=batch.get("speaker"), tapcat=tapcat)
        else:
            logits = forward(params, arch, batch["inputs"], cond=cond,
                             speaker_ids=batch.get("speaker"))
        w_logits = logits[:, -window_size:, :]
        targets = batch["targets"].long()
        mask = batch["mask"].to(torch.float32)
        nll = -torch.log_softmax(w_logits, dim=-1).gather(-1, targets[..., None])[..., 0]
        correct = (torch.argmax(w_logits, dim=-1) == targets).to(torch.float32)
        return (nll * mask).sum(), (correct * mask).sum(), mask.sum()


def eval_batches(corpus: Corpus, batch_size: int, host_id: int = 0, host_count: int = 1,
                 max_batches: int = 0) -> Iterator[Batch]:
    """Deterministic eval batches: corpus windows in index order. The last
    batch is padded with window (0, 0) rows whose mask is zero; a host takes
    rows host_id::host_count of each batch (one host here). A mel arch's
    batches carry each window's log-mel frames, as training's do."""
    if batch_size % host_count:
        raise ValueError("eval batch size must divide evenly across hosts")
    with_mel = corpus.arch.use_local_cond
    n = len(corpus.index)
    n_batches = -(-n // batch_size)
    if max_batches:
        n_batches = min(n_batches, max_batches)
    for b in range(n_batches):
        rows = range(b * batch_size, (b + 1) * batch_size)
        pairs = [corpus.index[r] if r < n else (0, 0) for r in rows][host_id::host_count]
        pad = np.asarray([r < n for r in rows], np.float32)[host_id::host_count]
        inputs, targets, mask = corpus.examples_batch(pairs)
        mel = corpus.mel_for_windows(pairs, mel_frames(corpus)) if with_mel else None
        speaker = None
        if corpus.speakers is not None:
            speaker = np.asarray([corpus.speakers[p[0]] for p in pairs], np.int32)
        yield Batch(inputs, targets, mask * pad[:, None], mel, speaker)


def evaluate(params, arch: ArchConfig, corpus: Corpus, batch_size: int,
             max_batches: int = 0, fused: bool = False, tapcat: bool = False,
             device: Any = "cuda") -> dict:
    """Sweep the eval corpus; returns {"nll", "bits_per_sample", "accuracy",
    "n_samples", "n_windows"}, aggregated exactly over masked sums."""
    from .train import batch_to_device

    dev = resolve_device(device)
    params = params_to(params, dev)
    sums = torch.zeros(3, dtype=torch.float64, device=dev)
    n_windows = 0
    for batch in eval_batches(corpus, batch_size, max_batches=max_batches):
        s = eval_step(params, batch_to_device(batch, dev), arch, corpus.window_size,
                      fused=fused, tapcat=tapcat)
        sums += torch.stack(s).to(torch.float64)
        n_windows += batch_size
    nll_sum, correct_sum, mask_sum = (float(v) for v in sums.cpu())
    mask_sum = max(mask_sum, 1.0)
    nll = nll_sum / mask_sum
    return {
        "nll": nll,
        "bits_per_sample": nll / math.log(2.0),
        "accuracy": correct_sum / mask_sum,
        "n_samples": int(mask_sum),
        "n_windows": min(n_windows, len(corpus.index)),
    }


def evaluate_from_config(params, arch: ArchConfig, train: TrainConfig,
                         eval_corpus: Optional[Corpus] = None,
                         device: Any = "cuda") -> Optional[dict]:
    """Config-driven wrapper: the corpus from train.eval_dir if none is
    given; None when no eval corpus is configured."""
    if eval_corpus is None:
        if not train.eval_dir:
            return None
        eval_corpus = load_corpus(train.eval_dir, arch, train.window_size)
    return evaluate(params, arch, eval_corpus, train.eval_batch_size or train.batch_size,
                    max_batches=train.eval_batches, device=device)
