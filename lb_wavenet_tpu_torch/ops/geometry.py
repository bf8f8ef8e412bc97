"""Window / receptive-field / mask geometry for teacher-forced training
(the port's own copy of `lb_wavenet_tpu/ops/geometry.py`, numpy only and
bit-exact with it).

Teacher-forcing convention used throughout:
  - A training example is a window of encoded classes of length
    R - 1 + W + 1 (left context, W trainable positions, the final target).
  - inputs  = window[:-1]   (length R - 1 + W)
  - targets = the last W samples: logits at position t predict sample t + 1;
    only the last W logits are trained. A target is masked 0 where it is
    padding or where its receptive field would reach before the file start.
"""
from __future__ import annotations

import numpy as np


def receptive_field(dilations, input_kernel: int = 2) -> int:
    """R = 1 + (input_kernel - 1) + sum(dilations) for width-2 dilated taps."""
    return 1 + (input_kernel - 1) + int(sum(dilations))


def num_windows(file_len: int, window_size: int) -> int:
    """W-sized training windows of a file: every sample but the first is a
    target in exactly one window (the last window is right-padded and
    masked); files shorter than 2 samples yield none."""
    if file_len < 2:
        return 0
    return -(-(file_len - 1) // window_size)


def window_bounds(file_len: int, window_size: int, index: int):
    """Target range [t0, t1) within the file covered by window `index`."""
    t0 = 1 + index * window_size
    return t0, min(t0 + window_size, file_len)


def extract_window(
    encoded: np.ndarray,
    window_size: int,
    r_field: int,
    index: int,
    pad_value: int = 0,
):
    """One training window with left context and boundary mask:
    (inputs int32 [R - 1 + W], targets int32 [W], mask float32 [W]).

    mask is 1 where the target is real AND its whole receptive field
    [t - R, t) lies inside the file."""
    file_len = len(encoded)
    t0, t1 = window_bounds(file_len, window_size, index)
    w = window_size
    idx = np.arange(t0 - r_field, t0 + w - 1)
    valid_in = (idx >= 0) & (idx < file_len)
    inputs = np.where(valid_in, encoded[np.clip(idx, 0, file_len - 1)], pad_value)

    tgt_idx = np.arange(t0, t0 + w)
    valid_t = tgt_idx < t1
    targets = np.where(valid_t, encoded[np.clip(tgt_idx, 0, file_len - 1)], pad_value)

    full_context = (tgt_idx - r_field) >= 0
    mask = (valid_t & full_context).astype(np.float32)
    return inputs.astype(np.int32), targets.astype(np.int32), mask
