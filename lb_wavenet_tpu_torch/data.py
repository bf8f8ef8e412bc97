"""Audio IO (port of `lb_wavenet_tpu/data.py`; only `write_wav` so far — the
corpus, windows and batching wait for the training slice, ROADMAP.md A6)."""
from __future__ import annotations

import numpy as np


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write a float waveform in [-1, 1] as 16-bit PCM."""
    from scipy.io import wavfile

    wav = np.clip(np.asarray(wav, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, sample_rate, (wav * 32767.0).astype(np.int16))
