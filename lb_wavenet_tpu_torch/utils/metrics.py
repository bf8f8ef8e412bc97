"""Structured JSONL metrics (port of `lb_wavenet_tpu/utils/metrics.py`):
one JSON record per line on stdout and, given a path, appended to a file.
Given a `tensorboard_dir`, a TensorBoard event stream
(`torch.utils.tensorboard.SummaryWriter`) mirrors every numeric field as a
scalar at the record's step; where the `tensorboard` package is missing,
one stderr line says so and the JSONL stream goes on alone."""
from __future__ import annotations

import json
import sys
import time
from typing import Optional, TextIO


class MetricsLogger:
    def __init__(self, path: str = "", enabled: bool = True, tensorboard_dir: str = ""):
        self.enabled = enabled
        self._file: Optional[TextIO] = open(path, "a") if enabled and path else None
        self._tb = None
        if enabled and tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=tensorboard_dir)
            except Exception as e:   # the optional dependency is missing
                print(f"metrics: tensorboard writer disabled ({e})", file=sys.stderr)

    def log(self, **record) -> None:
        if not self.enabled:
            return
        record.setdefault("time", time.time())
        line = json.dumps(record)
        print(line, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._tb is not None:
            step = int(record.get("step", 0))
            for k, v in record.items():
                if k not in ("step", "time") and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, global_step=step)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
