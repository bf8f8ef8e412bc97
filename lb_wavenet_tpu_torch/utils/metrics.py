"""Structured JSONL metrics (port of `lb_wavenet_tpu/utils/metrics.py`):
one JSON record per line on stdout and, given a path, appended to a file.
The TensorBoard stream is not ported (ROADMAP.md A queue item 8)."""
from __future__ import annotations

import json
import time
from typing import Optional, TextIO


class MetricsLogger:
    def __init__(self, path: str = "", enabled: bool = True):
        self.enabled = enabled
        self._file: Optional[TextIO] = open(path, "a") if enabled and path else None

    def log(self, **record) -> None:
        if not self.enabled:
            return
        record.setdefault("time", time.time())
        line = json.dumps(record)
        print(line, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
