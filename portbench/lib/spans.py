"""The benchmark's own spans around its calls into the program's layers.

`Spans.span(name)` records (start, end) on the host clock for every call;
while a traced phase runs, it also enters a `record_function` named
"pb::<name>", which the trace reader (`lib/trace.py`) finds again. Spans
live in memory and are read once the run has ended.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Tuple


class Spans:
    def __init__(self):
        self._lock = threading.Lock()
        self.records: Dict[str, List[Tuple[float, float]]] = {}
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.tracing:
            from torch.profiler import record_function

            rf = record_function("pb::" + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            with self._lock:
                self.records.setdefault(name, []).append((t0, t1))

    def wrap(self, fn, name: str):
        """fn with every call inside span `name`; attributes read and set on
        the wrapper (a kernel wrapper's launch counters) are fn's."""
        return _Wrapped(fn, self, name)

    def snapshot(self) -> Dict[str, List[Tuple[float, float]]]:
        with self._lock:
            return {k: list(v) for k, v in self.records.items()}

    def within(self, name: str, t0: float, t1: float) -> List[Tuple[float, float]]:
        """Spans `name` that started in [t0, t1)."""
        return [(a, b) for a, b in self.records.get(name, []) if t0 <= a < t1]


class _Wrapped:
    def __init__(self, fn, spans: Spans, name: str):
        object.__setattr__(self, "__wrapped__", fn)
        object.__setattr__(self, "_spans", spans)
        object.__setattr__(self, "_name", name)

    def __call__(self, *a, **kw):
        with self._spans.span(self._name):
            return self.__wrapped__(*a, **kw)

    def __getattr__(self, key):
        return getattr(self.__wrapped__, key)

    def __setattr__(self, key, value):
        setattr(self.__wrapped__, key, value)
