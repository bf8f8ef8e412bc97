"""The serving cells' side of the program: a SessionPool behind a
PoolServer, as `cli serve --listen` runs it, with the benchmark's records
around the calls into it.

`PoolRig` builds the pool from the traffic's "pool" entry, wraps the
pool's step (span "pool_step", and the time every request's part came
back, read right after the step returns on the stepping thread), and
submits requests (span "submit") under a lock that the step's records
also take, so a request is registered before any of its parts can come
back.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class Request:
    n_samples: int
    seed: int
    temperature: float
    due: float = 0.0                    # host time it was due to be sent
    sent: Optional[float] = None        # host time the submit began
    done_t: Optional[float] = None      # host time its last part came back
    delivered: int = 0
    pending: object = None              # the server's request object
    settled: bool = False               # its parts read and let go (PoolRig.settle)
    classes: object = None              # a settled greedy request's served classes
    bad: bool = False                   # settled with the wrong length or a class out of range

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


class PoolRig:
    def __init__(self, run, params, arch_obj):
        from lb_wavenet_tpu_torch.server import PoolServer
        from lb_wavenet_tpu_torch.serving import SessionPool

        spec = run.traffic["pool"]
        self.run = run
        self.pool = SessionPool(params, arch_obj, spec["batch"], run.seed % (1 << 31),
                                engine=spec["engine"], chunk_size=spec["chunk"],
                                temperature=spec["temperature"], pipeline=spec["pipeline"],
                                device=str(run.device))
        self.server = PoolServer(self.pool)
        self.by_rid: dict = {}
        self.completed: "queue.SimpleQueue" = queue.SimpleQueue()
        self.deliveries: list = []
        self.recording = False
        self._lock = threading.Lock()
        real_step = self.pool.step
        spans = run.spans

        def step():
            with spans.span("pool_step"):
                out = real_step()
            t = time.perf_counter()
            with self._lock:
                for rid, (cls, done) in out.items():
                    rec = self.by_rid.get(rid)
                    if rec is None:
                        continue
                    rec.delivered += len(cls)
                    if self.recording:
                        self.deliveries.append((t, len(cls)))
                    if done:
                        rec.done_t = t
                        self.completed.put(rec)
            return out

        self.pool.step = step

    def start(self) -> None:
        self.server.start()

    def submit(self, rec: Request) -> None:
        with self.run.spans.span("submit"), self._lock:
            rec.sent = rec.sent or time.perf_counter()
            rec.pending = self.server.submit(rec.n_samples, seed=rec.seed,
                                             temperature=rec.temperature)
            self.by_rid[rec.pending.rid] = rec

    def settle(self, rec: Request) -> None:
        """Once a request has finished: note whether its answer has the
        wrong length or a class out of range, keep a greedy request's
        classes for the check, and let its parts go, as the HTTP handler of
        a finished request does (parts kept by the thousand would make the
        interpreter's garbage collector, not the program, set the pace)."""
        if rec.settled or not rec.pending.done.wait(timeout=60):
            return
        q = self.run.arch["quant_channels"]
        if rec.pending.error is None:
            import numpy as np

            cls = (np.concatenate(rec.pending.parts) if rec.pending.parts
                   else np.zeros(0, np.int32))
            rec.bad = len(cls) != rec.n_samples or bool(
                len(cls) and (cls.min() < 0 or cls.max() >= q))
            rec.classes = cls if rec.greedy else None
        rec.pending.parts.clear()
        rec.settled = True

    def stats(self) -> dict:
        return dict(self.pool.stats)

    def stop(self) -> None:
        self.server.stop()

    def free(self) -> None:
        """Drop the pool and its device state."""
        import gc

        import torch

        self.server = None
        self.pool = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def stats_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def check_sample(requests, k: int, order) -> list:
    """Up to k finished greedy requests: the longest, and the rest drawn by
    `order` (a numpy Generator)."""
    done = [r for r in requests if r.greedy and r.classes is not None]
    if not done:
        return []
    longest = max(done, key=lambda r: r.n_samples)
    rest = [r for r in done if r is not longest]
    pick = [rest[i] for i in order.permutation(len(rest))[: k - 1]]
    return [longest] + pick
