"""Closed-loop serving: the pool kept full.

The traffic keeps `pool.batch + outstanding_beyond_pool` requests in the
server at every moment: a request is sent the moment another finishes.
Lengths are the stratified log-uniform quantiles of `length_s`, in an order
the seed draws; every `greedy_every`-th request is greedy (temperature 0),
the others sample at `pool.temperature` with their own seeds.
"""
from __future__ import annotations

import queue
import time

from ..lib import pool as P
from ..lib import serving, signals
from ..lib.trace import traced_phase, warm_profiler


def _requests(run, n: int):
    tr = run.traffic
    sr = run.arch["sample_rate"]
    order = signals.rng(run.seed, 11)
    lengths = signals.log_uniform_lengths(n, tr["length_s"][0], tr["length_s"][1], order)
    seeds = order.integers(0, 2 ** 31 - 1, n)
    out = []
    for i in range(n):
        temp = 0.0 if i % tr["greedy_every"] == 0 else tr["pool"]["temperature"]
        out.append(P.Request(int(round(lengths[i] * sr)), int(seeds[i]), temp))
    return out


def drive(run) -> None:
    tr = run.traffic
    params, arch_obj = serving.setup_params(run)
    run.mark("weights")
    rig = P.PoolRig(run, params, arch_obj)
    rig.start()
    run.mark("program")
    serving.warm_up(run, rig)
    if run.trace:
        warm_profiler(run.device)
    run.mark("warm_up")
    reqs = _requests(run, tr["requests"])
    run.mark("requests")
    target = tr["pool"]["batch"] + tr["outstanding_beyond_pool"]
    nxt = iter(reqs)
    sent: list = []

    def send():
        rec = next(nxt)
        rec.due = time.perf_counter()
        rig.submit(rec)
        sent.append(rec)

    before = rig.stats()
    rig.recording = True
    run.t0 = time.perf_counter()
    end = run.t0 + run.seconds
    for _ in range(target):
        send()

    def keep_full(until: float) -> None:
        while True:
            left = until - time.perf_counter()
            if left <= 0:
                return
            try:
                done = rig.completed.get(timeout=min(left, 0.05))
            except queue.Empty:
                continue
            send()
            rig.settle(done)

    keep_full(end)
    run.t1 = time.perf_counter()
    run.pool_stats = P.stats_delta(rig.stats(), before)
    if run.trace:
        traced_phase(run, lambda: keep_full(time.perf_counter() + tr["trace_seconds"]))
    run.deliveries = list(rig.deliveries)
    run.read_peak()
    rig.stop()
    run.requests = sent
    run.attempted = sum(1 for r in sent if r.sent is not None and r.sent < run.t1)
    run.failed = sum(1 for r in sent if r.done_t is not None and r.done_t <= run.t1
                     and r.pending.error is not None)
    serving.keep_for_check(run, rig, sent)
    rig.free()
    del params


def check(run) -> list:
    return serving.check(run)

