"""What the serving drivers share: weights, the warm-up, the sample kept
for the check, and the check itself (`reference/checks.py`)."""
from __future__ import annotations

from . import pool as P
from . import signals


def arch_object(config: dict):
    from lb_wavenet_tpu_torch.config import Config

    return Config.from_dict({k: config[k] for k in ("arch", "train", "gen") if k in config}).arch


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.detach().clone()


def setup_params(run):
    """The weights of this seed on the run's device: one tree for the
    program, and a copy the reference keeps."""
    params = signals.make_params(run.arch, run.seed, run.device)
    run.check_state["params"] = clone(params)
    return params, arch_object(run.config)


def warm_up(run, rig) -> None:
    """Two waves of pool.batch one-chunk requests through the timed path,
    the second on recycled lanes, each waited for: the kernels, the lane
    resets and the pinned buffers all run once before the window."""
    spec = run.traffic["pool"]
    for wave in range(2):
        recs = [P.Request(spec["chunk"], 7 + i, 0.0 if i % 2 else spec["temperature"])
                for i in range(spec["batch"])]
        for rec in recs:
            rig.submit(rec)
        for rec in recs:
            if not rec.pending.done.wait(timeout=300):
                raise RuntimeError("warm-up request did not finish")
            if rec.pending.error:
                raise RuntimeError(f"warm-up request failed: {rec.pending.error}")
        while rig.completed.qsize():
            rig.completed.get()


def keep_for_check(run, rig, requests) -> None:
    """Settle every finished request (`PoolRig.settle`), count the wrong
    answers, and keep the check's sample of finished greedy requests with
    their served classes (drawn from the seed, the longest among them)."""
    for r in requests:
        if r.done_t is not None:
            rig.settle(r)
    sample = P.check_sample(requests, run.traffic["check_requests"], signals.rng(run.seed, 29))
    run.check_state["sample"] = [(r.n_samples, r.classes) for r in sample]
    run.check_state["bad_answers"] = sum(1 for r in requests if r.settled and r.bad)


def check(run) -> list:
    """[(name, value, limit)]: the widest gap of a served greedy class below
    the reference's best over the sample, the sampled tokens' count, and the
    answers of the wrong length or out of range."""
    import torch

    from ..reference import checks, model

    model.set_precision()
    st = run.check_state
    params = st["params"]
    gaps = []
    n_tokens = 0
    for n, cls in st["sample"]:
        gaps.append(checks.served_gap(params, run.arch, cls))
        n_tokens += n
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    lim = run.limits
    out = [("served_gap", max(gaps) if gaps else float("inf"), lim["served_gap"]),
           ("unchecked_sample", float(0 if gaps else 1), 0.0),
           ("bad_answers", float(st["bad_answers"]), 0.0)]
    run.info["tokens_compared"] = n_tokens
    return out

