"""Training with the input pipeline running: the recipe as the
configuration writes it.

Set-up makes `corpus_files` synthetic waves of `file_s` seconds from the
seed (chords with a little noise), hands them to the program's `Corpus`,
and builds one training state from the seed's weights with the program's
Adam. The window's own call and feed then run: `data.make_batches` ->
`data.prefetch` -> `train.batch_to_device` -> `train.train_step`. The
first three steps run in set-up (they also warm every shape up) and are
kept for the check; the window then goes on with the same state and the
same feed until `seconds` have passed, and ends in a synchronise.
Spans: "loader_wait" around each next() of the prefetch iterator,
"train_step" around each step, and inside it "forward_backward" and
"optimizer"; "stack_fwd" and "stack_bwd" around each call of the
training-stack kernel pair.
"""
from __future__ import annotations

import time

import numpy as np

from ..lib import signals
from ..lib.serving import clone
from ..lib.trace import traced_phase, warm_profiler

CHECKED_STEPS = 3
# The numbers a cell's limits file may hold, in the order they print.
COMPARED = ("loss_gap", "loss1_gap", "grad_gap", "change_gap")


def waves(run) -> list:
    """The corpus: corpus_files float waves of file_s seconds (chords of a
    seed-drawn fundamental plus 0.05 of normal noise), made on the run's
    device in one call and moved to the host."""
    import torch

    tr, sr = run.traffic, run.arch["sample_rate"]
    n, length = tr["corpus_files"], int(tr["file_s"] * sr)
    order = signals.rng(run.seed, 31)
    f0 = np.exp(order.uniform(np.log(80.0), np.log(400.0), n))
    noise = 0.05 * torch.randn((n, length), generator=signals.torch_generator(run.seed, 2,
                                                                              run.device),
                               device=run.device)
    wav = signals.chords(f0, length, sr, run.device, noise).cpu().numpy()
    return [np.ascontiguousarray(w) for w in wav]


def _leaf_dict(tree) -> dict:
    from ..reference.checks import leaves

    return {p: t.detach() for p, t in leaves(tree)}


def drive(run) -> None:
    import torch

    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.data import Corpus, make_batches, prefetch
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    cfg = Config.from_dict({k: run.config[k] for k in ("arch", "train", "gen")
                            if k in run.config})
    cfg = cfg.override({"train.seed": int(run.seed % (1 << 31))})
    arch, train = cfg.arch, cfg.train
    spans = run.spans
    params = signals.make_params(run.arch, run.seed, run.device)
    run.check_state["params"] = clone(params)
    run.mark("weights")
    w = waves(run)
    run.check_state["waves"] = w
    run.check_state["loader_seed"] = train.seed
    run.mark("corpus")
    corpus = Corpus(w, arch, train.window_size)
    state = PT.TrainState(params, PT.make_optimizer(train).init(params), 0, None)
    run.mark("program")

    real = {"vg": PT.value_and_grads, "upd": PT._apply_updates,
            "fwd": TS.train_stack_fwd, "bwd": TS.train_stack_bwd}
    PT.value_and_grads = spans.wrap(real["vg"], "forward_backward")
    PT._apply_updates = spans.wrap(real["upd"], "optimizer")
    TS.train_stack_fwd = spans.wrap(real["fwd"], "stack_fwd")
    TS.train_stack_bwd = spans.wrap(real["bwd"], "stack_bwd")
    batches = prefetch(make_batches(corpus, train, with_mel=arch.use_local_cond))
    try:
        def step():
            nonlocal state
            with spans.span("loader_wait"):
                host = next(batches)
            with spans.span("train_step"):
                state, loss = PT.train_step(state, PT.batch_to_device(host, run.device),
                                            arch, train)
            return loss

        losses, kept = [], []
        for _ in range(CHECKED_STEPS):
            losses.append(step())
            kept.append(state)
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        b1 = train.adam_b1
        run.check_state["program"] = {
            "losses": [float(x) for x in losses],
            "grad": {k: v / (1 - b1) for k, v in _leaf_dict(kept[0].opt_state["mu"]).items()},
            "params": {k: v.clone() for k, v in _leaf_dict(kept[-1].params).items()},
        }
        if run.check_state.get("keep_step1"):
            # control.py's look: the state after the first step.
            run.check_state["program"]["step1"] = {
                "steps": 1, "params": _leaf_dict(clone(kept[0].params)),
                "mu": _leaf_dict(clone(kept[0].opt_state["mu"])),
                "nu": _leaf_dict(clone(kept[0].opt_state["nu"]))}
        del kept
        run.mark("warm_up")
        if run.trace:
            warm_profiler(run.device)
        sync = torch.cuda.synchronize if run.device.type == "cuda" else (lambda: None)
        sync()
        run.t0 = time.perf_counter()
        end = run.t0 + run.seconds
        n = 0
        while time.perf_counter() < end:
            step()
            n += 1
        sync()
        run.t1 = time.perf_counter()
        run.steps = n
        if run.trace:
            counted = []

            def phase():
                counted[:] = [TS.train_stack_fwd.launches, TS.train_stack_bwd.launches]
                stop = time.perf_counter() + run.traffic["trace_seconds"]
                while time.perf_counter() < stop:
                    step()

            traced_phase(run, phase)
            _launches_info(run, TS.train_stack_fwd.launches - counted[0],
                           TS.train_stack_bwd.launches - counted[1])
        run.read_peak()
    finally:
        batches.close()
        PT.value_and_grads, PT._apply_updates = real["vg"], real["upd"]
        TS.train_stack_fwd, TS.train_stack_bwd = real["fwd"], real["bwd"]
    run.attempted = CHECKED_STEPS + run.steps
    run.failed = 0
    del state, params, corpus
    import gc

    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _launches_info(run, fwd: int, bwd: int) -> None:
    """The stack's launches a call in the traced phase, by the trace's
    kernel names and by the program's launch counters: equal when the
    roofline readers attribute every kernel of a call and nothing else."""
    from ..lib.readers import stack_kernels

    td = run.trace_data
    if td is None:
        return
    calls = len(td.span_device_us("stack_fwd"))
    if calls:
        run.info["stack_launches_per_call"] = {
            "fwd": [len(td.kernel_us(stack_kernels(False))) / calls, fwd / calls],
            "bwd": [len(td.kernel_us(stack_kernels(True))) / calls, bwd / calls]}


def check(run) -> list:
    """[(name, value, limit)] of the numbers the cell's limits file holds:
    the checked steps' losses (the worst step, or the first alone), the
    first gradient and the change over the checked steps, against the
    reference (`reference/checks.py`)."""
    from ..reference import checks

    st = run.check_state
    prec = "bfloat16" if run.arch["compute_dtype"] == "bfloat16" else "float32"
    ref = st["ref"] = checks.reference_steps(st["params"], run.arch, run.train, st["waves"],
                                             st["loader_seed"], CHECKED_STEPS, prec, run.device)
    p0 = dict(checks.leaves(st["params"]))
    nums = checks.train_numbers(st["program"], ref, p0)
    run.info["leaves"] = {"compared": nums["leaves_compared"],
                          "left_out": nums["leaves_left_out"]}
    run.info["loss_gaps_by_step"] = nums["loss_gaps"]
    return [(k, nums[k], run.limits[k]) for k in COMPARED if k in run.limits]
