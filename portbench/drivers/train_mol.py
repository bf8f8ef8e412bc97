"""Training Tacotron 2's WaveNet vocoder (the `tacotron2_mol` configuration)
with the input pipeline running: the recipe as the configuration writes it.

As `train.py` drives the softmax model: set-up makes `corpus_files`
synthetic waves of `file_s` seconds at the configuration's 24 kHz from the
seed and hands them to the program's `Corpus` (16-bit linear samples for a
mol arch), and builds one training state from the seed's weights
(`lib/mol_signals.py`) with the program's Adam; the window's own call and
feed then run: `data.make_batches` (log-mel at hop 300 in the prefetch
thread) -> `data.prefetch` -> `train.batch_to_device` -> `train.train_step`.
The first three steps run in set-up and are kept for the check; the window
goes on with the same state until `seconds` have passed and ends in a
synchronise. The same spans as `train.py`: "loader_wait", "train_step",
"forward_backward", "optimizer", "stack_fwd" and "stack_bwd".

After the window (and the traced phase), the program takes one more
gradient through `train.value_and_grads` on the first checked batch at the
seed's weights with the head's log-scale biases raised by BROAD_SHIFT (a
broad mixture, where bf16 rounding does not decide the gradient), then generates
`check_gen_samples` samples on `check_gen_lanes` lanes with its xla
engine from the seed's weights, conditioned on log-mel frames of the
corpus, keeping each step's head outputs for the check; with --trace 1 a
few more steps under a CPU profiler count the program's spans
(`mol.sample` among them: info `program_spans`).
"""
from __future__ import annotations

import collections
import time

import numpy as np

from ..lib import mol_signals
from ..lib.serving import clone
from ..lib.trace import traced_phase, warm_profiler
from .train import CHECKED_STEPS, _launches_info, _leaf_dict, waves

# The numbers a cell's limits file may hold, in the order they print.
COMPARED = ("loss_gap", "loss1_gap", "grad_gap", "change_gap", "broad_grad_gap", "gen_gap")
# The head's log-scale biases raised by this much for `broad_grad_gap`'s
# gradient (reference/mol.py `broaden`).
BROAD_SHIFT = 5.0
SPAN_STEPS = 8   # generated steps whose program spans a --trace 1 run counts


def _prec(run) -> str:
    return "bfloat16" if run.arch["compute_dtype"] == "bfloat16" else "float32"


def gen_frames(run, w: list):
    """(lanes, F, n_mels) log-mel frames of the first samples of the
    corpus's first files: the conditioning of the check's generation."""
    import torch

    from ..reference import loader

    tr, arch = run.traffic, run.arch
    hop = int(np.prod(arch["upsample_factors"]))
    n = tr["check_gen_samples"]
    segs = torch.from_numpy(np.stack([x[:n] for x in w[: tr["check_gen_lanes"]]]))
    return loader.log_mel(segs, arch["n_mels"], hop, arch["sample_rate"])[:, : -(-n // hop)]


def _program_spans() -> dict:
    """How many of each of the program's spans it has recorded (while a
    profiler recorded)."""
    from lb_wavenet_tpu_torch.utils.profiling import spans

    return dict(collections.Counter(r.name for r in spans()))


def generate_for_check(run, params, arch, frames, n=None) -> dict:
    """The program's xla engine over the check's lanes (`n` samples, by
    default check_gen_samples): samples and each step's head outputs."""
    import torch

    from lb_wavenet_tpu_torch import generate as G
    from lb_wavenet_tpu_torch.models.conditioning import upsample_cond
    from lb_wavenet_tpu_torch.ops.numerics import compute_dtype

    tr = run.traffic
    n, lanes = n or tr["check_gen_samples"], tr["check_gen_lanes"]
    cond = None
    f = None
    if frames is not None:
        f = frames.to(run.device)
        cond = upsample_cond(params["upsampler"], arch, f, compute_dtype(arch))
    samples, y = G.generate_classes(params, arch, run.seed % (1 << 31), lanes, n, cond=cond,
                                    temperature=1.0, return_logits=True, engine="xla",
                                    device=run.device)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return {"samples": samples, "y": y, "frames": f}


def drive(run) -> None:
    import torch

    from lb_wavenet_tpu_torch import train as PT
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.data import Corpus, make_batches, prefetch
    from lb_wavenet_tpu_torch.ops.cuda import post_mol as PM
    from lb_wavenet_tpu_torch.ops.cuda import train_stack as TS

    from ..reference import mol

    cfg = Config.from_dict({k: run.config[k] for k in ("arch", "train", "gen")
                            if k in run.config})
    cfg = cfg.override({"train.seed": int(run.seed % (1 << 31))})
    arch, train = cfg.arch, cfg.train
    spans = run.spans
    params = mol_signals.make_params(run.arch, run.seed, run.device)
    run.check_state["params"] = clone(params)
    run.mark("weights")
    w = waves(run)
    run.check_state["waves"] = w
    run.check_state["loader_seed"] = train.seed
    frames = gen_frames(run, w) if arch.use_local_cond else None
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
            run.check_state.setdefault("first_batch", host)
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
                counted[:] = [TS.train_stack_fwd.launches, TS.train_stack_bwd.launches,
                              PM.post_mol_fwd.launches, PM.post_mol_bwd.launches]
                stop = time.perf_counter() + run.traffic["trace_seconds"]
                while time.perf_counter() < stop:
                    step()

            traced_phase(run, phase)
            _launches_info(run, TS.train_stack_fwd.launches - counted[0],
                           TS.train_stack_bwd.launches - counted[1])
            calls = len(run.trace_data.span_device_us("train_step")) if run.trace_data else 0
            if calls:
                run.info["mol_launches_per_step"] = [
                    (PM.post_mol_fwd.launches - counted[2]) / calls,
                    (PM.post_mol_bwd.launches - counted[3]) / calls]
        run.read_peak()
    finally:
        batches.close()
        PT.value_and_grads, PT._apply_updates = real["vg"], real["upd"]
        TS.train_stack_fwd, TS.train_stack_bwd = real["fwd"], real["bwd"]
    run.attempted = CHECKED_STEPS + run.steps
    run.failed = 0
    del state, corpus
    import gc

    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    # The gradient at a broad mixture on the first checked batch, through
    # the same value_and_grads as the step (the stack and head kernel pairs).
    broad = mol.broaden(clone(run.check_state["params"]), run.arch, BROAD_SHIFT)
    _, g = PT.value_and_grads(broad, PT.batch_to_device(run.check_state.pop("first_batch"),
                                                        run.device), arch, train)
    run.check_state["program"]["broad_grad"] = _leaf_dict(g)
    gen_params = clone(run.check_state["params"])
    t_gen = time.perf_counter()
    run.check_state["gen"] = generate_for_check(run, gen_params, arch, frames)
    run.info["check_generation_s"] = time.perf_counter() - t_gen
    if run.trace:   # a few more steps with the program's spans recording
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            generate_for_check(run, gen_params, arch, frames, n=SPAN_STEPS)
        run.info["program_spans"] = _program_spans()
    run.info["mol_head_launches"] = [PM.post_mol_fwd.launches, PM.post_mol_bwd.launches]


def check(run) -> list:
    """[(name, value, limit)] of the numbers the cell's limits file holds:
    the checked steps' losses (the worst step, or the first alone), the
    first gradient and the change over the checked steps against the
    reference (`reference/mol.py`, `reference/checks.py`), the broad
    mixture's gradient against the reference's (`mol.diff_gap`), and the
    generated steps' head outputs against the reference's teacher-forced
    forward over the generated samples."""
    from ..reference import checks, mol

    t0 = time.perf_counter()
    st = run.check_state
    prec = _prec(run)
    ref = st["ref"] = mol.reference_steps(st["params"], run.arch, run.train, st["waves"],
                                          st["loader_seed"], CHECKED_STEPS, prec, run.device)
    p0 = dict(checks.leaves(st["params"]))
    nums = checks.train_numbers(st["program"], ref, p0)
    _, g_broad, _ = mol.reference_steps(mol.broaden(st["params"], run.arch, BROAD_SHIFT), run.arch,
                                        run.train, st["waves"], st["loader_seed"], 1, prec,
                                        run.device)
    st["ref_broad"] = g_broad
    nums["broad_grad_gap"] = mol.diff_gap(st["program"]["broad_grad"], g_broad)
    gen = st["gen"]
    nums["gen_gap"] = mol.generation_gap(st["params"], run.arch, gen["samples"], gen["y"], prec,
                                         gen["frames"])
    run.info["leaves"] = {"compared": nums["leaves_compared"],
                          "left_out": nums["leaves_left_out"]}
    run.info["loss_gaps_by_step"] = nums["loss_gaps"]
    run.info["grad_gap_by_leaf"] = _worst_leaves(st["program"]["grad"], ref[1])
    run.info["generated"] = list(gen["samples"].shape)
    run.info["check_s"] = time.perf_counter() - t0
    return [(k, nums[k], run.limits[k]) for k in COMPARED if k in run.limits]


def _worst_leaves(got: dict, want: dict, k: int = 4) -> list:
    """[[leaf, gap]] of the k leaves with the widest first-gradient gaps
    (checks.leaf_gap over each leaf alone, against the median leaf)."""
    import numpy as np
    import torch

    norms = {p: float(torch.linalg.vector_norm(v.float())) for p, v in want.items()}
    med = float(np.median(list(norms.values())))
    gaps = []
    for p, v in want.items():
        g = float(torch.linalg.vector_norm(got[p].float().to(v.device)))
        gaps.append(["/".join(map(str, p)), abs(g - norms[p]) / max(norms[p], med, 1e-30)])
    return sorted(gaps, key=lambda x: -x[1])[:k]


def control_readings(run) -> dict:
    """The controls' readings of the compared numbers (`control_mol.py`):
    the reference in fp8 e4m3 and half the batch left out, against the
    reference at the configuration's precision; for the generation, the
    fp8 reference's head outputs over the program's samples."""
    import torch

    from ..reference import checks, mol, model

    st = run.check_state
    arch, train = run.arch, run.train
    p0 = dict(checks.leaves(st["params"]))
    out = {}
    for name, prec, rows in (("control", "fp8", None),
                             ("half_batch", _prec(run), train["batch_size"] // 2)):
        losses, g, p = mol.reference_steps(st["params"], arch, train, st["waves"],
                                           st["loader_seed"], CHECKED_STEPS, prec, run.device,
                                           rows)
        nums = checks.train_numbers({"losses": losses, "grad": g, "params": p}, st["ref"], p0)
        out[name] = {k: nums[k] for k in ("loss_gaps", "grad_gap", "change_gap")}
        _, g_broad, _ = mol.reference_steps(mol.broaden(st["params"], arch, BROAD_SHIFT), arch,
                                            train, st["waves"], st["loader_seed"], 1, prec,
                                            run.device, rows)
        out[name]["broad_grad_gap"] = mol.diff_gap(g_broad, st["ref_broad"])
    gen = st["gen"]
    x = torch.cat([torch.zeros_like(gen["samples"][:, :1]), gen["samples"][:, :-1]], 1)
    cond = None
    if gen["frames"] is not None:
        cond = model.upsample(st["params"]["upsampler"], arch, gen["frames"])[:, : x.shape[1]]
    with torch.no_grad():
        y8 = mol.head_outputs(st["params"], arch, x, "fp8", cond)
    out["control"]["gen_gap"] = mol.generation_gap(st["params"], arch, gen["samples"], y8,
                                                   _prec(run), gen["frames"])
    return out
