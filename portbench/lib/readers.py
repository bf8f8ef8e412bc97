"""Arithmetic the metric readers share: means of spans, shares of the
peak, and the cost bounds at a run's shapes. Every reader returns None when
its run has nothing for it to read."""
from __future__ import annotations

from . import costs
from .trace import kernel_matcher, source_kernels


def span_ms(run, name: str):
    """Mean host ms of the spans `name` that started in the window."""
    if run.t0 is None:
        return None
    spans = run.spans.within(name, run.t0, run.t1)
    return 1e3 * sum(b - a for a, b in spans) / len(spans) if spans else None


def pool_ms(run, keys) -> float:
    """Sum of pool.stats phases `keys` over the window, ms per pool step."""
    st = run.pool_stats
    if not st.get("steps"):
        return None
    return 1e3 * sum(st[k] for k in keys) / st["steps"]


def delivered(run) -> int:
    """Samples delivered to requests inside the window."""
    return sum(n for t, n in run.deliveries if run.t0 <= t <= run.t1)


def serve_mfu(run):
    """% of the bf16 peak: the window's delivered samples times the model
    operations of one sample, over the window."""
    if run.t0 is None or not run.deliveries:
        return None
    flops = delivered(run) * costs.mega_flops_per_sample(run.arch, costs.cond_width(run.arch))
    return 100.0 * flops / run.window_s / costs.H100_BF16_FLOPS


def mega_roofline(run):
    """% of mega's roofline: its bound per launch at the pool's device
    batch and chunk (3-row lane block) over the mean device time of a
    launch, the launches known by ar_mega.cu's __global__ names."""
    td = run.trace_data
    if td is None:
        return None
    us = td.kernel_us(kernel_matcher(source_kernels("ar_mega.cu")))
    if not us:
        return None
    spec = run.traffic["pool"]
    b = -(-spec["batch"] // 8) * 8   # the pool pads to mega's 8-lane blocks
    bound, _ = costs.bound_ms(*costs.mega_cost(run.arch, b, spec["chunk"], 3,
                                               costs.wbytes(run.arch),
                                               costs.cond_width(run.arch)))
    return 100.0 * bound / (1e-3 * sum(us) / len(us))


def stack_kernels(backward: bool):
    """A predicate on trace kernel names: the training stack's forward
    (train_stack.cu's kernels named fwd*) or backward (its other kernels,
    and tile.cuh's weight-gradient reduction, which in a training step
    only the stack's backward launches)."""
    ts = source_kernels("train_stack.cu")
    fwd = {q for q in ts if q.rsplit("::", 1)[-1].startswith("fwd")}
    return kernel_matcher((ts - fwd) | source_kernels("tile.cuh") if backward else fwd)


def stack_roofline(run, backward: bool):
    """% of the training stack's roofline: the bound of one call at the
    recipe's (B, T) over the device time of one call's kernels (their sum
    over the traced phase, by their csrc names, over the calls the
    benchmark's spans counted there)."""
    td = run.trace_data
    if td is None:
        return None
    calls = len(td.span_device_us("stack_bwd" if backward else "stack_fwd"))
    us = td.kernel_us(stack_kernels(backward))
    if not calls or not us:
        return None
    arch, tr = run.arch, run.train
    t = costs.receptive_field(arch) - 1 + tr["window_size"]
    bound, _ = costs.bound_ms(*costs.train_stack_cost(arch, tr["batch_size"], t,
                                                      costs.wbytes(arch), backward,
                                                      costs.cond_width(arch)))
    return 100.0 * bound / (1e-3 * sum(us) / calls)


def idle_share(run):
    """% of the traced phase with no kernel running on the device."""
    td = run.trace_data
    if td is None or td.window_s <= 0:
        return None
    return 100.0 * (1.0 - td.busy_s / td.window_s)
