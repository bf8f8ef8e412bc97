"""What the mol and data-parallel cells' readers share: the MoL head pair's
device time in the trace, and the program's `train.allreduce` spans."""
from __future__ import annotations

from typing import Optional

from .trace import CSRC, kernel_matcher, source_kernels

HEAD_SOURCE = "post_mol.cu"


def head_us_per_step(run) -> Optional[float]:
    """Device us a training step of the head pair's launches (the kernels
    csrc/post_mol.cu defines, by their `__global__` names), over the traced
    phase's `train_step` spans; None without a trace, without the source
    (a program that has no such pair) or without its kernels."""
    td = run.trace_data
    if td is None or not (CSRC / HEAD_SOURCE).exists():
        return None
    steps = len(td.span_device_us("train_step"))
    us = td.kernel_us(kernel_matcher(source_kernels(HEAD_SOURCE)))
    if not steps or not us:
        return None
    return sum(us) / steps


def allreduce_ms_per_step(run) -> Optional[float]:
    """Host ms a training step inside the program's `train.allreduce` spans
    over the traced phase (on this process: rank 0), or None where the
    program records no such span."""
    from . import program_spans

    td = run.trace_data
    records = program_spans.program_records() if td is not None else None
    if not records:
        return None
    names = {r.name for r in records}
    if "train.allreduce" not in names or "train.step" not in names:
        return None
    steps = [r for r in records if r.name == "train.step"]
    t0, t1 = min(r.start for r in steps), max(r.end for r in steps)
    inside = [r.end - r.start for r in records
              if r.name == "train.allreduce" and t0 <= r.start <= t1]
    return 1e3 * sum(inside) / len(steps)
