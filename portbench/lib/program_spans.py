"""The program's own spans in a traced phase: the device's idle time split
by the training step's phases.

The port records a span (`lb_wavenet_tpu_torch.utils.profiling.span`)
around each phase of a training step while a torch.profiler records;
`profiling.spans()` returns them on the host clock (time.perf_counter()
seconds). They are placed on the trace's clock by the offset that the
benchmark's own spans give: `lib/trace.host_spans` placed each record of
`run.spans` at one offset, so a placed span and its record share a name
and a length and differ by that offset.

Each interval of the traced phase with no kernel on the device is split
by the program's spans, in the order of PHASES: the part under
`cond.upsample`, then the rest under `train.forward`, then under
`train.backward`, then under `train.optimizer`; the remainder is "other"
(further split by OTHER in `other_idle_ms_by_span`). The split is in ms a
training step (the `train.step` spans in the phase, each counted by the
share of it inside the phase), so it adds up to the phase's idle time
over the steps. A program without these spans (no `profiling.spans`, or no
`train.step` in the phase) gives None.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

PHASES = (("upsample", "cond.upsample"), ("forward", "train.forward"),
          ("backward", "train.backward"), ("optimizer", "train.optimizer"))
OTHER = (("to_device", "train.to_device"), ("data_wait", "data.wait"),
         ("step", "train.step"))
STEP = "train.step"


def program_records() -> Optional[list]:
    """The program's span records, or None where it keeps none."""
    try:
        from lb_wavenet_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return None if spans is None else spans()


def clock_offset_us(host_spans, records: dict) -> Optional[float]:
    """Trace us minus host us: the offset most placed spans agree on,
    each matched to the records of its name of the same length (ns)."""
    lengths: dict = {}
    for name, recs in records.items():
        for s0, s1 in recs:
            lengths.setdefault((name, round((s1 - s0) * 1e9)), []).append(s0)
    votes, exact = Counter(), {}
    for name, a, b in host_spans:
        ns = round((b - a) * 1e3)
        for key in ((name, ns), (name, ns - 1), (name, ns + 1)):
            for s0 in lengths.get(key, ()):
                off = a - s0 * 1e6
                votes[round(off, 1)] += 1
                exact.setdefault(round(off, 1), off)
    if not votes:
        return None
    return exact[votes.most_common(1)[0][0]]


def union(intervals) -> list:
    """Sorted disjoint intervals covering `intervals`."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def subtract(base, cut) -> list:
    """Disjoint sorted `base` minus the disjoint sorted `cut`."""
    out, j = [], 0
    for a, b in base:
        while j < len(cut) and cut[j][1] <= a:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < b:
            if cut[k][0] > a:
                out.append((a, cut[k][0]))
            a = max(a, cut[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def idle_intervals(td) -> list:
    """The traced phase's intervals (trace us) with no kernel running."""
    a0 = td.phase_start_us
    return subtract([(a0, a0 + td.window_s * 1e6)], union((a, b) for _, a, b in td.kernels))


def split(idle: list, placed: dict, order) -> tuple:
    """({key: idle us under the spans of name, less those before it in
    `order`}, the idle left under none)."""
    out = {}
    for key, name in order:
        under = subtract(idle, subtract(idle, union(placed.get(name, ()))))
        out[key] = length(under)
        idle = subtract(idle, under)
    return out, idle


def idle_split(run) -> Optional[dict]:
    """The traced phase's idle time by phase, ms a training step, with
    `other`; None without a trace or without the program's spans. Also
    puts the split, the steps counted and the longest idle gaps named by
    the innermost program span into run.info. Computed once a run."""
    if "_program_idle" in vars(run):
        return run._program_idle
    run._program_idle = out = _idle_split(run)
    return out


def _idle_split(run) -> Optional[dict]:
    td = run.trace_data
    if td is None:
        return None
    steps_pb = len(td.span_device_us("train_step"))
    if steps_pb and td.window_s > 0:
        run.info["traced_steps_per_s"] = steps_pb / td.window_s
    records = program_records()
    offset = clock_offset_us(td.host_spans, run.spans.snapshot()) if records else None
    if offset is None:
        return None
    a0 = td.phase_start_us
    b0 = a0 + td.window_s * 1e6
    placed: dict = {}
    for r in records:
        s0, s1 = r.start * 1e6 + offset, r.end * 1e6 + offset
        if s1 > a0 and s0 < b0:
            placed.setdefault(r.name, []).append((s0, s1))
    steps = sum((min(s1, b0) - max(s0, a0)) / (s1 - s0)
                for s0, s1 in placed.get(STEP, ()) if s1 > s0)
    if steps <= 0:
        return None
    idle = idle_intervals(td)
    by_phase, rest = split(idle, placed, PHASES)
    other, outside = split(rest, placed, OTHER)
    by_phase["other"] = length(rest)
    other["outside"] = length(outside)
    ms = {k: v / 1e3 / steps for k, v in by_phase.items()}
    run.info["idle_ms_by_phase"] = ms
    run.info["other_idle_ms_by_span"] = {k: v / 1e3 / steps for k, v in other.items()}
    run.info["program_steps"] = steps
    run.info["program_idle_gaps"] = idle_gaps(idle, placed)
    return ms


def idle_gaps(idle: list, placed: dict, k: int = 10) -> list:
    """[[innermost program span at the gap's midpoint, seconds]] of the k
    longest idle intervals: the latest to start, the shortest among those
    ("host" where no span covers it)."""
    out = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:k]:
        mid = 0.5 * (a + b)
        inside = [(s0, -s1, n) for n, iv in placed.items() for s0, s1 in iv
                  if s0 <= mid <= s1]
        out.append([max(inside)[2] if inside else "host", (b - a) / 1e6])
    return out


def idle_ms(run, phase: str) -> Optional[float]:
    """Idle ms a training step under `phase` (a key of PHASES)."""
    split_ms = idle_split(run)
    return None if split_ms is None else split_ms[phase]
