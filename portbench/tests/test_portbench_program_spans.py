"""lib/program_spans.py on a made-up traced phase: the program's spans
placed on the trace's clock by the benchmark's own spans, the device's
idle time split by phase with nesting, gaps across two phases, steps cut
at the phase's edges, and a program without spans."""
import types

import pytest

from portbench import harness
from portbench.lib import program_spans
from portbench.lib.spans import Spans
from portbench.lib.trace import TraceData, host_spans

H0, A0 = 1000.0, 5.0e6     # the phase's start: host seconds, trace us


def host(t_ms: float) -> float:
    return H0 + t_ms / 1e3


def trace(t_ms: float) -> float:
    return A0 + t_ms * 1e3


# Three steps over a 30 ms phase; the first and the last cut at its edges
# (6 of 10 ms inside each), so 2.2 steps.
PROGRAM = [
    ("train.step", -4, 6), ("train.forward", -3, 2), ("train.backward", 2, 5),
    ("train.optimizer", 5, 6),
    ("train.to_device", 7, 8),
    ("train.step", 8, 20), ("train.forward", 8, 14), ("cond.upsample", 9, 11),
    ("train.backward", 14, 18), ("train.optimizer", 18, 20),
    ("train.step", 24, 34), ("train.forward", 24, 30), ("train.backward", 30, 34),
]
KERNELS = [(0, 1), (3, 4.5), (9.5, 10.5), (13, 15), (16, 25), (26, 30)]
# Idle: [1, 3] forward 1 + backward 1; [4.5, 9.5] backward 0.5, optimizer 1,
# nothing 1, to_device 1, forward 1, upsample 0.5; [10.5, 13] upsample 0.5,
# forward 2; [15, 16] backward 1; [25, 26] forward 1.
WANT_MS = {"upsample": 1.0, "forward": 5.0, "backward": 2.5, "optimizer": 1.0, "other": 2.0}
STEPS = 2.2


def phase_run():
    """A run whose traced phase holds the benchmark's train_step spans
    (placed by lib/trace.host_spans, plus one record before the phase of
    the same length as one inside it) and PROGRAM's spans."""
    sp = Spans()
    sp.records = {"train_step": [(host(-1004.5), host(-993.8)), (host(-4.5), host(6.2)),
                                 (host(7.5), host(20.2)), (host(23.5), host(34.2))]}
    td = TraceData([("k", trace(a), trace(b)) for a, b in KERNELS],
                   [("train_step", trace(a), trace(b), 0.0)
                    for a, b in ((-4.5, 6.2), (7.5, 20.2), (23.5, 34.2))], 0.030)
    td.phase_start_us = A0
    td.host_spans = host_spans(sp, H0, host(30), td)
    return types.SimpleNamespace(trace_data=td, spans=sp, info={})


def records():
    return [types.SimpleNamespace(name=n, start=host(a), end=host(b)) for n, a, b in PROGRAM]


def test_clock_offset_is_the_benchmark_spans_offset():
    run = phase_run()
    assert len(run.trace_data.host_spans) == 3
    assert program_spans.clock_offset_us(run.trace_data.host_spans, run.spans.snapshot()) \
        == pytest.approx(A0 - H0 * 1e6, abs=1e-3)
    assert program_spans.clock_offset_us([], run.spans.snapshot()) is None


def test_idle_split_by_phase(monkeypatch):
    monkeypatch.setattr(program_spans, "program_records", records)
    run = phase_run()
    for phase in ("upsample", "forward", "backward", "optimizer"):
        got = harness.load_reader(f"{phase}_idle_ms.train").read(run)
        assert got == pytest.approx(WANT_MS[phase] / STEPS), phase
    info = run.info
    assert info["program_steps"] == pytest.approx(STEPS)
    assert info["idle_ms_by_phase"] == pytest.approx({k: v / STEPS for k, v in WANT_MS.items()})
    assert info["other_idle_ms_by_span"] == pytest.approx(
        {"to_device": 1 / STEPS, "data_wait": 0.0, "step": 0.0, "outside": 1 / STEPS})
    td = run.trace_data
    idle_ms = 1e3 * (td.window_s - td.busy_s)
    assert sum(info["idle_ms_by_phase"].values()) * info["program_steps"] == pytest.approx(
        idle_ms)
    assert info["program_idle_gaps"][:2] == [["train.to_device", pytest.approx(5e-3)],
                                             ["train.forward", pytest.approx(2.5e-3)]]
    assert info["traced_steps_per_s"] == pytest.approx(3 / 0.030)


@pytest.mark.parametrize("case", ["no_trace", "no_facility", "no_steps"])
def test_a_program_without_spans_reads_nothing(monkeypatch, case):
    """The parent program (no profiling.spans), a run without a trace, or
    spans without a train.step: every reader returns None, and none
    raises."""
    run = phase_run()
    if case == "no_trace":
        run.trace_data = None
    elif case == "no_facility":
        from lb_wavenet_tpu_torch.utils import profiling

        monkeypatch.delattr(profiling, "spans")
        assert program_spans.program_records() is None
    else:
        monkeypatch.setattr(program_spans, "program_records",
                            lambda: [r for r in records() if r.name != "train.step"])
    for phase in ("upsample", "forward", "backward", "optimizer"):
        assert harness.load_reader(f"{phase}_idle_ms.train").read(run) is None
    assert "idle_ms_by_phase" not in run.info
