"""Reading the device trace of a traced run.

`source_kernels` and `union_us` are frozen copies of chip_smoke.py's: a
kernel the port launches through ctypes carries no op name in the trace,
so it is known by the `__global__` functions its csrc source defines, and
the device is busy over the union of kernel intervals (a programmatic
dependent launch's span overlaps the launch before it).

`traced_phase` wraps `torch.profiler` (CPU and CUDA activities) around
the traced phase. The benchmark's spans (`Spans`) on the profiling thread
enter a `record_function` there, so the trace says how much device time
the kernels launched inside such a span took (the profiler records host
spans of that thread only). Which span the host was in while the device
sat idle is read from the spans of every thread, their host clock mapped
onto the trace's by the phase's own span.
"""
from __future__ import annotations

import re
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "lb_wavenet_tpu_torch" / "csrc"
SPAN_PREFIX = "pb::"


def source_kernels(name: str, csrc: Path = CSRC) -> set:
    """Qualified names (wn::...::name) of the __global__ functions defined
    in csrc/<name> (a .cu or .cuh file), by a scan of its namespaces."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", "", (csrc / name).read_text(), flags=re.S)
    pat = re.compile(r"namespace\s+(\w+)\s*\{|__global__\s+void\s+"
                     r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(|[{}]")
    stack, depth, names = [], 0, set()
    for m in pat.finditer(text):
        if m.group(1):
            depth += 1
            stack.append((m.group(1), depth))
        elif m.group(2):
            names.add("::".join([n for n, _ in stack] + [m.group(2)]))
        elif m.group(0) == "{":
            depth += 1
        else:
            if stack and stack[-1][1] == depth:
                stack.pop()
            depth -= 1
    return names


def kernel_matcher(qualified: set):
    """A predicate on a trace kernel name: true for a kernel of `qualified`
    (a template instance or a launch with its argument list included)."""
    pat = re.compile("|".join(r"(?<![\w:])" + re.escape(q) + r"[<(]" for q in sorted(qualified)))
    return lambda name: bool(pat.search(name))


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


class TraceData:
    """What the benchmark reads from one traced phase: device kernels
    [(name, start_us, end_us)], the benchmark's spans [(name, start_us,
    end_us, device_us of the kernels launched inside)], and the phase's
    host-clock length."""

    def __init__(self, kernels, spans, window_s: float, host_spans=()):
        self.kernels = kernels
        self.spans = spans
        self.window_s = window_s
        self.host_spans = list(host_spans)   # (name, start_us, end_us), every thread

    @property
    def busy_s(self) -> float:
        return union_us([(a, b) for _, a, b in self.kernels]) / 1e6

    def kernel_us(self, match) -> list:
        """Durations (us) of the kernels whose name `match` accepts."""
        return [b - a for n, a, b in self.kernels if match(n)]

    def span_device_us(self, name: str) -> list:
        """Device us of the kernels launched inside each span `name`."""
        return [d for n, _, _, d in self.spans if n == name]

    def top_ops(self, k: int = 10) -> list:
        """[[kernel name, seconds]] of the k kernels that took most time."""
        tot: dict = {}
        for n, a, b in self.kernels:
            tot[n] = tot.get(n, 0.0) + (b - a) / 1e6
        return [[n[:160], s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[[span the host was in, seconds]] of the k longest gaps with no
        kernel running, each named by the innermost benchmark span that
        covers the gap's midpoint ("host" where none does)."""
        iv = sorted((a, b) for _, a, b in self.kernels)
        gaps, end = [], None
        for a, b in iv:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        named = self.host_spans or [(n, s0, s1) for n, s0, s1, _ in self.spans]
        for a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            inside = [(s0, n) for n, s0, s1 in named if s0 <= mid <= s1]
            name = max(inside)[1] if inside else "host"
            out.append([name, (b - a) / 1e6])
        return out


class Profiled:
    """torch.profiler over a phase: `with Profiled(device, spans) as p: ...`,
    then `p.data` (a TraceData). The phase is itself a span ("pb::phase")
    on the trace's clock, and the kernels are cut to it: a kernel already
    running when the profiler starts counts only from the phase's start.
    On a CPU run it records nothing (p.data None)."""

    def __init__(self, device, spans=None):
        self.device = device
        self.spans = spans
        self.data = None
        self._prof = None

    def __enter__(self):
        import time

        from torch.profiler import ProfilerActivity, profile, record_function

        if self.device.type != "cuda":
            return self
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._phase = record_function(SPAN_PREFIX + "phase")
        self._phase.__enter__()
        self._h0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        import torch

        if self._prof is None:
            return False
        torch.cuda.synchronize()
        h1 = time.perf_counter()
        self._phase.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.data = parse(self._prof)
            if self.spans is not None:
                self.data.host_spans = host_spans(self.spans, self._h0, h1, self.data)
        return False


def host_spans(spans, h0: float, h1: float, data: TraceData) -> list:
    """Every thread's spans inside the phase [h0, h1] (host clock), placed
    on the trace's clock by the phase's start."""
    a0 = data.phase_start_us
    out = []
    for name, recs in spans.snapshot().items():
        for s0, s1 in recs:
            if s1 > h0 and s0 < h1:
                out.append((name, a0 + (s0 - h0) * 1e6, a0 + (s1 - h0) * 1e6))
    return out


def traced_phase(run, body, attempts: int = 2) -> None:
    """Run `body()` under the profiler, with the benchmark's spans entering
    record_function, into `run.trace_data`. A trace that holds no kernel at
    all (the profiler has been seen to lose every kernel record of a
    phase, keeping the copies) is taken again, once."""
    for attempt in range(1, attempts + 1):
        run.spans.tracing = True
        with Profiled(run.device, run.spans) as prof:
            body()
        run.spans.tracing = False
        run.trace_data = prof.data
        run.info["trace_attempts"] = attempt
        if prof.data is None or any(not n.startswith(("Memcpy", "Memset"))
                                    for n, _, _ in prof.data.kernels):
            return


def _device_us(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def parse(prof) -> TraceData:
    """The kernels cut to the "phase" span, the benchmark's other spans,
    and the phase's length."""
    import torch

    kernels, spans = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        if e.device_type == cuda:
            if e.name.startswith(SPAN_PREFIX):   # a span's own range on the GPU timeline
                continue
            kernels.append((e.name, float(e.time_range.start), float(e.time_range.end)))
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name[len(SPAN_PREFIX):], float(e.time_range.start),
                          float(e.time_range.end), _device_us(e)))
    phase = [(a, b) for n, a, b, _ in spans if n == "phase"]
    if len(phase) != 1:
        raise RuntimeError(f"the trace holds {len(phase)} phase spans, not 1")
    a0, b0 = phase[0]
    kernels = [(n, max(a, a0), min(b, b0)) for n, a, b in kernels if b > a0 and a < b0]
    data = TraceData(kernels, [s for s in spans if s[0] != "phase"], (b0 - a0) / 1e6)
    data.phase_start_us = a0
    return data


def warm_profiler(device) -> None:
    """Start and stop the profiler once in set-up, so that its first start
    (CUPTI's initialisation) does not fall into the traced phase."""
    import torch

    if device.type != "cuda":
        return
    with Profiled(device):
        torch.ones(8, device=device).sum()
