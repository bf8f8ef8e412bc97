"""Timing, tracing and the speed-of-light yardstick of the port (counterpart
of `lb_wavenet_tpu/utils/profiling.py`).

`sync_time` times a call to its end on the card; `trace(log_dir)` wraps a
block in a `torch.profiler` trace (CPU and CUDA activities) written into
`log_dir` as a Chrome trace. `span(name)` marks a phase of the program
(`train.step`, `train.forward`, `kernel.<fn>` around each ctypes launch,
`pool.dispatch`, ...): while a `torch.profiler` records, the span enters
the profiler's timeline as a range of that name and keeps a `SpanRecord`
in a bounded buffer (`spans()`); otherwise it records nothing. The
`*_cost` functions give the bytes each kernel's function must move (each
input read once, each output written once) and the operations it does;
`bound_ms` turns them into the least time an H100 SXM could take by its
data sheet (989 TFLOP/s dense bf16, 3.35 TB/s HBM3). chip_smoke.py's
`kernels` line, `cli info` and PERF.md's bound column read these same
functions.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Callable, NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak (H100 SXM data sheet)
H100_BYTES_S = 3.35e12    # HBM3 bandwidth (H100 SXM data sheet)
DEVICE = "H100 SXM (data sheet)"


def _sync() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def sync_time(fn: Callable[[], object], reps: int = 3) -> float:
    """Best of `reps` wall seconds of fn(), each to the end of its work on
    the card (torch.cuda.synchronize before and after)."""
    best = float("inf")
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


class SpanRecord(NamedTuple):
    name: str
    start: float            # time.perf_counter() seconds
    end: float
    parent: Optional[str]   # the innermost span open on the same thread at the start
    thread: int             # threading.get_ident()


SPAN_BUFFER = 1 << 16       # records kept; the oldest are dropped beyond
_records: "collections.deque" = collections.deque(maxlen=SPAN_BUFFER)
_records_lock = threading.Lock()
_open = threading.local()   # .names: the spans open on this thread, innermost last
_OFF = contextlib.nullcontext()


def span(name: str, totals: Optional[dict] = None, key: str = ""):
    """A context manager marking the phase `name` of the program. Tracing is
    on exactly while a torch.profiler records (the autograd profiler's
    flag): then the span is a range of the profiler's timeline and a
    SpanRecord in the buffer. Off, it costs this flag check. With `totals`
    it also adds its seconds to totals[key], on or off (a running total
    such as SessionPool.stats)."""
    if totals is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, totals, key)


def spans() -> list:
    """A snapshot of the buffer: the SpanRecords of every thread, oldest
    first."""
    with _records_lock:
        return list(_records)


class _Span:
    __slots__ = ("name", "totals", "key", "parent", "range", "t0")

    def __init__(self, name: str, totals: Optional[dict], key: str):
        self.name, self.totals, self.key = name, totals, key
        self.range = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            names = getattr(_open, "names", None)
            if names is None:
                names = _open.names = []
            self.parent = names[-1] if names else None
            names.append(self.name)
            self.range = _RecordFunctionFast(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.totals is not None:
            self.totals[self.key] += t1 - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
            _open.names.pop()
            record = SpanRecord(self.name, self.t0, t1, self.parent, threading.get_ident())
            with _records_lock:
                _records.append(record)
        return False


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler trace of the block (CPU activities, and CUDA ones
    where a card is present), written into `log_dir` as
    `trace_<pid>.json` (Chrome trace format) when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        _sync()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def mega_cost(arch, b: int, t: int, lane_rows: int, wbytes: int, cc: int = 0):
    """(bytes, flops) one mega_generate call must move and do: weights,
    biases, the carry read and written once, forced/lane in, classes out;
    with cc conditioning channels also w_cond, the (t, b, cc) cond rows and
    the cond product of every layer and step."""
    L, C, G = len(arch.dilations), arch.residual_channels, arch.gate_channels
    S, Q, K = arch.skip_channels, arch.quant_channels, arch.input_kernel
    w = L * ((2 * C + cc) * 2 * G + G * (C + S)) + S * S + S * Q + Q * C + K * C * C
    bias = L * (2 * G + C + S) + S + Q + C
    carry = (sum(arch.dilations) * C + L * 2 * C + C + (K - 1) * C) * b
    nbytes = (w * wbytes + 4 * (bias + 2 * carry + t * b + lane_rows * b + t * b)
              + t * b * cc * wbytes)
    flops = 2 * b * t * (L * ((2 * C + cc) * 2 * G + G * (C + S)) + S * S + S * Q
                         + K * C * C)
    return nbytes, flops


def stack_cost(arch, b: int, wbytes: int, cc: int = 0):
    """(bytes, flops) of one fused_stack step: weights, biases, h0, the L
    ring rows read and written, the skip sum out; with cc conditioning
    channels also w_cond, the (b, cc) cond row and its products."""
    L, C, G, S = (len(arch.dilations), arch.residual_channels,
                  arch.gate_channels, arch.skip_channels)
    w = L * ((2 * C + cc) * 2 * G + G * C + G * S)
    nbytes = (w * wbytes + 4 * (L * (2 * G + C + S) + b * C + 2 * L * b * C + b * S)
              + b * cc * wbytes)
    return nbytes, 2 * b * L * ((2 * C + cc) * 2 * G + G * C + G * S)


def train_stack_cost(arch, b: int, t: int, wbytes: int, backward: bool, cc: int = 0):
    """(bytes, flops) of the training stack's forward or backward at
    (b, t), as the TPU kernels define the function: each input read once,
    each output written once. The layer inputs x_all that the port's
    forward also stores (so its backward need not reconstruct x) are not
    counted: the function does not need them. With cc conditioning
    channels also cond (b, t, cc) in the compute dtype and w_cond in, and
    in the backward d cond (fp32) and d w_cond out; the products cond
    w_cond (forward, and the backward's recompute of pre), cond^T dpre and
    dpre w_cond^T."""
    L, C, G, S = (len(arch.dilations), arch.residual_channels,
                  arch.gate_channels, arch.skip_channels)
    w = L * ((2 * C + cc) * 2 * G + G * C + G * S)
    bias = L * (2 * G + C + S)
    z_all = L * b * t * G * wbytes
    cond = b * t * cc * wbytes
    if backward:   # z_all, x_final, g_skip, cond, weights in; dh0, d cond, grads out
        nbytes = (z_all + 4 * b * t * (2 * C + S) + cond + 4 * b * t * cc + w * wbytes
                  + 4 * (bias + w + bias))
        macs = L * b * t * (2 * C * 2 * G + G * (S + C) + 2 * (2 * G * C)
                            + 2 * C * 2 * G + G * C + G * S + 3 * cc * 2 * G)
    else:          # h0, cond, weights in; z_all, skip, x_final out
        nbytes = 4 * b * t * (2 * C + S) + cond + z_all + w * wbytes + 4 * bias
        macs = L * b * t * (2 * C * 2 * G + G * C + G * S + cc * 2 * G)
    return nbytes, 2 * macs


def post_loss_cost(arch, b: int, t: int, w: int, wbytes: int, backward: bool):
    """(bytes, flops) of the post-loss forward or backward over the scored
    window (the head rows need no work)."""
    S, Q = arch.skip_channels, arch.quant_channels
    weights = (S * S + S * Q) * wbytes + 4 * (S + Q)
    rows_in = 4 * b * w * S + 8 * b * w            # skip rows, targets, mask
    if backward:   # + dskip (all rows) and the gradients out
        return (rows_in + weights + 4 * b * t * S + 4 * (S * S + S * Q + S + Q),
                2 * b * w * 3 * (S * S + S * Q))
    return rows_in + weights + 4, 2 * b * w * (S * S + S * Q)


def mol_post_cost(arch, b: int, t: int, w: int, backward: bool):
    """(bytes, flops) of the MoL head pair's forward or backward over the
    scored window (csrc/post_mol.cu): the skip rows, target samples and
    mask, the head's fp32 weight and bias in; the numerator out, or, in
    the backward, dskip (all rows) and the head's gradients out. The
    operations are the head's products: y = relu(skip) w, and in the
    backward its recompute, da = dy w^T and dw = relu(skip)^T dy."""
    S, n3 = arch.skip_channels, 3 * arch.n_mix
    head = 4 * (S * n3 + n3)
    rows_in = 4 * b * w * S + 8 * b * w
    flops = 2 * b * w * S * n3
    if backward:
        return rows_in + head + 4 + 4 * b * t * S + head, 3 * flops
    return rows_in + head + 4, flops


def turbo_cost(arch, b: int, lane_rows: int, wbytes: int, cc: int = 0):
    """(bytes, flops) of one turbo step: weights and biases, h and the
    embedding stack in and out, the L ring rows read and written, forced
    and the lane block in, the classes out; with cc conditioning channels
    also w_cond, the (b, cc) cond row and its products."""
    L, C, G = len(arch.dilations), arch.residual_channels, arch.gate_channels
    S, Q, K = arch.skip_channels, arch.quant_channels, arch.input_kernel
    w = L * ((2 * C + cc) * 2 * G + G * C + G * S) + S * S + S * Q + Q * C + K * C * C
    bias = L * (2 * G + C + S) + S + Q + C
    state = 2 * (C + (K - 1) * C + L * C) * b
    nbytes = w * wbytes + 4 * (bias + state + b + lane_rows * b + b) + b * cc * wbytes
    flops = 2 * b * (L * ((2 * C + cc) * 2 * G + G * C + G * S) + S * S + S * Q
                     + K * C * C)
    return nbytes, flops


def frontend_cost(arch, b: int, t: int, backward: bool):
    """(bytes, flops) of the frontend's forward or backward at (b, t): the
    classes, table, taps and bias in (fp32, as the TPU kernel reads them);
    h0 out, or dh in and d_embed, d_w, d_b out."""
    C, Q, K = arch.residual_channels, arch.quant_channels, arch.input_kernel
    params = Q * C + K * C * C + C
    taps = 2 * b * t * K * C * C
    if backward:   # d_w and d_e products, plus the scatter's adds
        return 4 * (b * t + params + b * t * C + params), 2 * taps + b * t * C
    return 4 * (b * t + params + b * t * C), taps


def tp_cost(arch, b: int, s_l: int, wbytes: int, cc: int = 0):
    """(bytes, flops) of one tp_fused_stack step on a skip slice of width
    s_l: weights and biases, h0 in, the L ring rows read and written, the
    local skip sum out; with cc conditioning channels also w_cond, the
    (cc, b) cond tile and its products."""
    L, C, G = len(arch.dilations), arch.residual_channels, arch.gate_channels
    w = L * (2 * G * (2 * C + cc) + (C + s_l) * G)
    nbytes = (w * wbytes + 4 * (L * (2 * G + C + s_l) + C * b + 2 * L * C * b + s_l * b)
              + cc * b * wbytes)
    return nbytes, 2 * L * b * (2 * G * (2 * C + cc) + (C + s_l) * G)


def bound_ms(nbytes: int, flops: int):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over the bf16 peak."""
    by_bytes, by_ops = nbytes / H100_BYTES_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def _wbytes(arch) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[arch.compute_dtype]


def _cond_width(arch) -> int:
    """Cc': the folded conditioning row [mel | speaker] the kernels read."""
    return ((arch.cond_channels if arch.use_local_cond else 0)
            + (arch.speaker_embed_dim if arch.use_global_cond else 0))


def n_params(arch) -> int:
    """Parameters of the model the train step updates (the port's init_params
    leaves, upsampler and speaker table included)."""
    from ..models.wavenet import init_params
    from ..train import tree_leaves

    return sum(int(x.numel()) for x in tree_leaves(init_params(0, arch)))


def ar_step_speed_of_light(arch, batch: int) -> dict:
    """The least time of one sample step of `batch` lanes: `turbo_cost` (one
    turbo step: weights, state rings, the lane block, the post network and
    sampling) at the data-sheet rates. JAX's keys; its model of the TPU's
    matrix-unit fill and vector unit does not apply to the H100 and is left
    out."""
    nbytes, flops = turbo_cost(arch, batch, 3, _wbytes(arch), _cond_width(arch))
    t_compute, t_memory = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_S
    step = max(t_compute, t_memory)
    return {
        "device": DEVICE,
        "flops_per_step": flops,
        "hbm_bytes_per_step": nbytes,
        "t_compute_us": t_compute * 1e6,
        "t_memory_us": t_memory * 1e6,
        "sol_step_us": step * 1e6,
        "sol_steps_per_sec": 1.0 / step,
        "sol_audio_sec_per_sec": batch / (arch.sample_rate * step),
    }


def train_step_speed_of_light(arch, batch: int, window: int, tapcat: bool = True,
                              n_param: int = 0) -> dict:
    """The least time of one training step of `batch` x `window` samples: the
    sum of the frontend, training-stack and post-loss kernels' bounds,
    forward and backward, at (B, T = R - 1 + W), plus Adam's bytes (params,
    gradients and both moments read, params and moments written: 32 bytes a
    parameter, as JAX reckons them). The merged taps (`tapcat`) change no
    byte or operation of the function. JAX's keys where they apply: `mxu`
    names the tensor-core operations at the bf16 peak, with no fill
    adjustment; JAX's vector-unit term is the TPU's and is left out."""
    del tapcat
    wb, cc = _wbytes(arch), _cond_width(arch)
    t = arch.receptive_field - 1 + window
    costs = {
        "frontend_fwd": frontend_cost(arch, batch, t, False),
        "frontend_bwd": frontend_cost(arch, batch, t, True),
        "train_stack_fwd": train_stack_cost(arch, batch, t, wb, False, cc),
        "train_stack_bwd": train_stack_cost(arch, batch, t, wb, True, cc),
        "post_loss_fwd": post_loss_cost(arch, batch, t, window, wb, False),
        "post_loss_bwd": post_loss_cost(arch, batch, t, window, wb, True),
    }
    kernels = {k: bound_ms(*c)[0] for k, c in costs.items()}
    opt_bytes = 32 * (n_param or n_params(arch))
    flops = sum(c[1] for c in costs.values())
    nbytes = sum(c[0] for c in costs.values()) + opt_bytes
    t_mxu, t_hbm = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_S * 1e3
    step_ms = sum(kernels.values()) + opt_bytes / H100_BYTES_S * 1e3
    return {
        "device": DEVICE,
        "mxu_flops_per_step": flops,
        "t_mxu_ms": t_mxu,
        "t_hbm_ms": t_hbm,
        "hbm_bytes_per_step": nbytes,
        "optimizer_ms": opt_bytes / H100_BYTES_S * 1e3,
        "kernels_ms": kernels,
        "bound": "operations" if t_mxu >= t_hbm else "bytes",
        "sol_step_ms": step_ms,
        "sol_samples_per_sec": batch * window / (step_ms * 1e-3),
    }
