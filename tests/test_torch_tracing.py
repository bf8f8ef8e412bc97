"""Port tests: the program's spans (utils/profiling.py `span`). Off, they
record nothing and the pool's phase totals still add up; under
torch.profiler, a training step records its phases nested with parents
and threads, as ranges of the profiler's timeline too; every ctypes launch
is a `kernel.<fn>` span; the pool's stats are the sums of its `pool.*`
spans; the buffer stays bounded. Also run_training's log window, which
leaves checkpoint saves out of step_time_ms."""
import collections
import contextlib
import ctypes
import json
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lb_wavenet_tpu_torch import train as PT
from lb_wavenet_tpu_torch.config import ArchConfig, Config, TrainConfig
from lb_wavenet_tpu_torch.data import prefetch, synthetic_corpus
from lb_wavenet_tpu_torch.models.wavenet import init_params
from lb_wavenet_tpu_torch.ops.cuda import build
from lb_wavenet_tpu_torch.serving import SessionPool
from lb_wavenet_tpu_torch.utils import profiling

torch.set_num_threads(1)
ARCH = ArchConfig(n_blocks=1, n_layers_per_block=3, residual_channels=8, skip_channels=8,
                  gate_channels=8, compute_dtype="float32")
MEL = ArchConfig(n_blocks=1, n_layers_per_block=3, residual_channels=8, skip_channels=8,
                 gate_channels=8, compute_dtype="float32", n_mels=8, cond_channels=8,
                 upsample_factors=(2, 4))
W = 16
PHASES = ("reset", "cond", "dispatch", "fetch", "slice", "submit")


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh_buffer(monkeypatch):
    """Each test reads the spans it made alone."""
    monkeypatch.setattr(profiling, "_records",
                        collections.deque(maxlen=profiling.SPAN_BUFFER))


def host_batch(arch: ArchConfig, seed: int = 0):
    """A batch as make_batches gives it: B=2, the receptive field plus W
    inputs, W targets, with log-mel frames for a mel arch."""
    rng = np.random.default_rng(seed)
    t = arch.receptive_field - 1 + W
    mel = None
    if arch.use_local_cond:
        hop = int(np.prod(arch.upsample_factors))
        mel = rng.standard_normal((2, -(-t // hop), arch.n_mels)).astype(np.float32)
    return types.SimpleNamespace(
        inputs=rng.integers(0, 256, (2, t)).astype(np.int32),
        targets=rng.integers(0, 256, (2, W)).astype(np.int32),
        mask=np.ones((2, W), np.float32), mel=mel, speaker=None)


def one_step(arch: ArchConfig):
    train = TrainConfig(batch_size=2, window_size=W)
    state = PT.init_state(0, arch, train, "cpu")
    PT.train_step(state, PT.batch_to_device(host_batch(arch), "cpu"), arch, train)


def test_spans_off_record_nothing():
    """Without a profiler the flag is off: a whole step, its upload and the
    loader's wait leave the buffer as it was."""
    one_step(MEL)
    assert next(prefetch(iter([1]))) == 1
    assert profiling.spans() == []


@pytest.mark.parametrize("arch", [ARCH, MEL], ids=["unconditioned", "mel"])
def test_train_step_phases_nest_under_the_profiler(arch):
    """train.step holds train.forward (which holds cond.upsample on a mel
    arch), train.backward and train.optimizer, in that order, each with its
    parent and thread; the profiler's events carry the same names."""
    with cpu_profile() as prof:
        one_step(arch)
    recs = profiling.spans()
    by_name = collections.defaultdict(list)
    for r in recs:
        by_name[r.name].append(r)
    want = {"train.to_device", "train.step", "train.forward", "train.backward",
            "train.optimizer"} | ({"cond.upsample"} if arch.use_local_cond else set())
    assert set(by_name) == want
    assert all(len(v) == 1 for v in by_name.values())
    (step,), (fwd,), (bwd,), (opt,) = (by_name[n] for n in (
        "train.step", "train.forward", "train.backward", "train.optimizer"))
    assert by_name["train.to_device"][0].parent is None and step.parent is None
    assert fwd.parent == bwd.parent == opt.parent == "train.step"
    assert step.start <= fwd.start < fwd.end <= bwd.start < bwd.end <= opt.start
    assert opt.end <= step.end
    if arch.use_local_cond:
        (up,) = by_name["cond.upsample"]
        assert up.parent == "train.forward" and fwd.start <= up.start < up.end <= fwd.end
    assert {r.thread for r in recs} == {threading.get_ident()}
    assert want <= {e.name for e in prof.events()}


def test_loader_wait_and_other_threads():
    """data.wait wraps the consumer's wait on the prefetch queue; a span on
    another thread has that thread and no parent from this one (the buffer
    holds every thread's spans; the profiler's timeline, those of the
    threads it records)."""
    seen = {}

    def worker():
        with profiling.span("other.thread"):
            seen["ident"] = threading.get_ident()

    with cpu_profile() as prof:
        with profiling.span("outer"):
            assert list(prefetch(iter([1, 2]))) == [1, 2]
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    recs = profiling.spans()
    waits = [r for r in recs if r.name == "data.wait"]
    assert len(waits) == 3 and all(r.parent == "outer" for r in waits)   # 2 items, the end
    (other,) = [r for r in recs if r.name == "other.thread"]
    assert other.parent is None and other.thread == seen["ident"] != threading.get_ident()
    assert {"data.wait", "outer"} <= {e.name for e in prof.events()}


def test_every_ctypes_launch_is_a_kernel_span(monkeypatch):
    """build.launch calls the library's entry inside `kernel.<fn>` and
    returns the launches it reports."""
    seen = []

    def wn_fake(args, stream, n):
        seen.append(stream)
        ctypes.c_int.from_address(n).value = 31
        return 0

    lib = types.SimpleNamespace(wn_fake=wn_fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    with cpu_profile() as prof:
        with profiling.span("train.forward"):
            n = build.launch(lib, "wn_fake", ctypes.c_int(0), torch.device("cpu"))
    assert n == 31 and seen == [0]
    (rec,) = [r for r in profiling.spans() if r.name.startswith("kernel.")]
    assert rec.name == "kernel.wn_fake" and rec.parent == "train.forward"
    assert "kernel.wn_fake" in {e.name for e in prof.events()}


@pytest.mark.parametrize("traced", [False, True], ids=["off", "profiled"])
@pytest.mark.parametrize("deliver", ["chunk", "request"])
def test_pool_stats_are_the_sums_of_its_spans(traced, deliver):
    """The pool's phase totals add up with tracing off as on; profiled, each
    total grew by exactly the seconds of its pool.<phase> spans."""
    params = init_params(0, ARCH, "cpu")
    pool = SessionPool(params, ARCH, 2, 0, engine="mega", chunk_size=8, pipeline=True,
                       deliver=deliver, acc_samples=64, device="cpu")
    before = dict(pool.stats)
    with cpu_profile() if traced else contextlib.nullcontext():
        assert pool.submit("a", 20) and pool.submit("b", 5)
        got = collections.Counter()
        for _ in range(8):
            for rid, (classes, _done) in pool.step().items():
                got[rid] += len(classes)
            if not pool.active:
                break
        pool.submit("c", 3)
    assert dict(got) == {"a": 20, "b": 5}
    assert pool.stats["steps"] > before["steps"]
    for phase in PHASES:
        assert pool.stats[f"{phase}_s"] > before[f"{phase}_s"], phase
    recs = profiling.spans()
    if not traced:
        assert recs == []
        return
    for phase in PHASES:
        spans = [r for r in recs if r.name == f"pool.{phase}"]
        assert spans, phase
        assert pool.stats[f"{phase}_s"] - before[f"{phase}_s"] == pytest.approx(
            sum(r.end - r.start for r in spans), rel=1e-9, abs=1e-12), phase


def test_the_buffer_stays_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=5))
    with cpu_profile():
        for i in range(20):
            with profiling.span(f"s{i}"):
                pass
    assert [r.name for r in profiling.spans()] == [f"s{i}" for i in range(15, 20)]


def test_step_time_leaves_checkpoint_saves_out(tmp_path, monkeypatch):
    """A save that takes 100 s on the loop's clock shows in no step_time_ms
    (every other reading of the clock advances it by 1 ms)."""
    clock = [0.0]

    def perf_counter():
        clock[0] += 1e-3
        return clock[0]

    real_save = PT.ckpt_lib.save

    def slow_save(*a, **kw):
        clock[0] += 100.0
        return real_save(*a, **kw)

    monkeypatch.setattr(PT, "time", types.SimpleNamespace(perf_counter=perf_counter))
    monkeypatch.setattr(PT.ckpt_lib, "save", slow_save)
    metrics = tmp_path / "metrics.jsonl"
    cfg = Config(arch=ARCH, train=TrainConfig(
        batch_size=2, window_size=W, n_steps=6, log_every=2, checkpoint_every=2,
        checkpoint_dir=str(tmp_path / "ckpt"), metrics_path=str(metrics)))
    corpus = synthetic_corpus(ARCH, W, n_files=2, file_len=400)
    PT.run_training(cfg, corpus=corpus, device="cpu")
    times = [r["step_time_ms"] for r in map(json.loads, metrics.read_text().splitlines())
             if "step_time_ms" in r]
    assert len(times) == 3 and max(times) < 10.0, times
