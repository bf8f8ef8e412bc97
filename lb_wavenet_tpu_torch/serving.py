"""Host-side continuous-batching serving loop over streaming sessions (port
of `lb_wavenet_tpu/serving.py`).

The device primitives live in generate.py (`start_stream`, `stream_chunk`,
`reset_lanes`); this module leases the lanes of ONE fixed-shape streaming
batch to requests and recycles them in place as they finish.

  * the pool always steps ALL lanes and discards idle lanes' output;
  * greedy output is bit-identical to a dedicated session, and sampled
    output (the per-lane counter hash, per_lane_rng=True) bit-matches a
    dedicated session opened with the same submit(seed=...);
  * classes are narrowed to uint8 on the device before they cross to the
    host (deliver="chunk"), or accumulated in a device-side uint8 time ring
    and gathered once per completed request (deliver="request").

`mesh=` (a parallel.mesh.Mesh) serves a MODEL-SHARDED pool: the session is a
parallel.synthesis.ShardedSession (skip split over `model`, lanes over
`data`). Every rank of the mesh runs the pool with the same submits, so the
lane bookkeeping is replicated; each chunk's classes are all-gathered over
`data`, so every rank (the CLI: rank 0) can deliver.

Conditioned requests (the mel vocoder, speakers): a request on a
mel-conditioned arch brings `cond_fn(t_local, n) -> (n, Cc)`, its
upsampled conditioning for samples t_local .. t_local + n - 1 (numpy, a
CPU tensor, or a tensor on the pool's device); a speaker-conditioned arch
takes `speaker`. Each chunk asks every leased lane for the steps it will
consume, zero-pads the tail, and assembles one (B, chunk, Cc) slab in the
compute dtype: host spans in a pinned buffer (two, used in turn) uploaded
with one asynchronous copy, device spans copied on the device.

Not ported yet: frozen artifacts (ROADMAP.md A queue item 5).
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .config import ArchConfig
from .generate import (
    Params,
    Rng,
    padded_stream_batch,
    reset_lanes,
    resolve_device,
    start_stream,
    stream_chunk,
)
from .models.wavenet import params_to


@dataclasses.dataclass
class _Lease:
    request_id: object
    remaining: int          # samples still to emit
    emitted: int = 0
    speaker: Optional[int] = None
    cond_fn: Optional[Callable] = None  # (t_local, n) -> (n, Cc)
    t_local: int = 0        # samples generated for THIS request so far
    start_t: int = 0        # pool-global sample index of the lease start


def _pow2_bucket(n: int, lo: int = 4096) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class SessionPool:
    """Continuous-batching pool: N concurrent AR synthesis sessions on one
    device.

        pool = SessionPool(params, arch, batch=128, rng=0, engine="mega",
                           chunk_size=1024)
        pool.submit("req-1", n_samples=16000, seed=7, temperature=0.7)
        while pool.active:
            for rid, (classes, done) in pool.step().items():
                deliver(rid, classes, done)   # (n,) int32 mu-law classes

    submit() returns False when no lane is free. A lane is reset the step
    after its request completes.
    """

    def __init__(
        self,
        params: Params,
        arch: ArchConfig,
        batch: int,
        rng: Rng,
        engine: str = "mega",
        chunk_size: int = 1024,
        temperature: float = 1.0,
        pipeline: bool = False,
        per_lane_rng: bool = True,
        mesh=None,
        deliver: str = "chunk",
        acc_samples: int = 65536,
        artifact=None,
        device="cuda",
    ):
        if artifact is not None:
            raise NotImplementedError(
                "serving artifacts are not ported yet (ROADMAP.md A queue item 5)"
            )
        self._session = None
        if mesh is not None:
            if not per_lane_rng and temperature > 0.0:
                raise ValueError(
                    "mesh pools need per_lane_rng=True (or greedy): the "
                    "session-global chain is not available under model sharding"
                )
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.arch = arch
        self.batch = batch
        self.engine = engine
        self.chunk_size = chunk_size
        self.temperature = temperature
        # pipeline=True: chunk t+1 is dispatched before chunk t is fetched,
        # so the device computes while the host delivers; step() returns
        # the PREVIOUS dispatch's results. Output is bit-identical.
        self.pipeline = pipeline
        self._inflight: Optional[tuple] = None
        self.per_lane_rng = per_lane_rng
        self._t_dispatched = 0
        self._n_submitted = 0
        gen = rng if isinstance(rng, torch.Generator) else \
            torch.Generator().manual_seed(int(rng) ^ 0x5EED)
        self._pool_seed = int(torch.randint(
            0, np.iinfo(np.int32).max, (), generator=gen, device=gen.device
        ))
        # The device session is padded to the engine's lane multiple; pad
        # lanes are free-running throwaways, never leased. A mesh pool's TP
        # step takes any batch: its device batch is the pool batch.
        self._device_batch = batch if mesh is not None else padded_stream_batch(batch, engine)
        self._lane_seed = np.zeros(self._device_batch, np.int32)
        self._lane_t0 = np.zeros(self._device_batch, np.int32)
        # Host-computed float32(1.0 / tau) per lane; inv == 0 is greedy.
        self._default_inv = (
            np.float32(1.0 / temperature) if temperature > 0
            else np.float32(0.0)
        )
        self._lane_inv_temp = np.full(
            self._device_batch, self._default_inv, np.float32
        )
        if mesh is not None:
            from .parallel.synthesis import ShardedSession

            self._session = ShardedSession(self.params, arch, batch, rng, mesh, engine=engine)
            self.stream = None
        else:
            self.stream = start_stream(arch, self._device_batch, rng,
                                       engine=engine, params=self.params,
                                       device=self.device)
        self._lanes: List[Optional[_Lease]] = [None] * batch
        # Free-lane min-heap: submit() leases the LOWEST free index.
        self._free: List[int] = list(range(batch))
        self._pending_reset = np.zeros(self._device_batch, dtype=bool)
        # Lanes of a brand-new stream are fresh sessions: no reset needed.
        self._fresh = np.ones(batch, dtype=bool)
        if deliver not in ("chunk", "request"):
            raise ValueError(f"deliver must be 'chunk'|'request', not {deliver!r}")
        self.deliver_mode = deliver
        self._acc = None
        if deliver == "request":
            if arch.quant_channels > 256:
                raise ValueError(
                    "deliver='request' stores uint8 classes; "
                    f"quant_channels={arch.quant_channels} > 256"
                )
            if acc_samples % chunk_size:
                raise ValueError(
                    f"acc_samples {acc_samples} % chunk_size {chunk_size} "
                    f"!= 0 (ring writes must stay chunk-aligned)"
                )
            if acc_samples < 3 * chunk_size:
                raise ValueError("acc_samples must be >= 3 * chunk_size")
            self._acc = torch.zeros((self._device_batch, acc_samples),
                                    dtype=torch.uint8, device=self.device)
        # The cond slab's host buffers (pinned on the card), used in turn,
        # each with the event of its last upload and the rows it wrote.
        self._cond_host: List[tuple] = []
        # Cumulative wall clock per phase (seconds): 'reset'/'cond'/
        # 'dispatch' are host-side enqueue work (asynchronous on the card;
        # 'cond' is the cond slab's assembly and upload), 'fetch' is the
        # device wait + device-to-host copy, 'slice' the per-request
        # delivery, 'submit' the lease bookkeeping.
        self.stats: Dict[str, float] = {
            "steps": 0, "reset_s": 0.0, "cond_s": 0.0, "dispatch_s": 0.0,
            "fetch_s": 0.0, "slice_s": 0.0, "submit_s": 0.0,
        }

    # -- request lifecycle ---------------------------------------------

    @property
    def active(self) -> bool:
        return (
            any(lease is not None for lease in self._lanes)
            or self._inflight is not None
        )

    def free_lanes(self) -> int:
        return len(self._free)

    def submit(
        self,
        request_id,
        n_samples: int,
        speaker: Optional[int] = None,
        cond_fn: Optional[Callable] = None,
        seed: Optional[int] = None,
        temperature: Optional[float] = None,
    ) -> bool:
        """Lease a free lane to a request; False if the pool is full.

        `seed` (per_lane_rng pools) pins the request's sampling seed: a
        dedicated session with the same seed replays it bit for bit.
        `temperature` (pools built with temperature > 0) overrides the pool
        default for this request; 0 means greedy. `cond_fn(t_local, n) ->
        (n, Cc)` (exactly when the arch is mel-conditioned) gives the
        request's upsampled conditioning; `speaker` (speaker-conditioned
        archs) its speaker, 0 when None."""
        if n_samples <= 0:
            raise ValueError(f"n_samples must be positive, got {n_samples}")
        if speaker is not None and not self.arch.use_global_cond:
            raise ValueError("speaker given but arch.n_speakers == 0")
        if (cond_fn is not None) != self.arch.use_local_cond:
            raise ValueError("cond_fn must be passed iff the arch is mel-conditioned")
        if seed is not None and not self.per_lane_rng:
            raise ValueError("submit(seed=...) needs per_lane_rng=True")
        if temperature is not None:
            if not self.per_lane_rng:
                raise ValueError(
                    "submit(temperature=...) needs per_lane_rng=True"
                )
            if self.temperature <= 0.0:
                raise ValueError(
                    "per-request temperature needs a SAMPLED pool "
                    "(construct SessionPool with temperature > 0; greedy "
                    "requests are submit(temperature=0) on such a pool)"
                )
            if temperature < 0.0:
                raise ValueError(f"temperature must be >= 0, got {temperature}")
        if self._acc is not None:
            cap = int(self._acc.shape[1])
            # A request's span plus ONE in-flight pipelined chunk must never
            # lap its own oldest sample in the time ring.
            if n_samples > cap - 2 * self.chunk_size:
                raise ValueError(
                    f"deliver='request' pools bound n_samples at "
                    f"acc_samples - 2*chunk = {cap - 2 * self.chunk_size} "
                    f"(got {n_samples}); raise acc_samples"
                )
        t0 = time.perf_counter()
        try:
            if not self._free:
                return False
            i = heapq.heappop(self._free)
            self._lanes[i] = _Lease(request_id, n_samples, speaker=speaker,
                                    cond_fn=cond_fn, start_t=self._t_dispatched)
            if self.per_lane_rng:
                if seed is None:
                    seed = (
                        self._pool_seed + self._n_submitted * 0x9E3779B9
                    ) & 0x7FFFFFFF
                self._lane_seed[i] = np.int32(seed & 0x7FFFFFFF)
                # Lane-local time starts at the NEXT dispatch.
                self._lane_t0[i] = self._t_dispatched
                self._lane_inv_temp[i] = (
                    self._default_inv if temperature is None
                    else np.float32(1.0 / temperature)
                    if temperature > 0 else np.float32(0.0)
                )
            self._n_submitted += 1
            if not self._fresh[i]:
                self._pending_reset[i] = True
            self._fresh[i] = False
            return True
        finally:
            self.stats["submit_s"] += time.perf_counter() - t0

    # -- the serving step ------------------------------------------------

    def step(self) -> Dict[object, tuple]:
        """Advance the pool one chunk; returns {request_id: (classes, done)}
        with each request's next (<= chunk_size,) int32 slice. Pipeline mode
        dispatches the next chunk FIRST, then delivers the previous one (the
        first call returns {})."""
        if not self.pipeline:
            return self._deliver(self._dispatch())
        prev = self._inflight
        self._inflight = (
            self._dispatch()
            if any(lease is not None for lease in self._lanes) else None
        )
        return self._deliver(prev) if prev is not None else {}

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Upload a copy of a host array without waiting for the device:
        the host arrays are mutated by submit() while an asynchronous
        dispatch may still read the upload."""
        t = torch.from_numpy(a.copy())
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _dispatch(self) -> tuple:
        """Apply pending resets and launch one chunk for the current leases
        (asynchronous on the card); returns (classes handle, metadata)."""
        t0 = time.perf_counter()
        if self._pending_reset.any():
            if self._session is not None:
                self._session.reset_lanes(self._pending_reset.copy())
            else:
                self.stream = reset_lanes(
                    self.params, self.arch, self.stream,
                    self._to_device(self._pending_reset), engine=self.engine,
                )
            self._pending_reset[:] = False
        t1 = time.perf_counter()
        self.stats["reset_s"] += t1 - t0

        speaker_ids = None
        if self.arch.use_global_cond:
            ids = np.zeros(self._device_batch, np.int32)   # idle and pad lanes: 0
            for i, lease in enumerate(self._lanes):
                if lease is not None and lease.speaker is not None:
                    ids[i] = lease.speaker
            speaker_ids = self._to_device(ids)
        cond = self._cond_slab() if self.arch.use_local_cond else None
        t2 = time.perf_counter()
        self.stats["cond_s"] += t2 - t1
        t1 = t2

        lane_kw = {}
        if self.per_lane_rng:
            lane_kw = dict(
                lane_seed=self._to_device(self._lane_seed),
                lane_t0=self._to_device(self._lane_t0),
            )
            if self.temperature > 0.0:
                # Always ride the per-lane inverse temperature on sampled
                # pools: logits * f32(1/tau) equals the folded constant.
                lane_kw["lane_inv_temp"] = self._to_device(self._lane_inv_temp)
        if self._session is not None:
            classes = self._session.chunk(self.chunk_size, cond=cond, speaker_ids=speaker_ids,
                                          temperature=self.temperature, **lane_kw)
        else:
            classes, self.stream = stream_chunk(
                self.params, self.arch, self.stream, self.chunk_size,
                cond=cond, speaker_ids=speaker_ids,
                temperature=self.temperature, engine=self.engine,
                global_rng=not self.per_lane_rng, **lane_kw,
            )
        if self.arch.quant_channels <= 256:
            classes = classes.to(torch.uint8)
        if self._acc is not None:
            # One chunk-aligned ring write on the device; nothing is fetched.
            pos = self._t_dispatched % int(self._acc.shape[1])
            self._acc[:, pos: pos + self.chunk_size] = classes
            handle = None
        else:
            handle = self._start_fetch(classes)
        self._t_dispatched += self.chunk_size

        meta = []
        for i, lease in enumerate(self._lanes):
            if lease is None:
                continue
            n = min(self.chunk_size, lease.remaining)
            lease.remaining -= n
            lease.emitted += n
            lease.t_local += self.chunk_size
            done = lease.remaining == 0
            if self._acc is None:
                meta.append((i, lease.request_id, n, done))
            elif done:
                meta.append(
                    (i, lease.request_id, lease.emitted, True, lease.start_t)
                )
            if done:
                self._lanes[i] = None
                heapq.heappush(self._free, i)
                self._pending_reset[i] = True
        # Every lane just advanced chunk_size free-running steps: a first
        # lease on a never-used lane from now on must reset it.
        self._fresh[:] = False
        self.stats["steps"] += 1
        self.stats["dispatch_s"] += time.perf_counter() - t1
        return handle, meta

    def _cond_slab(self) -> torch.Tensor:
        """This chunk's (device batch, chunk, Cc) conditioning in the
        compute dtype on the pool's device. Each leased lane's cond_fn is
        asked only for the steps its request will consume; the rest of the
        slab is zeros. Host spans (numpy or CPU tensors) are written into a
        host buffer (pinned on the card; two, used in turn, each reused
        after its last upload has completed) and uploaded with ONE
        asynchronous copy; spans already on the device are stacked and
        written by one indexed copy per span length. With no host span the
        slab is made on the device."""
        from .models.wavenet import compute_dtype

        dt = compute_dtype(self.arch)
        cc, n = self.arch.cond_channels, self.chunk_size
        host_rows, dev_rows = [], {}
        for i, lease in enumerate(self._lanes):
            if lease is None:
                continue
            n_need = min(n, lease.remaining)
            span = lease.cond_fn(lease.t_local, n_need)
            if tuple(span.shape) != (n_need, cc):
                raise ValueError(f"cond_fn returned {tuple(span.shape)}, expected "
                                 f"({n_need}, {cc})")
            if isinstance(span, torch.Tensor) and span.device.type != "cpu":
                dev_rows.setdefault(n_need, []).append((i, span))
            else:
                host_rows.append((i, span))
        cuda = self.device.type == "cuda"
        if host_rows or not cuda:
            if len(self._cond_host) < (2 if cuda else 1):
                self._cond_host.append((torch.zeros((self._device_batch, n, cc), dtype=dt,
                                                    pin_memory=cuda), None, set()))
            host, uploaded, dirty = self._cond_host.pop(0)
            if uploaded is not None:
                uploaded.synchronize()
            written = set()
            for i, span in host_rows:
                k = span.shape[0]
                span = np.asarray(span, np.float32)
                host[i, :k].copy_(torch.from_numpy(span if span.flags.writeable
                                                   else span.copy()))
                if k < n:
                    host[i, k:].zero_()
                written.add(i)
            for i in dirty - written:   # rows of last use that are idle now
                host[i].zero_()
            if cuda:
                slab = host.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                slab, done = host.clone(), None
            self._cond_host.append((host, done, written))
        else:
            slab = torch.zeros((self._device_batch, n, cc), dtype=dt, device=self.device)
        for k, rows in dev_rows.items():
            idx = self._to_device(np.array([i for i, _ in rows], np.int64))
            slab[idx, :k] = torch.stack([span for _, span in rows]).to(self.device, dt)
        return slab

    def _start_fetch(self, classes: torch.Tensor):
        """Enqueue the device-to-host copy right behind the chunk, into
        pinned memory, so delivery waits for this chunk only."""
        if self.device.type != "cuda":
            return classes, None
        host = torch.empty(classes.shape, dtype=classes.dtype, pin_memory=True)
        host.copy_(classes, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _deliver(self, inflight: tuple) -> Dict[object, tuple]:
        """Fetch a dispatched chunk and slice it per request (chunk mode),
        or gather each completed request's span from the device time ring
        in ONE flat gather (request mode; the ring is read at its current
        state — the submit() bound keeps the in-flight chunk off a
        completed span)."""
        handle, meta = inflight
        if self._acc is not None:
            if not meta:
                return {}
            cap = int(self._acc.shape[1])
            spans = []
            total = 0
            for i, rid, n, _done, start_t in meta:
                spans.append((rid, total, n, i, start_t))
                total += n
            idx = np.zeros(_pow2_bucket(total), np.int64)
            for _rid, off, n, lane, start_t in spans:
                idx[off: off + n] = lane * cap + (start_t + np.arange(n)) % cap
            t0 = time.perf_counter()
            data = self._acc.view(-1)[torch.from_numpy(idx).to(self.device)]
            data = data.cpu().numpy()
            t1 = time.perf_counter()
            out = {
                rid: (data[off: off + n].astype(np.int32), True)
                for rid, off, n, _lane, _t in spans
            }
            self.stats["fetch_s"] += t1 - t0
            self.stats["slice_s"] += time.perf_counter() - t1
            return out
        t0 = time.perf_counter()
        host, done = handle
        if done is not None:
            done.synchronize()
        classes = host.numpy()
        t1 = time.perf_counter()
        out = {
            rid: (classes[i, :n].astype(np.int32), done_)
            for i, rid, n, done_ in meta
        }
        self.stats["fetch_s"] += t1 - t0
        self.stats["slice_s"] += time.perf_counter() - t1
        return out
