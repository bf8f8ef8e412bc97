"""Online HTTP serving: a SessionPool behind one stepping thread (port of
`lb_wavenet_tpu/server.py`).

`cli serve --listen HOST:PORT` puts the continuous-batching pool
(serving.SessionPool, in-process or over a frozen artifact) behind HTTP:

  * ONE worker thread owns the pool (SessionPool is not thread-safe) and
    the card: it sets the pool's device in the thread, drains a submit
    queue into free lanes, steps the pool while any lane is leased, fans
    completed chunks out to per-request buffers, and parks on a condition
    variable when idle. What it hands a handler is host numpy data, taken
    after the pool's device-to-host copy has completed: no CUDA tensor
    crosses to a handler thread.
  * HTTP handlers (ThreadingHTTPServer, one thread per connection) only
    enqueue and wait on a per-request Event, so slow clients never stall
    the stepping loop, and concurrent requests batch into the same
    fixed-shape device step.

API (JSON in, wav or JSON out):

  POST /synthesize  {"n_samples": 16000, "seed": 7, "temperature": 0.8,
                     "speaker": 3, "format": "wav"|"classes"}
      -> audio/wav bytes (16-bit PCM at arch.sample_rate), or
         {"classes": [...], "request_id": ...} when format == "classes".
      A request with an explicit seed replays bit for bit on a dedicated
      session (the pool's per-lane contract).
  GET /healthz  -> {"ok": true, "free_lanes": N, "pending": M, ...}

Mel-conditioned archs take "mel_path": a server-local (F, n_mels) .npy; the
CLI injects the upsampling callback (`cond_builder`).

Three divergences from the JAX server, each a fault there:
  * a body that is not a JSON object is answered 400 (JAX raises TypeError
    outside its handler's except);
  * a `cond_builder` that raises anything, SystemExit included (the CLI's
    mel checks raise SystemExit), gives that request a 400 and the server
    goes on (JAX catches only Exception, and the handler thread dies);
  * `stop` errors out every unfinished request, the ones still in the
    submit queue included (JAX leaves those waiting until their timeout).
"""
from __future__ import annotations

import collections
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from .config import ArchConfig


class _Pending:
    """Worker-side state of one in-flight online request."""

    __slots__ = ("rid", "kwargs", "parts", "done", "error", "n_samples")

    def __init__(self, rid: str, n_samples: int, kwargs: dict):
        self.rid = rid
        self.n_samples = n_samples
        self.kwargs = kwargs
        self.parts: list = []
        self.done = threading.Event()
        self.error: Optional[str] = None


class PoolServer:
    """Owns the stepping thread; submit() is safe from any thread."""

    def __init__(self, pool):
        self.pool = pool
        # The card the worker thread drives: the pool's device, its index
        # resolved here (a bare "cuda" means this thread's current card).
        dev = getattr(pool, "device", None)
        self._card = None
        if dev is not None and dev.type == "cuda":
            import torch

            self._card = dev.index if dev.index is not None else torch.cuda.current_device()
        self._lock = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._stop = False
        self._failed: Optional[str] = None   # why the worker stopped, if it failed
        self._n_submitted = 0
        self._inflight = 0  # queued + leased, for /healthz
        self._thread = threading.Thread(target=self._run, name="wavenet-pool", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            self._lock.notify()
        self._thread.join(timeout=60)

    def submit(self, n_samples: int, speaker: Optional[int] = None,
               cond_fn: Optional[Callable] = None, seed: Optional[int] = None,
               temperature: Optional[float] = None) -> _Pending:
        """Enqueue a request; wait on the returned object's .done Event.
        Argument errors surface on the waiter (`.error`), raised by the
        pool's own submit-time validation on the worker thread."""
        with self._lock:
            self._n_submitted += 1
            p = _Pending(f"http-{self._n_submitted}", n_samples, dict(
                speaker=speaker, cond_fn=cond_fn, seed=seed, temperature=temperature))
            if self._stop or self._failed:
                p.error = self._failed or "server shutting down"
                p.done.set()
                return p
            self._queue.append(p)
            self._inflight += 1
            self._lock.notify()
        return p

    # -- worker thread --------------------------------------------------

    def _run(self) -> None:
        leased: dict = {}  # rid -> _Pending
        waiting: collections.deque = collections.deque()
        try:
            if self._card is not None:
                import torch

                torch.cuda.set_device(self._card)
            self._serve(leased, waiting)
        except Exception as e:  # noqa: BLE001 (every waiter learns why)
            with self._lock:
                self._failed = f"server failed: {type(e).__name__}: {e}"
                for p in list(waiting) + list(leased.values()) + list(self._queue):
                    p.error = self._failed
                    p.done.set()
                self._queue.clear()
                self._inflight = 0
            import traceback

            traceback.print_exc()

    def _serve(self, leased: dict, waiting: collections.deque) -> None:
        while True:
            with self._lock:
                while (not self._stop and not self._queue and not waiting
                       and not leased and not self.pool.active):
                    self._lock.wait()
                if self._stop:
                    for p in list(waiting) + list(leased.values()) + list(self._queue):
                        p.error = "server shutting down"
                        p.done.set()
                    self._queue.clear()
                    self._inflight = 0
                    return
                while self._queue:
                    waiting.append(self._queue.popleft())
            # Lease as many waiting requests as there are free lanes. A
            # request the pool rejects (bad arguments) errors out its waiter
            # without touching the stepping loop.
            while waiting:
                p = waiting[0]
                try:
                    ok = self.pool.submit(p.rid, p.n_samples, **p.kwargs)
                except Exception as e:  # noqa: BLE001 (surfaced to the client)
                    waiting.popleft()
                    with self._lock:
                        self._inflight -= 1
                    p.error = str(e)
                    p.done.set()
                    continue
                if not ok:
                    break  # pool full; retry after the next step
                waiting.popleft()
                leased[p.rid] = p
            if leased or self.pool.active:
                for rid, (classes, done) in self.pool.step().items():
                    p = leased.get(rid)
                    if p is None:
                        continue
                    p.parts.append(classes)   # host numpy, copied off the card
                    if done:
                        del leased[rid]
                        with self._lock:
                            self._inflight -= 1
                        p.done.set()

    def healthz(self) -> dict:
        nst = max(self.pool.stats["steps"], 1)
        return {
            "ok": self._failed is None,
            **({"error": self._failed} if self._failed else {}),
            "free_lanes": self.pool.free_lanes(),
            "pending": self._inflight,
            "engine": self.pool.engine,
            "batch": self.pool.batch,
            "chunk": self.pool.chunk_size,
            "steps": self.pool.stats["steps"],
            "phase_ms_per_step": {
                k[:-2]: round(1000.0 * v / nst, 2)
                for k, v in self.pool.stats.items() if k.endswith("_s")
            },
            # This process's launches of the sampling kernels (their
            # wrappers' counters): which kernels served the traffic.
            "kernel_launches": kernel_launches(),
        }


def kernel_launches() -> dict:
    """The sampling kernels' launch counters of this process."""
    from .ops.cuda import ar_mega, ar_step, ar_tp, ar_turbo

    return {"mega_generate": ar_mega.mega_generate.launches,
            "turbo_step": ar_turbo.turbo_step.launches,
            "fused_stack": ar_step.fused_stack.launches,
            "tp_fused_stack": ar_tp.tp_fused_stack.launches}


def make_http_server(
    pool_server: PoolServer,
    arch: ArchConfig,
    host: str = "127.0.0.1",
    port: int = 0,
    cond_builder: Optional[Callable] = None,  # (mel_path, n) -> cond_fn
    request_timeout: float = 600.0,
) -> ThreadingHTTPServer:
    """Build the HTTP front end (call .serve_forever(); port 0 = ephemeral,
    read the bound port from .server_address)."""
    import torch

    from .ops.mulaw import mu_law_decode

    q = arch.quant_channels
    lut = mu_law_decode(torch.arange(q), q).numpy().astype(np.float32)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; stdout is for JSONL
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            return self._json(200, pool_server.healthz())

        def do_POST(self):
            if self.path != "/synthesize":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError(f"the body must be a JSON object, not "
                                     f"{type(req).__name__}")
                n_samples = int(req["n_samples"])
                seed = None if req.get("seed") is None else int(req["seed"])
                temperature = (None if req.get("temperature") is None
                               else float(req["temperature"]))
                speaker = None if req.get("speaker") is None else int(req["speaker"])
            except (KeyError, ValueError, TypeError) as e:
                return self._json(400, {"error": f"bad request: {e}"})
            cond_fn = None
            if arch.use_local_cond:
                if "mel_path" not in req:
                    return self._json(400, {
                        "error": 'mel-conditioned arch: pass "mel_path" '
                        "(server-local (F, n_mels) .npy)"})
                try:
                    cond_fn = cond_builder(str(req["mel_path"]), n_samples)
                except (Exception, SystemExit) as e:  # noqa: BLE001 (the CLI's checks exit)
                    return self._json(400, {"error": str(e) or type(e).__name__})
            elif "mel_path" in req:
                return self._json(400, {"error": "arch is not mel-conditioned"})
            p = pool_server.submit(n_samples, speaker=speaker, cond_fn=cond_fn, seed=seed,
                                   temperature=temperature)
            if not p.done.wait(timeout=request_timeout):
                return self._json(504, {"error": "synthesis timed out"})
            if p.error is not None:
                return self._json(400, {"error": p.error})
            classes = np.concatenate(p.parts)
            if req.get("format") == "classes":
                return self._json(200, {"classes": classes.tolist(), "request_id": p.rid})
            from scipy.io import wavfile

            wav = np.clip(lut[classes], -1.0, 1.0)
            buf = io.BytesIO()
            wavfile.write(buf, arch.sample_rate, (wav * 32767.0).astype(np.int16))
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Request-Id", p.rid)
            self.end_headers()
            self.wfile.write(body)

    class Server(ThreadingHTTPServer):
        # A pool-sized burst of clients connects and then waits for
        # synthesis; the stdlib listen backlog (5) would reset the burst's
        # tail. Handler threads are daemons: a hung client never blocks exit.
        request_queue_size = 1024
        daemon_threads = True

    return Server((host, port), Handler)
