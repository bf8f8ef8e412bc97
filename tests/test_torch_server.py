"""Port tests: the online HTTP daemon (server.py), the counterparts of
tests/test_server.py: requests served through PoolServer's worker equal
dedicated sessions with the same seed and temperature bit for bit, wav
responses are the decoded classes, argument errors come back as 400s
without stopping the worker. Plus the three faults of the JAX server that
the port does not carry over (a body that is not a JSON object, a
cond_builder raising SystemExit, requests still queued at stop), and the
JAX server and the port's answering the same seeded requests alike."""
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from lb_wavenet_tpu_torch.config import ArchConfig
from lb_wavenet_tpu_torch.generate import start_stream, stream_chunk
from lb_wavenet_tpu_torch.models.wavenet import init_params
from lb_wavenet_tpu_torch.server import PoolServer, make_http_server
from lb_wavenet_tpu_torch.serving import SessionPool

torch.set_num_threads(1)
ARCH = ArchConfig(n_blocks=2, n_layers_per_block=3, residual_channels=16, skip_channels=16,
                  gate_channels=16, compute_dtype="float32")
CHUNK = 16


def _dedicated(params, tau, seed, n, arch=ARCH, cond_full=None):
    stream = start_stream(arch, 1, 5, engine="xla", params=params, device="cpu")
    outs, t = [], 0
    while t < n:
        kw = {}
        if tau > 0:
            kw = dict(lane_seed=torch.tensor([seed], dtype=torch.int32),
                      lane_t0=torch.zeros((1,), dtype=torch.int32))
        if cond_full is not None:
            kw["cond"] = torch.from_numpy(cond_full[None, t: t + CHUNK])
        classes, stream = stream_chunk(params, arch, stream, CHUNK, temperature=tau,
                                       engine="xla", **kw)
        outs.append(classes[0].numpy())
        t += CHUNK
    return np.concatenate(outs)[:n]


def _serve(params, batch=3, arch=ARCH, cond_builder=None, pool=None):
    pool = pool or SessionPool(params, arch, batch, 0, engine="xla", chunk_size=CHUNK,
                               temperature=1.0, pipeline=True, device="cpu")
    ps = PoolServer(pool)
    ps.start()
    httpd = make_http_server(ps, arch, port=0, cond_builder=cond_builder,
                             request_timeout=120.0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    host, port = httpd.server_address
    return ps, httpd, f"http://{host}:{port}"


def _close(ps, httpd):
    httpd.shutdown()
    httpd.server_close()
    ps.stop()


def _post(url, payload, raw=False):
    body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url + "/synthesize", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        body = r.read()
        return body if raw else json.loads(body)


def _status(url, payload) -> int:
    try:
        _post(url, payload)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def _concurrent(url, specs):
    out = [None] * len(specs)

    def go(i):
        out[i] = _post(url, specs[i])

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(specs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    return out


SPECS = [{"n_samples": 3 * CHUNK, "seed": 101, "format": "classes"},
         {"n_samples": 3 * CHUNK - 5, "seed": 202, "temperature": 0.7, "format": "classes"},
         {"n_samples": 3 * CHUNK, "temperature": 0.0, "format": "classes"}]


@pytest.fixture(scope="module")
def params():
    return init_params(0, ARCH)


def test_http_requests_bit_match_dedicated_sessions(params):
    """Three CONCURRENT requests (one greedy) batch through one pool; each
    equals its dedicated session bit for bit, in fewer steps than serial
    service."""
    ps, httpd, url = _serve(params)
    try:
        out = _concurrent(url, SPECS)
        for spec, res in zip(SPECS, out):
            assert res is not None
            got = np.asarray(res["classes"], np.int32)
            assert got.shape == (spec["n_samples"],)
            tau = spec.get("temperature", 1.0)
            np.testing.assert_array_equal(
                got, _dedicated(params, tau, spec.get("seed", 0), spec["n_samples"]))
        assert ps.pool.stats["steps"] <= 8
    finally:
        _close(ps, httpd)


def test_http_wav_healthz_and_errors(params):
    ps, httpd, url = _serve(params, batch=2)
    try:
        n = CHUNK + 3
        body = _post(url, {"n_samples": n, "seed": 7}, raw=True)
        assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
        assert len(body) == 44 + 2 * n
        classes = np.asarray(_post(url, {"n_samples": n, "seed": 7, "format": "classes"})
                             ["classes"], np.int32)
        from lb_wavenet_tpu_torch.ops.mulaw import mu_law_decode

        lut = mu_law_decode(torch.arange(ARCH.quant_channels), ARCH.quant_channels).numpy()
        want = (np.clip(lut[classes], -1, 1) * 32767.0).astype(np.int16)
        np.testing.assert_array_equal(np.frombuffer(body[44:], np.int16), want)
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["ok"] and h["free_lanes"] == 2 and h["steps"] >= 1
        for bad in ({"n_samples": -4}, {"n_samples": 8, "mel_path": "x"}, {},
                    {"n_samples": 4, "seed": "x"}):
            assert _status(url, bad) == 400, bad
        assert len(_post(url, {"n_samples": 5, "seed": 1, "format": "classes"})
                   ["classes"]) == 5
    finally:
        _close(ps, httpd)


MEL_ARCH = ArchConfig(n_blocks=1, n_layers_per_block=3, residual_channels=8, skip_channels=8,
                      gate_channels=8, n_mels=6, cond_channels=4, upsample_factors=(2, 4),
                      compute_dtype="float32")


def _mel_case():
    params = init_params(0, MEL_ARCH)
    cond_full = np.random.default_rng(3).standard_normal(
        (2 * CHUNK, MEL_ARCH.cond_channels)).astype(np.float32)

    def cond_builder(mel_path, n_samples):
        if mel_path == "exit.npy":   # the CLI's mel checks raise SystemExit
            raise SystemExit(f"mel {mel_path} has the wrong shape")
        assert mel_path == "synthetic.npy"
        return lambda t_local, m: cond_full[t_local: t_local + m]

    return params, cond_full, cond_builder


def test_http_mel_conditioned_daemon():
    """`mel_path` routes through the injected cond_builder; the output
    equals a dedicated conditioned session."""
    params, cond_full, cond_builder = _mel_case()
    pool = SessionPool(params, MEL_ARCH, 2, 0, engine="xla", chunk_size=CHUNK,
                       temperature=1.0, pipeline=True, device="cpu")
    ps, httpd, url = _serve(params, arch=MEL_ARCH, cond_builder=cond_builder, pool=pool)
    try:
        out = _post(url, {"n_samples": 2 * CHUNK, "seed": 77, "mel_path": "synthetic.npy",
                          "format": "classes"})
        np.testing.assert_array_equal(
            np.asarray(out["classes"], np.int32),
            _dedicated(params, 1.0, 77, 2 * CHUNK, MEL_ARCH, cond_full))
        assert _status(url, {"n_samples": 8}) == 400
    finally:
        _close(ps, httpd)


def test_cond_builder_system_exit_is_a_400_and_the_server_goes_on():
    """A cond_builder raising SystemExit answers that request 400; the next
    request is served (JAX catches only Exception)."""
    params, _, cond_builder = _mel_case()
    pool = SessionPool(params, MEL_ARCH, 2, 0, engine="xla", chunk_size=CHUNK,
                       temperature=1.0, device="cpu")
    ps, httpd, url = _serve(params, arch=MEL_ARCH, cond_builder=cond_builder, pool=pool)
    try:
        assert _status(url, {"n_samples": 8, "mel_path": "exit.npy"}) == 400
        out = _post(url, {"n_samples": 8, "seed": 3, "mel_path": "synthetic.npy",
                          "format": "classes"})
        assert len(out["classes"]) == 8
    finally:
        _close(ps, httpd)


def test_non_object_body_is_a_400(params):
    """A JSON body that is not an object (JAX: TypeError outside the
    handler's except) answers 400, and the server goes on."""
    ps, httpd, url = _serve(params, batch=2)
    try:
        for body in (b"[1, 2]", b'"text"', b"7", b"null", b"{not json"):
            assert _status(url, body) == 400, body
        assert len(_post(url, {"n_samples": 4, "seed": 2, "format": "classes"})
                   ["classes"]) == 4
    finally:
        _close(ps, httpd)


class _GatedPool:
    """A pool whose step() waits for a gate: the worker stays busy while
    requests pile up in the submit queue."""

    def __init__(self, pool):
        self._pool, self.gate, self.stepping = pool, threading.Event(), threading.Event()

    def __getattr__(self, name):
        return getattr(self._pool, name)

    def step(self):
        self.stepping.set()
        self.gate.wait(timeout=60)
        return self._pool.step()


def test_stop_errors_out_queued_requests(params):
    """stop() errors out every unfinished request, those still in the
    submit queue included (JAX leaves them waiting), and refuses later
    submits."""
    gated = _GatedPool(SessionPool(params, ARCH, 1, 0, engine="xla", chunk_size=CHUNK,
                                   temperature=1.0, device="cpu"))
    ps = PoolServer(gated)
    ps.start()
    first = ps.submit(4 * CHUNK, seed=1)
    assert gated.stepping.wait(timeout=60)
    queued = [ps.submit(CHUNK, seed=2), ps.submit(CHUNK, seed=3)]
    stopper = threading.Thread(target=ps.stop)
    stopper.start()
    time.sleep(0.2)
    gated.gate.set()
    stopper.join(timeout=60)
    for p in [first] + queued:
        assert p.done.wait(timeout=5) and p.error == "server shutting down"
    late = ps.submit(CHUNK)
    assert late.done.is_set() and late.error == "server shutting down"
    assert not ps._thread.is_alive()


class _FailingPool(_GatedPool):
    def step(self):
        raise RuntimeError("device lost")


def test_worker_failure_errors_out_requests(params):
    """A pool step that raises stops the worker: the leased request and
    every later one get the error, and /healthz reports it."""
    pool = _FailingPool(SessionPool(params, ARCH, 2, 0, engine="xla", chunk_size=CHUNK,
                                    temperature=1.0, device="cpu"))
    ps, httpd, url = _serve(params, pool=pool)
    try:
        assert _status(url, {"n_samples": 8, "seed": 1}) == 400
        assert _status(url, {"n_samples": 8, "seed": 2}) == 400
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert not h["ok"] and "device lost" in h["error"]
    finally:
        _close(ps, httpd)


def test_daemon_thread_hygiene_sequential_requests(params):
    """Sequential requests leak no handler threads, and the worker parks
    when idle."""
    ps, httpd, url = _serve(params, batch=2)
    try:
        for i in range(100):
            assert len(_post(url, {"n_samples": 5, "seed": i, "format": "classes"})
                       ["classes"]) == 5
        time.sleep(0.5)
        assert threading.active_count() < 20
        steps = ps.pool.stats["steps"]
        time.sleep(0.3)
        assert ps.pool.stats["steps"] == steps
    finally:
        _close(ps, httpd)


def test_jax_and_port_servers_answer_alike():
    """The JAX server and the port's, from the same converted params, answer
    the same seeded requests at temperatures 0, 0.7 and 1.0 with the same
    classes (the per-lane hash is bit-exact across the frameworks)."""
    from lb_wavenet_tpu.config import ArchConfig as JArch
    from lb_wavenet_tpu.models.wavenet import init_params as jinit
    from lb_wavenet_tpu.server import PoolServer as JServer
    from lb_wavenet_tpu.server import make_http_server as jmake
    from lb_wavenet_tpu.serving import SessionPool as JPool
    from lb_wavenet_tpu_torch.utils.convert import params_from_jax

    jarch = JArch(**dataclasses.asdict(ARCH))
    jp = jinit(jax.random.key(0), jarch)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    jpool = JPool(jp, jarch, 3, jax.random.key(0), engine="xla", chunk_size=CHUNK,
                  temperature=1.0, pipeline=True)
    js = JServer(jpool)
    js.start()
    jhttpd = jmake(js, jarch, port=0, request_timeout=120.0)
    threading.Thread(target=jhttpd.serve_forever, daemon=True).start()
    jurl = "http://%s:%d" % jhttpd.server_address
    ps, httpd, url = _serve(params)
    try:
        want, got = _concurrent(jurl, SPECS), _concurrent(url, SPECS)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(g["classes"]), np.asarray(w["classes"]))
    finally:
        _close(ps, httpd)
        _close(js, jhttpd)
