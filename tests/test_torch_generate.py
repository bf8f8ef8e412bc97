"""Port tests: the ring-buffer engines (xla, pallas) and fused_stack's plain
version, against the JAX package and against the port's own forward."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu import generate as JG
from lb_wavenet_tpu.models.wavenet import init_params as jinit
from lb_wavenet_tpu.ops.pallas.ar_step import fused_stack as jfused_stack
from lb_wavenet_tpu_torch import generate as PG
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.models.wavenet import forward as pforward
from lb_wavenet_tpu_torch.ops.cuda.ar_step import fused_stack
from lb_wavenet_tpu_torch.utils.convert import params_from_jax

from .util import MICRO

torch.set_num_threads(1)
ATOL = 1e-5   # fp32 MICRO: sums in another order, no rounding to bf16


def _parch(arch, **kw):
    return PArch(**{**dataclasses.asdict(arch), **kw})


@pytest.fixture(scope="module")
def pair():
    jp = jinit(jax.random.key(0), MICRO)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp)), _parch(MICRO)


def _random_ring(arch, b, seed):
    rng = np.random.default_rng(seed)
    bufs = rng.standard_normal((sum(arch.dilations), b, arch.residual_channels))
    emb = rng.standard_normal((arch.input_kernel - 1, b, arch.residual_channels))
    return bufs.astype(np.float32), emb.astype(np.float32)


def test_stack_step_matches_jax(pair):
    jp, pp, parch = pair
    bufs, emb = _random_ring(MICRO, 4, 0)
    x = np.array([3, 128, 255, 0], np.int32)
    for t in (0, 5, 37):
        js = JG.RingState(jnp.asarray(emb), jnp.asarray(bufs), None, None)
        je, jb, jl = JG.stack_step(jp, MICRO, js, jnp.int32(t), jnp.asarray(x))
        ps = PG.RingState(torch.from_numpy(emb), torch.from_numpy(bufs.copy()),
                          None, None)
        pe, pb, pl = PG.stack_step(pp, parch, ps, t, torch.from_numpy(x))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
        np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(pe.numpy(), np.asarray(je))


@pytest.mark.parametrize("t", [0, 6, 1001])
def test_fused_stack_plain_matches_jax(pair, t):
    """fused_stack's plain version (the CPU path of the kernel wrapper)
    against the JAX Pallas kernel in interpret mode: ring and skip."""
    jp, pp, parch = pair
    bufs, _ = _random_ring(MICRO, 5, 1)
    h0 = np.random.default_rng(2).standard_normal((5, 8)).astype(np.float32)
    slots = jnp.asarray(JG.buffer_offsets(MICRO), jnp.int32) + jax.lax.rem(
        jnp.int32(t), jnp.asarray(MICRO.dilations, jnp.int32))
    jb, js = jfused_stack(jp["layers"], MICRO, jnp.asarray(h0), jnp.asarray(bufs),
                          slots, interpret=True)
    ring = torch.from_numpy(bufs.copy())
    pb, ps = fused_stack(pp["layers"], parch, torch.from_numpy(h0), ring, t)
    assert pb is ring  # updated in place
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=ATOL)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_engines_match_jax_forced_and_greedy(pair, engine):
    """Teacher-forced logits (atol 1e-5) and greedy/forced classes (equal)
    against the JAX engine of the same name."""
    jp, pp, parch = pair
    B, T = 3, 40
    forced = np.random.default_rng(3).integers(0, 256, (B, T)).astype(np.int32)
    jc, jl = JG.generate_classes(jp, MICRO, jax.random.key(0), B, T,
                                 forced=jnp.asarray(forced), return_logits=True,
                                 engine=engine)
    pc, pl = PG.generate_classes(pp, parch, 0, B, T, forced=forced,
                                 return_logits=True, engine=engine, device="cpu")
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    half = forced.copy()
    half[:, T // 2:] = -1
    jg = JG.generate_classes(jp, MICRO, jax.random.key(0), B, T, temperature=0.0,
                             forced=jnp.asarray(half), engine=engine)
    pg = PG.generate_classes(pp, parch, 0, B, T, temperature=0.0, forced=half,
                             engine=engine, device="cpu")
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))


def test_stepped_logits_equal_own_forward(pair):
    """train == incremental: the xla engine's teacher-forced logits equal
    the port's forward on the shifted class sequence."""
    _, pp, parch = pair
    B, T = 2, 50
    forced = np.random.default_rng(4).integers(0, 256, (B, T)).astype(np.int32)
    _, pl = PG.generate_classes(pp, parch, 0, B, T, forced=forced,
                                return_logits=True, engine="xla", device="cpu")
    x = np.concatenate([np.full((B, 1), 128, np.int32), forced[:, :-1]], 1)
    fl = pforward(pp, parch, torch.from_numpy(x))
    np.testing.assert_allclose(pl.numpy(), fl.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_naive_sample_equals_xla_engine(pair, temperature):
    _, pp, parch = pair
    B, T = 2, 24
    nc, nl = PG.naive_sample(pp, parch, 5, B, T, temperature=temperature,
                             return_logits=True, device="cpu")
    xc, xl = PG.generate_classes(pp, parch, 5, B, T, temperature=temperature,
                                 return_logits=True, engine="xla", device="cpu")
    np.testing.assert_array_equal(nc.numpy(), xc.numpy())
    np.testing.assert_allclose(nl.numpy(), xl.numpy(), rtol=0, atol=ATOL)


def test_input_kernel_3(pair):
    """K = 3 input conv (a two-row embedding stack) through the xla engine."""
    arch = dataclasses.replace(MICRO, input_kernel=3)
    jp = jinit(jax.random.key(1), arch)
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    forced = np.random.default_rng(5).integers(0, 256, (2, 20)).astype(np.int32)
    _, jl = JG.generate_classes(jp, arch, jax.random.key(0), 2, 20,
                                forced=jnp.asarray(forced), return_logits=True)
    _, pl = PG.generate_classes(pp, _parch(arch), 0, 2, 20, forced=forced,
                                return_logits=True, device="cpu")
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_streaming_and_recycled_lanes(pair, engine):
    """Chunked streaming equals one-shot (same generator stream), and a
    reset lane replays a fresh greedy session."""
    _, pp, parch = pair
    B, T, chunk = 3, 24, 8
    one = PG.generate_classes(pp, parch, 9, B, T, temperature=1.0,
                              engine=engine, device="cpu")
    stream = PG.start_stream(parch, B, 9, engine=engine, device="cpu")
    parts = []
    for _ in range(T // chunk):
        c, stream = PG.stream_chunk(pp, parch, stream, chunk, temperature=1.0,
                                    engine=engine)
        parts.append(c)
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), one.numpy())

    fresh = PG.generate_classes(pp, parch, 0, 1, 16, temperature=0.0,
                                engine=engine, device="cpu")
    stream = PG.start_stream(parch, B, 0, engine=engine, device="cpu")
    _, stream = PG.stream_chunk(pp, parch, stream, 5, temperature=0.0, engine=engine)
    stream = PG.reset_lanes(pp, parch, stream, np.array([False, True, False]),
                            engine=engine)
    c, stream = PG.stream_chunk(pp, parch, stream, 16, temperature=0.0,
                                engine=engine)
    np.testing.assert_array_equal(c[1].numpy(), fresh[0].numpy())
