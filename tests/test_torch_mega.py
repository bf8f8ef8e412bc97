"""Port tests: mega_generate's plain version (the CPU path of the kernel
wrapper) against the JAX mega kernel in interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu import generate as JG
from lb_wavenet_tpu.models.wavenet import init_params as jinit
from lb_wavenet_tpu.ops.pallas import ar_mega as JM
from lb_wavenet_tpu_torch import generate as PG
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.ops.cuda import ar_mega as PM
from lb_wavenet_tpu_torch.utils.convert import params_from_jax

from .util import MICRO

torch.set_num_threads(1)
LOGIT_ATOL = 2e-5   # fp32 MICRO over tens of steps: reordered fp32 sums


def _parch(arch, **kw):
    return PArch(**{**dataclasses.asdict(arch), **kw})


@pytest.fixture(scope="module")
def pair():
    jp = jinit(jax.random.key(0), MICRO)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp)), _parch(MICRO)


def test_teacher_forced_logits_and_classes(pair):
    jp, pp, parch = pair
    B, T = 8, 32
    forced = np.random.default_rng(0).integers(0, 256, (B, T)).astype(np.int32)
    jc, jl = JG.generate_classes(jp, MICRO, jax.random.key(0), B, T,
                                 forced=jnp.asarray(forced), return_logits=True,
                                 engine="mega")
    pc, pl = PG.generate_classes(pp, parch, 0, B, T, forced=forced,
                                 return_logits=True, engine="mega", device="cpu")
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    half = forced.copy()
    half[:, 10:] = -1
    jg = JG.generate_classes(jp, MICRO, jax.random.key(0), B, T, temperature=0.0,
                             forced=jnp.asarray(half), engine="mega")
    pg = PG.generate_classes(pp, parch, 0, B, T, temperature=0.0, forced=half,
                             engine="mega", device="cpu")
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))


def _lane(b, rows):
    rng = np.random.default_rng(rows)
    seeds = rng.integers(0, 2**31 - 1, b).astype(np.int32)
    t0 = rng.integers(-5, 5, b).astype(np.int32)
    lane = [seeds, t0]
    if rows == 3:
        inv = np.float32(1.0) / np.array([0.7, 1.0, 2.0, 0.5] * b, np.float32)[:b]
        inv[::3] = 0.0   # greedy lanes
        lane.append(inv.astype(np.float32).view(np.int32))
    return np.stack(lane)


@pytest.mark.parametrize("rows,temperature", [
    (None, 0.0),   # greedy
    (2, 1.0),      # per-lane hash
    (2, 0.7),      # per-lane hash, static 1/tau
    (3, 1.0),      # per-lane inverse temperatures, greedy lanes included
    (None, 0.9),   # global_rng: the batch-wide counter hash
])
def test_sampled_classes_equal_jax(pair, rows, temperature):
    jp, pp, parch = pair
    B, T = 6, 40
    h0, e0 = JG._fused_frontend_zero(jp, MICRO, B)
    ph0, pe0 = PG._fused_frontend_zero(pp, parch, B)
    forced = np.full((T, 1, B), -1, np.int32)
    forced[:3, 0, 1] = 7
    lane = None if rows is None else _lane(B, rows)
    jo = JM.mega_generate(
        jp, jp["layers"], MICRO, h0, e0, jnp.int32(99), jnp.asarray(forced), None,
        T, temperature, False, interpret=True,
        lane=None if lane is None else jnp.asarray(lane))
    po = PM.mega_generate(
        pp, pp["layers"], parch, ph0, pe0, 99, torch.from_numpy(forced), None,
        T, temperature, False, lane=None if lane is None else torch.from_numpy(lane))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    assert po.shape == (T, 1, B) and po.dtype == torch.int32


def test_streaming_equals_one_shot_and_carry_equals_jax(pair):
    """Chunked streaming (explicit lane block at absolute time) equals the
    one-shot run; after every chunk the carry dict equals JAX's; a reset
    equals JAX's reset."""
    jp, pp, parch = pair
    B, chunk, n = 8, 12, 3
    lane = _lane(B, 3)
    seeds, t0 = lane[0], lane[1]
    inv = lane[2].view(np.float32)
    js = JG.start_stream(MICRO, B, jax.random.key(0), engine="mega", params=jp)
    ps = PG.start_stream(parch, B, 0, engine="mega", params=pp, device="cpu")
    parts = []
    for i in range(n):
        if i == 2:
            mask = np.array([True, False] * (B // 2))
            js = JG.reset_lanes(jp, MICRO, js, jnp.asarray(mask), engine="mega")
            ps = PG.reset_lanes(pp, parch, ps, mask, engine="mega")
        kw = dict(temperature=1.0, engine="mega")
        jc, js = JG.stream_chunk(
            jp, MICRO, js, chunk, lane_seed=jnp.asarray(seeds),
            lane_t0=jnp.asarray(t0), lane_inv_temp=jnp.asarray(inv), **kw)
        pc, ps = PG.stream_chunk(
            pp, parch, ps, chunk, lane_seed=seeds, lane_t0=t0,
            lane_inv_temp=inv, **kw)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        for k, v in js.state["carry"].items():
            np.testing.assert_allclose(ps.state["carry"][k].numpy(), np.asarray(v),
                                       rtol=0, atol=1e-5, err_msg=k)
        assert ps.t == int(js.t)
        parts.append(pc)
    # One-shot over the first two chunks equals the chunked run.
    h0, e0 = PG._fused_frontend_zero(pp, parch, B)
    one = PM.mega_generate(
        pp, pp["layers"], parch, h0, e0, 0,
        torch.full((2 * chunk, 1, B), -1, dtype=torch.int32), None, 2 * chunk,
        1.0, False, lane=torch.from_numpy(lane))
    np.testing.assert_array_equal(one[:, 0, :].t().numpy(),
                                  torch.cat(parts[:2], 1).numpy())


def test_odd_batch_is_padded_to_the_lane_tile(pair):
    """B=5 pads to the kernel's lane tile: the real lanes equal JAX's
    unpadded run and the port's own run at a tile-multiple batch."""
    jp, pp, parch = pair
    T = 20
    assert PG.padded_stream_batch(5, "mega") == PM.LANE_TILE
    assert PG.padded_stream_batch(5, "xla") == 5
    forced = np.full((PM.LANE_TILE, T), -1, np.int32)
    forced[:, :4] = np.arange(4 * PM.LANE_TILE).reshape(PM.LANE_TILE, 4)
    jg = JG.generate_classes(jp, MICRO, jax.random.key(0), 5, T, temperature=0.0,
                             forced=jnp.asarray(forced[:5]), engine="mega")
    pg = PG.generate_classes(pp, parch, 0, 5, T, temperature=0.0,
                             forced=forced[:5], engine="mega", device="cpu")
    full = PG.generate_classes(pp, parch, 0, PM.LANE_TILE, T, temperature=0.0,
                               forced=forced, engine="mega", device="cpu")
    assert pg.shape == (5, T)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(pg.numpy(), full[:5].numpy())
    s = PG.start_stream(parch, 5, 0, engine="mega", params=pp, device="cpu")
    with pytest.raises(ValueError, match="batch %"):
        PG.stream_chunk(pp, parch, s, 4, engine="mega")


def test_bf16_teacher_forced_logits():
    """bf16 compute: the same bf16-rounded operands, fp32 sums in another
    order; an ulp of difference can flip one activation's rounding, which
    moves a logit by ~1e-3 of its size."""
    arch = dataclasses.replace(MICRO, compute_dtype="bfloat16")
    jp = jinit(jax.random.key(2), arch)
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    B, T = 8, 24
    forced = np.random.default_rng(1).integers(0, 256, (B, T)).astype(np.int32)
    _, jl = JG.generate_classes(jp, arch, jax.random.key(0), B, T,
                                forced=jnp.asarray(forced), return_logits=True,
                                engine="mega")
    _, pl = PG.generate_classes(pp, _parch(arch), 0, B, T, forced=forced,
                                return_logits=True, engine="mega", device="cpu")
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=2e-2)


def test_prepared_weights_reused_until_written():
    """The wrappers' weight cache: one make() per unchanged weight set; an
    in-place write or another tensor makes it anew."""
    from lb_wavenet_tpu_torch.ops.cuda import build

    w = torch.ones(4, 3)
    made = []

    def make():
        made.append(1)
        return w.to(torch.bfloat16)

    first = build.prepared("test", (w,), make)
    assert build.prepared("test", (w,), make) is first and len(made) == 1
    w.mul_(2.0)
    again = build.prepared("test", (w,), make)
    assert len(made) == 2 and float(again[0, 0]) == 2.0
    build.prepared("test", (w.clone(),), make)
    assert len(made) == 3
