"""Port tests: parameter conversion, the teacher-forced forward, and the
per-lane counter hash, each against the JAX package on the same inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu import generate as JG
from lb_wavenet_tpu.models.wavenet import forward as jforward
from lb_wavenet_tpu.models.wavenet import init_params as jinit
from lb_wavenet_tpu_torch import generate as PG
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.models.wavenet import forward as pforward
from lb_wavenet_tpu_torch.models.wavenet import init_params as pinit
from lb_wavenet_tpu_torch.ops.cuda import ar_mega
from lb_wavenet_tpu_torch.utils.convert import params_from_jax, params_to_numpy

from .util import MICRO, TINY

torch.set_num_threads(1)


def _pair(arch, seed=0):
    jp = jinit(jax.random.key(seed), arch)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _parch(arch, **kw):
    """The port's ArchConfig with the same fields as a JAX one."""
    import dataclasses

    return PArch(**{**dataclasses.asdict(arch), **kw})


def test_convert_round_trip():
    jp, pp = _pair(TINY)
    back = params_to_numpy(pp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree.leaves(back))
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert pp["layers"]["w_cur"].dtype == torch.float32
    # The port's own init has the same tree and shapes.
    own = pinit(0, _parch(TINY))
    assert jax.tree.map(np.shape, params_to_numpy(own)) == jax.tree.map(
        np.shape, back)


@pytest.mark.parametrize("arch,dtype,atol", [
    (TINY, "float32", 1e-5),
    (MICRO, "float32", 1e-5),
    # bf16 operands: an fp32 ulp of difference can flip one activation's
    # bf16 rounding, which moves a logit by ~1e-3 of its size.
    (TINY, "bfloat16", 2e-2),
])
def test_forward_matches_jax(arch, dtype, atol):
    import dataclasses

    arch = dataclasses.replace(arch, compute_dtype=dtype)
    jp, pp = _pair(arch, seed=1)
    x = np.random.default_rng(0).integers(0, 256, (3, 70)).astype(np.int32)
    lj = np.asarray(jforward(jp, arch, jnp.asarray(x)))
    lt = pforward(pp, _parch(arch), torch.from_numpy(x)).numpy()
    assert lt.shape == lj.shape == (3, 70, 256)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=atol)
    sj = np.asarray(jforward(jp, arch, jnp.asarray(x), return_skip=True))
    st = pforward(pp, _parch(arch), torch.from_numpy(x), return_skip=True).numpy()
    np.testing.assert_allclose(st, sj, rtol=0, atol=atol)


SEEDS = np.array([0, 1, 12345, 2**30 - 1, 2**31 - 2, 2**31 - 1, -1, -(2**31)],
                 np.int32)


def test_perlane_hash_bits_exact():
    """The uint32 hash bits equal JAX's for seeds near 2^31 and negative
    lease offsets; the float stage is within an ulp of XLA's float32 log."""
    t_local = np.array([0, 1, 7, 1023, 2**20, 5, -3, 99], np.int32)
    q = 256
    s = jnp.asarray(SEEDS).astype(jnp.uint32)[:, None]
    tl = jnp.asarray(t_local).astype(jnp.uint32)[:, None]
    qi = jax.lax.broadcasted_iota(jnp.uint32, (len(SEEDS), q), 1)
    bits_j = np.asarray(JG._perlane_mix(
        s + tl * jnp.uint32(JG._PL_T) + qi * jnp.uint32(JG._PL_Q)
    )).astype(np.int64)
    lane = torch.from_numpy(np.stack([SEEDS, -t_local]))
    bits_p = ar_mega._perlane_bits(q, lane, 0).t().numpy()   # (B, Q)
    np.testing.assert_array_equal(bits_p, bits_j)
    # The port's batch-major perlane_gumbel uses the same bits.
    g_j = np.asarray(JG.perlane_gumbel(jnp.asarray(SEEDS), jnp.asarray(t_local), q))
    g_p = PG.perlane_gumbel(torch.from_numpy(SEEDS), torch.from_numpy(t_local), q).numpy()
    np.testing.assert_array_equal(
        g_p, ar_mega.gumbel_from_bits(torch.from_numpy(bits_j)).numpy())
    # XLA's float32 log is not correctly rounded (measured: 14% of inputs
    # an ulp off); the port takes each log in float64 and rounds.
    np.testing.assert_allclose(g_p, g_j, rtol=2e-6, atol=2e-6)
    # _perlane_mix itself, on raw values across the uint32 range.
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF], np.uint32)
    np.testing.assert_array_equal(
        PG._perlane_mix(torch.from_numpy(x.astype(np.int64))).numpy(),
        np.asarray(JG._perlane_mix(jnp.asarray(x))).astype(np.int64),
    )


@pytest.mark.parametrize("seed_base", [0, 7, 2**30 - 1, 2**31 - 1, -5])
def test_derive_lane_seeds_exact(seed_base):
    j = np.asarray(JG.derive_lane_seeds(jnp.int32(seed_base), 300))
    p = PG.derive_lane_seeds(seed_base, 300).numpy()
    np.testing.assert_array_equal(p, j)
    assert p.dtype == np.int32 and (p >= 0).all()


def test_global_rng_bits_exact():
    """The batch-wide counter hash (global_rng) equals the JAX kernel's CPU
    branch (_gumbel_bits with use_hw_prng=False)."""
    from lb_wavenet_tpu.ops.pallas.ar_mega import _gumbel_bits as jbits

    for seed in (0, 12345, 2**30 + 17):
        j = np.asarray(jbits(256, 24, jnp.int32(seed), False)).astype(np.int64)
        p = ar_mega._gumbel_bits(256, 24, seed, "cpu").numpy()
        np.testing.assert_array_equal(p, j)


def test_pack_lane_matches_jax():
    seeds = np.array([3, 2**31 - 1, 0], np.int32)
    t0 = np.array([0, 1024, 77], np.int32)
    inv = np.array([0.0, 1 / 0.7, 1.0], np.float32)
    j = np.asarray(JG._pack_lane(jnp.asarray(seeds), jnp.asarray(t0), jnp.asarray(inv)))
    p = PG._pack_lane(torch.from_numpy(seeds), torch.from_numpy(t0),
                      torch.from_numpy(inv)).numpy()
    np.testing.assert_array_equal(p, j)
    assert PG._pack_lane(None, None) is None
