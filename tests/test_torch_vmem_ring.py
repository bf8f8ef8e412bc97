"""Port tests: WAVENET_MEGA_VMEM_D, mega's on-chip ring layout (the JAX
kernel's `vmem_dmax`). The variable is read where JAX reads it, in
generate_classes, and changes one-shot mega only; the on-chip rings hold
the same fp32 rows as the HBM ring, so every output equals D = 1 bit for
bit. On the CPU the kernel's plain version runs (it takes D and ignores
it); on the card chip_smoke.py's `mega_vmem` phase holds both CUDA routes
at D = 2, 4 and 8 against D = 1."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu.generate import generate_classes as jgen
from lb_wavenet_tpu.models.wavenet import init_params as jinit
from lb_wavenet_tpu_torch import generate as PG
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.ops.cuda import ar_mega
from lb_wavenet_tpu_torch.utils.convert import params_from_jax

from .util import MICRO

torch.set_num_threads(1)
B, T = 8, 24


@pytest.fixture(scope="module")
def pair():
    jp = jinit(jax.random.key(0), MICRO)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp)), \
        PArch(**dataclasses.asdict(MICRO))


def _forced():
    """(B, T): an 8-step forced prefix, then free-running."""
    rng = np.random.default_rng(6)
    return np.concatenate([rng.integers(0, 256, (B, 8)),
                           np.full((B, T - 8), -1)], 1).astype(np.int32)


def _port(params, arch, engine, **kw):
    return PG.generate_classes(params, arch, 5, B, T, forced=torch.from_numpy(_forced()),
                               temperature=0.0, engine=engine, device="cpu", **kw).numpy()


def test_one_shot_mega_at_d4_matches_jax(pair, monkeypatch):
    """D = 4 (the rings of d = 2 and 4 on chip): the port's one-shot mega
    equals JAX's under the same variable (interpret mode) class for class,
    and the port at D = 1."""
    jp, params, arch = pair
    want_d1 = _port(params, arch, "mega")
    monkeypatch.setenv("WAVENET_MEGA_VMEM_D", "4")
    want = np.asarray(jgen(jp, MICRO, jax.random.key(5), B, T, forced=jnp.asarray(_forced()),
                           temperature=0.0, engine="mega"))
    got = _port(params, arch, "mega")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_d1)


@pytest.mark.parametrize("engine", ["xla", "turbo", "pallas"])
def test_other_engines_ignore_the_variable(pair, monkeypatch, engine):
    """xla, turbo and pallas run with the variable set (the port used to
    refuse) and give their D = 1 output."""
    _, params, arch = pair
    want = _port(params, arch, engine)
    monkeypatch.setenv("WAVENET_MEGA_VMEM_D", "8")
    np.testing.assert_array_equal(_port(params, arch, engine), want)


@pytest.mark.parametrize("engine", ["mega", "turbo"])
def test_streaming_ignores_the_variable(pair, monkeypatch, engine):
    """start_stream / stream_chunk run with the variable set, as JAX's
    streaming path, and equal their D = 1 chunks (sampled, per-lane hash)."""
    _, params, arch = pair

    def run():
        s = PG.start_stream(arch, B, 3, engine=engine, params=params, device="cpu")
        out = []
        for _ in range(3):
            c, s = PG.stream_chunk(params, arch, s, 8, temperature=1.0, engine=engine)
            out.append(c)
        return torch.cat(out, 1).numpy()

    want = run()
    monkeypatch.setenv("WAVENET_MEGA_VMEM_D", "4")
    np.testing.assert_array_equal(run(), want)


def test_plain_version_takes_d(pair):
    """mega_generate_plain accepts vmem_d and gives the same classes and
    logits at every D (where a ring lives changes no value)."""
    _, params, arch = pair
    h0, e0 = PG._fused_frontend_zero(params, arch, B)
    forced = torch.from_numpy(_forced()).t().contiguous()
    outs = []
    for d in (1, 2, 4, 8):
        carry = ar_mega.mega_zero_carry(arch, h0, e0)
        outs.append(ar_mega.mega_generate_plain(params, params["layers"], arch, carry, 0,
                                                forced, 1.0, True, None, 17, vmem_d=d))
    for cls, logits in outs[1:]:
        assert torch.equal(cls, outs[0][0]) and torch.equal(logits, outs[0][1])


def test_vmem_rows_and_streaming_guard(pair):
    """The on-chip rows (JAX `vrows`) at WaveNet-30's dilations, and the
    streaming guard: a streaming carry holds no on-chip rows."""
    dils = [2 ** i for i in range(10)] * 3
    assert [ar_mega.vmem_rows(dils, d) for d in (1, 2, 4, 8, 16)] == [0, 6, 18, 42, 90]
    _, params, arch = pair
    h0, e0 = PG._fused_frontend_zero(params, arch, B)
    carry = ar_mega.mega_zero_carry(arch, h0, e0)
    with pytest.raises(NotImplementedError, match="on-chip rings"):
        ar_mega.mega_generate(params, params["layers"], arch, None, None, 0,
                              torch.full((4, 1, B), -1, dtype=torch.int32), None, 4, 0.0,
                              False, streaming=True, carry=carry, t0=0, vmem_d=4)
