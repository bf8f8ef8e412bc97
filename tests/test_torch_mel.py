"""Port tests: the log-mel frontend (ops/mel.py), the learned upsampler
(models/conditioning.py) and conditioned parameter trees (convert,
checkpoint) against the JAX package, on tiny shapes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu.config import ArchConfig
from lb_wavenet_tpu.models import conditioning as JC
from lb_wavenet_tpu.models.wavenet import init_params as jinit
from lb_wavenet_tpu.ops import mel as JMEL
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.models import conditioning as PC
from lb_wavenet_tpu_torch.ops import mel as PMEL
from lb_wavenet_tpu_torch.utils import checkpoint as PCK
from lb_wavenet_tpu_torch.utils.convert import params_from_jax, params_to_numpy

torch.set_num_threads(1)

MEL_ARCH = ArchConfig(n_blocks=1, n_layers_per_block=3, residual_channels=8, skip_channels=8,
                      gate_channels=8, n_mels=8, cond_channels=8, upsample_factors=(4, 4),
                      n_speakers=3, speaker_embed_dim=6, compute_dtype="float32")
UPSAMPLE_ATOL = 1e-5   # fp32 upsampler: sums over taps and channels in another order


def _parch(arch):
    return PArch(**dataclasses.asdict(arch))


@pytest.fixture(scope="module")
def pair():
    jp = jinit(jax.random.key(0), MEL_ARCH)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp)), _parch(MEL_ARCH)


@pytest.mark.parametrize("n_mels,n_fft,sr,fmin,fmax", [
    (80, 1024, 16000, 0.0, None), (8, 64, 16000, 0.0, None), (40, 512, 22050, 50.0, 8000.0),
])
def test_mel_filterbank_equals_jax_bit_for_bit(n_mels, n_fft, sr, fmin, fmax):
    np.testing.assert_array_equal(PMEL.mel_filterbank(n_mels, n_fft, sr, fmin, fmax),
                                  JMEL.mel_filterbank(n_mels, n_fft, sr, fmin, fmax))
    np.testing.assert_array_equal(PMEL.hz_to_mel([0.0, 440.0, 8000.0]),
                                  JMEL.hz_to_mel([0.0, 440.0, 8000.0]))
    np.testing.assert_array_equal(PMEL.mel_to_hz([0.0, 1000.0]), JMEL.mel_to_hz([0.0, 1000.0]))


@pytest.mark.parametrize("n_mels,n_fft,hop,length", [(8, 64, 16, 1000), (80, 1024, 256, 4000)])
def test_log_mel_spectrogram_matches_jax(n_mels, n_fft, hop, length):
    """rtol/atol 1e-4: the two FFTs sum in different orders."""
    t = np.arange(length) / 16000.0
    rng = np.random.default_rng(0)
    wav = np.stack([0.5 * np.sin(2 * np.pi * f * t) for f in (220.0, 1234.5)])
    wav = (wav + 0.01 * rng.standard_normal(wav.shape)).astype(np.float32)
    want = np.asarray(JMEL.log_mel_spectrogram(jnp.asarray(wav), n_mels, n_fft, hop))
    got = PMEL.log_mel_spectrogram(torch.from_numpy(wav), n_mels, n_fft, hop)
    assert got.shape == want.shape == (2, -(-length // hop), n_mels)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    one = PMEL.log_mel_spectrogram(torch.from_numpy(wav[0]), n_mels, n_fft, hop)
    np.testing.assert_array_equal(one.numpy(), got[:1].numpy())


@pytest.mark.parametrize("factors", [(4, 4), (4, 8, 8), (3,)])
def test_upsample_cond_matches_jax(factors):
    arch = dataclasses.replace(MEL_ARCH, upsample_factors=factors)
    jp = JC.init_upsampler_params(jax.random.key(3), arch)
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    frames = np.random.default_rng(1).standard_normal((2, 5, arch.n_mels)).astype(np.float32)
    want = np.asarray(JC.upsample_cond(jp, arch, jnp.asarray(frames), jnp.float32))
    got = PC.upsample_cond(pp, _parch(arch), torch.from_numpy(frames), torch.float32)
    assert got.shape == want.shape == (2, 5 * arch.hop_size, arch.cond_channels)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=UPSAMPLE_ATOL)
    bf = PC.upsample_cond(pp, _parch(arch), torch.from_numpy(frames), torch.bfloat16)
    assert bf.dtype == torch.bfloat16   # computed in fp32, only the output is cast
    assert torch.equal(bf, got.to(torch.bfloat16))
    assert PC.cond_halo_frames(_parch(arch)) == JC.cond_halo_frames(arch)


def test_init_upsampler_params_layout():
    pp = PC.init_upsampler_params(0, _parch(MEL_ARCH))
    jp = JC.init_upsampler_params(jax.random.key(0), MEL_ARCH)
    shapes = jax.tree.map(lambda x: tuple(x.shape), jp)
    assert jax.tree.map(lambda x: tuple(x.shape), params_to_numpy(pp)) == shapes


@pytest.mark.parametrize("sizes", [[17], [4, 4, 4, 5], [1] * 17, [2, 10, 5], [16, 1]])
def test_streaming_upsampler_equals_one_shot_and_jax(pair, sizes):
    """Chunked == one-shot bit for bit (each output sample is a sum over its
    taps in tap order, whatever the input length), and within
    UPSAMPLE_ATOL of JAX's streaming upsampler."""
    jp, pp, parch = pair
    frames = np.random.default_rng(2).standard_normal((2, 17, MEL_ARCH.n_mels))
    frames = frames.astype(np.float32)
    full = PC.upsample_cond(pp["upsampler"], parch, torch.from_numpy(frames), torch.float32)
    ups = PC.StreamingUpsampler(pp["upsampler"], parch)
    jups = JC.StreamingUpsampler(jp["upsampler"], MEL_ARCH)
    parts, jparts, a = [], [], 0
    for s in sizes:
        parts.append(ups.feed(frames[:, a: a + s]))
        jparts.append(np.asarray(jups.feed(jnp.asarray(frames[:, a: a + s]))))
        a += s
    parts.append(ups.finish())
    jparts.append(np.asarray(jups.finish()))
    got = torch.cat(parts, 1)
    np.testing.assert_array_equal(got.numpy(), full.numpy())
    np.testing.assert_allclose(got.numpy(), np.concatenate(jparts, 1), rtol=0,
                               atol=UPSAMPLE_ATOL)
    with pytest.raises(ValueError, match="finished"):
        ups.feed(frames[:, :1])


def test_conditioned_tree_round_trips_leaf_for_leaf(pair, tmp_path):
    """params_from_jax / params_to_numpy and save/restore carry the
    upsampler's list of stages and the speaker table leaf for leaf."""
    jp, pp, _ = pair
    assert isinstance(pp["upsampler"]["stages"], list) and len(pp["upsampler"]["stages"]) == 2
    jflat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0]
    back = params_to_numpy(pp)
    bflat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in jflat] == [k for k, _ in bflat]
    for (k, a), (_, b) in zip(jflat, bflat):
        np.testing.assert_array_equal(a, b, err_msg=str(k))
    PCK.save_params(str(tmp_path), pp, 7)
    restored = PCK.restore_params(str(tmp_path))
    rflat = jax.tree_util.tree_flatten_with_path(params_to_numpy(restored))[0]
    assert [k for k, _ in rflat] == [k for k, _ in jflat]
    for (k, a), (_, b) in zip(jflat, rflat):
        np.testing.assert_array_equal(a, b, err_msg=str(k))


def test_conditioned_train_state_round_trips(pair, tmp_path):
    """A whole train state of a conditioned tree through the training
    checkpoint manager: every leaf of params and Adam moments back."""
    from lb_wavenet_tpu_torch.train import TrainState, tree_leaves, tree_map

    _, pp, _ = pair
    opt = {"count": 3, "mu": tree_map(lambda x: x + 1.0, pp),
           "nu": tree_map(lambda x: x * 2.0, pp)}
    state = TrainState(pp, opt, 5, None)
    manager = PCK.make_manager(str(tmp_path))
    PCK.save(manager, state, 5)
    fresh = TrainState(tree_map(torch.zeros_like, pp),
                       {"count": 0, "mu": tree_map(torch.zeros_like, pp),
                        "nu": tree_map(torch.zeros_like, pp)}, 0, None)
    got, step = PCK.restore_if_available(manager, fresh)
    assert step == 5
    for a, b in zip(tree_leaves(got.params) + tree_leaves(got.opt_state["nu"]),
                    tree_leaves(pp) + tree_leaves(opt["nu"])):
        assert torch.equal(a, b)
    assert len(tree_leaves(pp)) == len(jax.tree.leaves(pair[0]))
