"""Port tests: the out-of-core packed corpus (`lb_wavenet_tpu_torch/pack.py`,
`Corpus.from_pack`) against the JAX package: pack files byte for byte (flat
and per-speaker layouts, with and without waves), batches bit for bit
against JAX's in-RAM and pack-backed corpora with the native tier on and
off, mel frames of a with-waves pack, the validation errors, the pack's
descriptor across a fork, and RSS that stays O(batch) on a 64 MB pack."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from lb_wavenet_tpu import data as JD
from lb_wavenet_tpu import pack as JP
from lb_wavenet_tpu.config import ArchConfig as JArch
from lb_wavenet_tpu.config import TrainConfig as JTrain
from lb_wavenet_tpu_torch import data as PD
from lb_wavenet_tpu_torch import pack as PP
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.config import TrainConfig as PTrain

from .test_torch_native import wav_bytes

torch.set_num_threads(1)
JARCH = JArch(n_blocks=1, n_layers_per_block=4, residual_channels=8, skip_channels=8,
              gate_channels=8, compute_dtype="float32")
PARCH = PArch(**dataclasses.asdict(JARCH))


def write_wavs(d, speakers=None, seed=0, lens=(1500, 700, 2300)):
    """Random PCM16 wavs: flat (`speakers` None) or one subdirectory per
    speaker name."""
    rng = np.random.default_rng(seed)
    dirs = [d] if speakers is None else [os.path.join(d, s) for s in speakers]
    for k, sub in enumerate(dirs):
        os.makedirs(sub, exist_ok=True)
        for i in range(2 + k % 2):
            pcm = rng.integers(-32768, 32768, lens[(i + k) % len(lens)] + 37 * i, dtype=np.int16)
            with open(os.path.join(sub, f"f{i}.wav"), "wb") as f:
                f.write(wav_bytes(pcm, 16000))


@pytest.mark.parametrize("speakers", [None, ("amy", "bob")])
@pytest.mark.parametrize("with_waves", [False, True])
def test_pack_file_equals_jax_pack(tmp_path, speakers, with_waves):
    """The same directory packed by either package gives the same bytes,
    and each package opens the other's pack."""
    d = str(tmp_path / "wavs")
    write_wavs(d, speakers)
    n_spk = 4 if speakers else 0
    kw = dict(quant_channels=256, sample_rate=16000, with_waves=with_waves, n_speakers=n_spk)
    ph = PP.pack_corpus(d, str(tmp_path / "port.pack"), **kw)
    jh = JP.pack_corpus(d, str(tmp_path / "jax.pack"), **kw)
    assert ph == jh and ph["enc_dtype"] == "uint8"
    assert (tmp_path / "port.pack").read_bytes() == (tmp_path / "jax.pack").read_bytes()
    a, b = PP.open_pack(str(tmp_path / "jax.pack")), JP.open_pack(str(tmp_path / "port.pack"))
    assert a.header == b.header and a.enc_pos == b.enc_pos
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.enc, b.enc)
    assert (a.waves is None) == (b.waves is None) == (not with_waves)
    pc = PD.Corpus.from_pack(str(tmp_path / "jax.pack"),
                             dataclasses.replace(PARCH, n_speakers=n_spk), 64)
    jc = JD.Corpus.from_dir(d, dataclasses.replace(JARCH, n_speakers=n_spk), 64)
    assert pc.speakers == jc.speakers and pc.speaker_names == jc.speaker_names
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


@pytest.mark.parametrize("native_on", [True, False])
def test_pack_batches_equal_jax_in_ram_and_packed(tmp_path, monkeypatch, native_on):
    """make_batches over the port's pack-backed corpus equals JAX's over its
    in-RAM and its pack-backed corpus, bit for bit, across an epoch seam
    and in lane-continuous order, with the native tier on and off; so does
    the port's in-RAM corpus."""
    if not native_on:
        monkeypatch.setenv("WAVENET_NATIVE_LOADER", "0")
    d = str(tmp_path / "wavs")
    write_wavs(d, lens=(1500, 700, 2300, 1100))
    PP.pack_corpus(d, str(tmp_path / "c.pack"))
    pc = PD.load_corpus(str(tmp_path / "c.pack"), PARCH, 64)
    assert pc._pack_fd is not None
    corpora = [pc, PD.Corpus.from_dir(d, PARCH, 64)]
    jcorpora = [JD.Corpus.from_dir(d, JARCH, 64), JD.load_corpus(str(tmp_path / "c.pack"), JARCH, 64)]
    n = len(pc.index)
    for lane in (False, True):
        pt = PTrain(batch_size=4, window_size=64, seed=11, lane_continuous=lane)
        jt = JTrain(batch_size=4, window_size=64, seed=11, lane_continuous=lane)
        its = [PD.make_batches(c, pt) for c in corpora] + [JD.make_batches(c, jt) for c in jcorpora]
        for _ in range(2 * n // 4 + 3):   # crosses the epoch seam
            first, *rest = [next(it) for it in its]
            assert first.inputs.dtype == np.int32
            for b in rest:
                for k in ("inputs", "targets", "mask"):
                    np.testing.assert_array_equal(getattr(first, k), getattr(b, k))


def test_pack_mel_frames_match_jax(tmp_path):
    """A with-waves pack gives a mel arch the waves of the directory bit for
    bit, and mel frames within the 1e-4 of tests/test_torch_train_cond.py
    against JAX's (log-mel through another FFT)."""
    jarch = dataclasses.replace(JARCH, n_mels=8, cond_channels=8, upsample_factors=(4, 4))
    parch = PArch(**dataclasses.asdict(jarch))
    d = str(tmp_path / "wavs")
    write_wavs(d, lens=(1100, 900))
    PP.pack_corpus(d, str(tmp_path / "m.pack"), with_waves=True)
    pc = PD.Corpus.from_pack(str(tmp_path / "m.pack"), parch, 64)
    jc = JD.Corpus.from_dir(d, jarch, 64)
    for a, b in zip(pc.waves, jc.waves):
        np.testing.assert_array_equal(np.asarray(a), b)
    t = dict(batch_size=3, window_size=64, seed=5)
    pit = PD.make_batches(pc, PTrain(**t), with_mel=True)
    jit = JD.make_batches(jc, JTrain(**t), with_mel=True)
    for _ in range(3):
        pb, jb = next(pit), next(jit)
        np.testing.assert_array_equal(pb.inputs, jb.inputs)
        assert pb.mel.shape == jb.mel.shape
        np.testing.assert_allclose(pb.mel, jb.mel, rtol=0, atol=1e-4)


def _pack_of(tmp_path, **kw):
    """A pack of random wavs: flat, or of three speakers with n_speakers."""
    d = str(tmp_path / ("speaker_wavs" if kw.get("n_speakers") else "wavs"))
    if not os.path.isdir(d):
        write_wavs(d, ("a", "b", "c") if kw.get("n_speakers") else None)
    path = str(tmp_path / f"v{len(os.listdir(tmp_path))}.pack")
    PP.pack_corpus(d, path, **kw)
    return path


def _truncated(tmp_path):
    """A pack whose last offset disagrees with its header's sample count."""
    path = _pack_of(tmp_path)
    pk = PP.open_pack(path)
    with open(path, "rb") as f:
        f.seek(8)
        hlen = int.from_bytes(f.read(8), "little")
    at = PP._positions(pk.header, hlen)["offsets"] + 8 * pk.header["n_files"]
    with open(path, "r+b") as f:
        f.seek(at)
        f.write(np.int64(pk.header["n_samples"] - 1).tobytes())
    return path


@pytest.mark.parametrize("case,match", [
    ("empty", "not a corpus pack"),
    ("magic", "not a corpus pack"),
    ("quant", "quant_channels"),
    ("rate", "sample_rate"),
    ("mel_without_waves", "with-waves"),
    ("speaker_ids", "n_speakers"),
    ("truncated", "truncated or corrupt"),
])
def test_pack_validation_errors(tmp_path, case, match):
    arch = PARCH
    if case == "empty":
        path = str(tmp_path / "e.pack")
        open(path, "wb").close()
    elif case == "magic":
        path = str(tmp_path / "m.pack")
        with open(path, "wb") as f:
            f.write(b"NOTAPACK" + bytes(64))
    elif case == "speaker_ids":
        path = _pack_of(tmp_path, n_speakers=3)
        arch = dataclasses.replace(PARCH, n_speakers=2)
    elif case == "truncated":
        path = _truncated(tmp_path)
    else:
        path = _pack_of(tmp_path)
        arch = {"quant": dataclasses.replace(PARCH, quant_channels=128),
                "rate": dataclasses.replace(PARCH, sample_rate=22050),
                "mel_without_waves": dataclasses.replace(
                    PARCH, n_mels=8, cond_channels=8, upsample_factors=(4, 4))}[case]
    with pytest.raises(ValueError, match=match):
        PD.load_corpus(path, arch, 64)


def test_classes_only_pack_refuses_mel_frames_and_labels_warn(tmp_path):
    """A classes-only pack has no waveform to cut mel segments from; a
    labelled pack read by an unconditioned arch trains unconditioned with a
    warning, as from_dir does."""
    pc = PD.Corpus.from_pack(_pack_of(tmp_path), PARCH, 64)
    assert pc.waves is None
    with pytest.raises(ValueError, match="classes-only pack"):
        pc._window_segment(0, 0)
    labelled = _pack_of(tmp_path, n_speakers=3)
    with pytest.warns(UserWarning, match="unconditioned"):
        assert PD.Corpus.from_pack(labelled, PARCH, 64).speakers is None


def test_pack_descriptor_is_reopened_after_fork(tmp_path):
    """The pack's descriptor belongs to the process that opened it: a
    forked child's corpus opens its own, with the same batches."""
    pc = PD.Corpus.from_pack(_pack_of(tmp_path), PARCH, 64)
    pairs = [pc.index[r] for r in range(4)]
    want = pc.examples_batch(pairs)
    parent_fd = pc._pack_fd
    pc._pack_pid = -1   # as a forked child sees it
    got = pc.examples_batch(pairs)
    assert pc._pack_fd != parent_fd and pc._pack_pid == os.getpid()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    os.close(parent_fd)


def _rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise RuntimeError("no VmRSS")


def test_pack_rss_stays_o_batch(tmp_path):
    """A 64 MB pack streams batches with bounded resident memory: the pread
    path copies each window's span, nothing else (as JAX's
    tests/test_pack.py holds its own)."""
    path = str(tmp_path / "big.pack")
    w = PP.PackWriter(path, quant_channels=256, sample_rate=16000)
    rng = np.random.default_rng(0)
    for _ in range(16):
        w.add_file(rng.integers(0, 256, 4 << 20, dtype=np.uint8))
    w.close()
    assert os.path.getsize(path) > 60 << 20
    corpus = PD.Corpus.from_pack(path, PARCH, 4096)
    it = PD.make_batches(corpus, PTrain(batch_size=8, window_size=4096, seed=0))
    before = _rss_kb()
    for _ in range(10):
        batch = next(it)
    grown_kb = _rss_kb() - before
    assert grown_kb < 8_000, f"RSS grew {grown_kb} KB on a 64 MB pack"
    assert batch.inputs.shape == (8, PARCH.receptive_field - 1 + 4096)
