"""Port tests: window geometry, corpora and the batch stream, bit for bit
against the JAX package (numpy and integer paths)."""
import dataclasses
import itertools

import numpy as np
import pytest

from lb_wavenet_tpu import data as JD
from lb_wavenet_tpu.config import TrainConfig as JTrain
from lb_wavenet_tpu.ops import geometry as JG
from lb_wavenet_tpu_torch import data as PD
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.config import TrainConfig as PTrain
from lb_wavenet_tpu_torch.ops import geometry as PG

from .util import MICRO

PMICRO = PArch(**dataclasses.asdict(MICRO))


def test_geometry_bit_exact():
    rng = np.random.default_rng(0)
    assert PG.receptive_field(MICRO.dilations, 3) == JG.receptive_field(MICRO.dilations, 3)
    for file_len, w in itertools.product((0, 1, 2, 17, 64, 65, 200), (1, 16, 64)):
        assert PG.num_windows(file_len, w) == JG.num_windows(file_len, w)
        enc = rng.integers(0, 256, file_len)
        for i in range(PG.num_windows(file_len, w)):
            assert PG.window_bounds(file_len, w, i) == JG.window_bounds(file_len, w, i)
            for got, want in zip(PG.extract_window(enc, w, 16, i),
                                 JG.extract_window(enc, w, 16, i)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def test_synthetic_corpus_encodings_bit_exact():
    pc = PD.synthetic_corpus(PMICRO, 64, n_files=3, file_len=3000, seed=4)
    jc = JD.synthetic_corpus(MICRO, 64, n_files=3, file_len=3000, seed=4)
    assert len(pc.index) == len(jc.index)
    for p, j in zip(pc.encoded, jc.encoded):
        np.testing.assert_array_equal(p, j)
    assert list(pc.index) == list(jc.index)


@pytest.mark.parametrize("seed,lane_continuous", [(0, False), (5, False), (2, True)])
def test_make_batches_bit_exact_across_epoch_seams(seed, lane_continuous):
    """Batch size 3 over 2 x 200-sample files at W=16 (26 windows): the
    ninth batch straddles the first epoch seam; resuming at step 8 and a
    2-host split give the same rows."""
    kw = dict(batch_size=3, window_size=16, seed=seed, lane_continuous=lane_continuous)
    pc = PD.synthetic_corpus(PMICRO, 16, n_files=2, file_len=200, seed=1)
    jc = JD.synthetic_corpus(MICRO, 16, n_files=2, file_len=200, seed=1)
    assert len(pc.index) % 3 != 0
    pit = PD.make_batches(pc, PTrain(**kw))
    jit = JD.make_batches(jc, JTrain(**kw))
    batches = []
    for _ in range(20):
        p, j = next(pit), next(jit)
        for f in ("inputs", "targets", "mask"):
            np.testing.assert_array_equal(getattr(p, f), getattr(j, f))
            assert getattr(p, f).dtype == getattr(j, f).dtype
        batches.append(p)
    resumed = next(PD.make_batches(pc, PTrain(**kw), start_step=8))
    np.testing.assert_array_equal(resumed.inputs, batches[8].inputs)
    kw["batch_size"] = 4
    whole = next(PD.make_batches(pc, PTrain(**kw), start_step=3))
    halves = [next(PD.make_batches(pc, PTrain(**kw), host_id=h, host_count=2, start_step=3))
              for h in (0, 1)]
    np.testing.assert_array_equal(whole.inputs[0::2], halves[0].inputs)
    np.testing.assert_array_equal(whole.inputs[1::2], halves[1].inputs)


def test_corpus_from_dir_matches_jax(tmp_path):
    """Wavs the test writes: a flat and a per-speaker layout, int16 PCM."""
    rng = np.random.default_rng(7)
    flat = tmp_path / "flat"
    flat.mkdir()
    for i, n in enumerate((900, 1500)):
        PD.write_wav(str(flat / f"f{i}.wav"), 0.8 * np.sin(np.arange(n) * 0.03 * (i + 1))
                     + 0.1 * rng.standard_normal(n), 16000)
    pc = PD.Corpus.from_dir(str(flat), PMICRO, 32)
    jc = JD.Corpus.from_dir(str(flat), MICRO, 32)
    for p, j in zip(pc.encoded, jc.encoded):
        np.testing.assert_array_equal(p, j)
    w, sr = PD.load_wav(str(flat / "f0.wav"))
    w_j, sr_j = JD.load_wav(str(flat / "f0.wav"))
    assert sr == sr_j == 16000
    np.testing.assert_array_equal(w, w_j)
    np.testing.assert_array_equal(PD.load_corpus(str(flat), PMICRO, 32).encoded[1],
                                  jc.encoded[1])

    spk = tmp_path / "spk"
    for name in ("bob", "amy"):
        (spk / name).mkdir(parents=True)
        PD.write_wav(str(spk / name / "x.wav"), 0.3 * rng.standard_normal(700), 16000)
    arch2 = dataclasses.replace(PMICRO, n_speakers=2)
    pc = PD.Corpus.from_dir(str(spk), arch2, 32)
    assert pc.speaker_names == ["amy", "bob"] and pc.speakers == [0, 1]
    assert next(PD.make_batches(pc, PTrain(batch_size=2, window_size=32))).speaker is not None
    with pytest.warns(UserWarning, match="unconditioned"):
        assert PD.Corpus.from_dir(str(spk), PMICRO, 32).speakers is None
    with pytest.raises(ValueError, match="sample rate"):
        PD.Corpus.from_dir(str(flat), dataclasses.replace(PMICRO, sample_rate=8000), 32)


def test_unported_inputs_raise_and_prefetch_forwards_errors(tmp_path):
    pack = tmp_path / "corpus.pack"
    pack.write_bytes(b"")
    with pytest.raises(NotImplementedError, match="A queue item 8"):
        PD.load_corpus(str(pack), PMICRO, 32)
    # Mel frames are ported (tests/test_torch_train_cond.py holds them
    # against JAX's); an arch without mel has none to give.
    pc = PD.synthetic_corpus(PMICRO, 16, n_files=1, file_len=100)
    with pytest.raises(ValueError, match="n_mels"):
        next(PD.make_batches(pc, PTrain(batch_size=2, window_size=16), with_mel=True))

    def bad():
        yield 1
        raise RuntimeError("loader broke")

    it = PD.prefetch(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="loader broke"):
        next(it)
    assert list(PD.prefetch(iter(range(5)))) == list(range(5))

    import threading
    import time

    before = threading.active_count()
    endless = PD.prefetch(itertools.count())
    assert next(endless) == 0
    endless.close()   # the producer thread must not outlive its consumer
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.02)
    assert threading.active_count() == before
