"""Port tests: the native (C++) ingest and assembly tier of the port
(`lb_wavenet_tpu_torch/native/`) against the JAX package's tier and the
Python oracles: the mu-law table, wav ingest (with extra RIFF chunks, the
malformed and non-PCM16 cases), the kill switch, window assembly in memory
(int32 and uint8) and by pread, its errors, and a build failure."""
import io
import os
import struct

import numpy as np
import pytest
import torch

from lb_wavenet_tpu import native as JN
from lb_wavenet_tpu.ops import geometry as JG
from lb_wavenet_tpu_torch import data as PD
from lb_wavenet_tpu_torch import native as PN
from lb_wavenet_tpu_torch.config import ArchConfig as PArch
from lb_wavenet_tpu_torch.ops import geometry as PG

torch.set_num_threads(1)
ARCH = PArch(n_blocks=2, n_layers_per_block=3, residual_channels=8, skip_channels=8,
             gate_channels=8, compute_dtype="float32")


def wav_bytes(pcm: np.ndarray, sr: int, extra_chunk: bool = False) -> bytes:
    """A RIFF/PCM16 mono file written by hand (no scipy)."""
    payload = pcm.astype(np.int16).tobytes()
    chunks = b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    if extra_chunk:   # parsers must skip unknown chunks
        chunks += b"LIST" + struct.pack("<I", 4) + b"INFO"
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def extensible_bytes(format_code: int, n: int = 32) -> bytes:
    """A WAVE_FORMAT_EXTENSIBLE PCM16 mono file whose SubFormat GUID carries
    `format_code` (1 = PCM, 3 = IEEE float)."""
    payload = np.zeros(n, np.int16).tobytes()
    guid = struct.pack("<H", format_code) + b"\x00\x00" + bytes(12)
    body = struct.pack("<HHIIHH", 0xFFFE, 1, 16000, 32000, 2, 16)
    body += struct.pack("<HH", 22, 16) + struct.pack("<I", 0) + guid
    chunks = b"fmt " + struct.pack("<I", len(body)) + body
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


@pytest.mark.parametrize("q", [256, 1024])
def test_lut_equals_jax_everywhere(q):
    """All 65,536 PCM16 values: the port's table (its torch encoder) equals
    JAX's encoder run op by op, the Python path of its loader. At Q = 256
    it equals the JAX tier's own table too; above 256 that table, jitted,
    moves a few entries by one class (ROADMAP.md queue C)."""
    import jax.numpy as jnp

    from lb_wavenet_tpu.ops.mulaw import mu_law_encode

    lut = PN.mulaw_lut(q)
    assert lut.shape == (65536,) and lut.dtype == np.int32
    grid = jnp.arange(-32768, 32768, dtype=jnp.float32) / 32768.0
    np.testing.assert_array_equal(lut, np.asarray(mu_law_encode(grid, q)))
    if q == 256:
        np.testing.assert_array_equal(lut, JN.mulaw_lut(q))
    assert lut.min() == 0 and lut.max() == q - 1


@pytest.mark.parametrize("extra_chunk", [False, True])
def test_ingest_wav_equals_jax_and_python(extra_chunk):
    rng = np.random.default_rng(0)
    pcm = rng.integers(-32768, 32768, 12000, dtype=np.int16)
    pcm[:4] = [-32768, 32767, 0, -1]
    raw = wav_bytes(pcm, 16000, extra_chunk)
    wav, enc, sr = PN.ingest_wav(raw, 256)
    jwav, jenc, jsr = JN.ingest_wav(raw, 256)
    assert sr == jsr == 16000
    np.testing.assert_array_equal(wav, jwav)
    np.testing.assert_array_equal(enc, jenc)
    # The Python path: scipy's reader and the torch encoder.
    from scipy.io import wavfile

    from lb_wavenet_tpu_torch.ops.mulaw import mu_law_encode

    ref = wavfile.read(io.BytesIO(raw))[1].astype(np.float32) / 32768.0
    np.testing.assert_array_equal(wav, ref)
    np.testing.assert_array_equal(enc, mu_law_encode(torch.from_numpy(ref)).numpy())


def _stereo():
    raw = bytearray(wav_bytes(np.zeros(64, np.int16), 16000))
    raw[22] = 2   # the channels field
    return bytes(raw)


@pytest.mark.parametrize("case,raw,outcome", [
    ("malformed", b"RIFFxxxxWAVEjunk", ValueError),
    ("truncated", wav_bytes(np.zeros(500, np.int16), 16000)[:600], ValueError),
    ("stereo", _stereo(), None),
    ("extensible_float", extensible_bytes(3), None),
    ("extensible_pcm", extensible_bytes(1), 32),
])
def test_ingest_container_cases_match_jax(case, raw, outcome):
    """Malformed containers raise; a wav that is not mono PCM16 returns None
    (the Python path reads it); an extensible PCM container ingests; each
    as the JAX package's tier does."""
    if outcome is ValueError:
        with pytest.raises(ValueError, match="malformed"):
            PN.ingest_wav(raw, 256)
        with pytest.raises(ValueError):
            JN.ingest_wav(raw, 256)
    elif outcome is None:
        assert PN.ingest_wav(raw, 256) is None and JN.ingest_wav(raw, 256) is None
    else:
        got, want = PN.ingest_wav(raw, 256), JN.ingest_wav(raw, 256)
        assert len(got[0]) == outcome
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)


def test_kill_switch_never_builds(monkeypatch):
    """WAVENET_NATIVE_LOADER=0: nothing reaches the library or the build."""
    monkeypatch.setenv("WAVENET_NATIVE_LOADER", "0")

    def boom(*_a, **_k):
        raise AssertionError("the native library was asked for despite the kill switch")

    monkeypatch.setattr(PN, "_lib", boom)
    monkeypatch.setattr(PN, "build", boom)
    assert PN.ingest_wav(b"\x00" * 16, 256) is None
    assert PN.assemble_windows(np.zeros(4, np.int32), np.array([0, 4], np.int64),
                               [(0, 0)], 2, 1) is None
    assert PN.assemble_windows_fd(0, 0, 1, np.array([0, 4], np.int64), [(0, 0)], 2, 1) is None
    assert PN.is_available() is False


def test_build_failure_raises_naming_the_command(tmp_path, monkeypatch):
    """A g++ failure raises with the command and its stderr (the JAX tier
    warns and falls back; the port does not)."""
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(PN, "SRC", bad)
    monkeypatch.setattr(PN, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"g\+\+ .*-shared(.|\n)*error"):
        PN.build()
    assert not [p for p in (tmp_path / "build").iterdir()]   # no temp file left behind


def _random_corpus(rng, n_files):
    files = [rng.integers(0, 256, int(rng.integers(2, 150)), dtype=np.int32)
             for _ in range(n_files)]
    offsets = np.zeros(len(files) + 1, np.int64)
    np.cumsum([len(f) for f in files], out=offsets[1:])
    return files, offsets, np.concatenate(files)


@pytest.mark.parametrize("path", ["int32", "uint8", "pread"])
def test_assembly_equals_extract_window(tmp_path, path):
    """Random geometry (short files, edge windows, R > W): every window of
    the native assemblers equals the port's and JAX's extract_window."""
    rng = np.random.default_rng({"int32": 1, "uint8": 2, "pread": 3}[path])
    for trial in range(12):
        w, r = int(rng.integers(1, 40)), int(rng.integers(1, 70))
        files, offsets, concat = _random_corpus(rng, int(rng.integers(1, 6)))
        pairs = [(fi, wi) for fi, f in enumerate(files)
                 for wi in range(PG.num_windows(len(f), w))]
        if path == "pread":
            blob = tmp_path / f"enc{trial}.bin"
            blob.write_bytes(b"\x07" * 24 + concat.astype(np.uint8).tobytes())
            fd = os.open(blob, os.O_RDONLY)
            try:
                out = PN.assemble_windows_fd(fd, 24, 1, offsets, pairs, w, r)
            finally:
                os.close(fd)
        else:
            enc = np.ascontiguousarray(concat.astype(np.dtype(path)))
            out = PN.assemble_windows(enc, offsets, pairs, w, r)
        for row, (fi, wi) in enumerate(pairs):
            want = PG.extract_window(files[fi], w, r, wi)
            jwant = JG.extract_window(files[fi], w, r, wi)
            for got, a, b in zip(out, want, jwant):
                np.testing.assert_array_equal(got[row], a, err_msg=f"{trial=} {fi=} {wi=}")
                np.testing.assert_array_equal(got[row], b)


@pytest.mark.parametrize("pair", [(0, 5), (1, 0), (0, -1)])
@pytest.mark.parametrize("path", ["int32", "uint8", "pread"])
def test_out_of_range_pair_raises(tmp_path, path, pair):
    enc = np.arange(10, dtype=np.int32)
    offsets = np.array([0, 10], np.int64)
    if path == "pread":
        blob = tmp_path / "enc.bin"
        blob.write_bytes(enc.astype(np.uint8).tobytes())
        fd = os.open(blob, os.O_RDONLY)
        try:
            with pytest.raises(IndexError, match=rf"window pair \({pair[0]}, {pair[1]}\)"):
                PN.assemble_windows_fd(fd, 0, 1, offsets, [(0, 0), pair], 4, 3)
        finally:
            os.close(fd)
    else:
        with pytest.raises(IndexError, match="out of range"):
            PN.assemble_windows(enc.astype(np.dtype(path)), offsets, [(0, 0), pair], 4, 3)


def test_pread_io_failure_raises_oserror(tmp_path):
    """A descriptor that cannot be read (or a pack shorter than its offsets
    say) is an OSError, not garbage windows."""
    blob = tmp_path / "short.bin"
    blob.write_bytes(bytes(5))
    fd = os.open(blob, os.O_RDONLY)
    try:
        with pytest.raises(OSError, match="pread"):
            PN.assemble_windows_fd(fd, 0, 1, np.array([0, 40], np.int64), [(0, 0)], 8, 4)
    finally:
        os.close(fd)


def test_from_dir_native_equals_python_and_jax(tmp_path, monkeypatch):
    """Corpus.from_dir through the native tier on its thread pool, through
    the Python path (a stereo file takes it per file), and JAX's from_dir:
    the same waves and classes; a malformed file is named."""
    from lb_wavenet_tpu import data as JD

    from .util import MICRO

    rng = np.random.default_rng(4)
    for i in range(3):
        pcm = rng.integers(-32768, 32768, 1500 + 37 * i, dtype=np.int16)
        (tmp_path / f"f{i}.wav").write_bytes(wav_bytes(pcm, 16000))
    PD.write_wav(str(tmp_path / "f3.wav"), 0.3 * rng.standard_normal((900, 2)), 16000)
    native = PD.Corpus.from_dir(str(tmp_path), ARCH, 64)
    jax_corpus = JD.Corpus.from_dir(str(tmp_path), MICRO, 64)
    monkeypatch.setenv("WAVENET_NATIVE_LOADER", "0")
    python = PD.Corpus.from_dir(str(tmp_path), ARCH, 64)
    for c in (python, jax_corpus):
        for a, b in zip(native.encoded, c.encoded):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(native.waves, c.waves):
            np.testing.assert_array_equal(a, b)
    monkeypatch.delenv("WAVENET_NATIVE_LOADER")
    good = wav_bytes(np.zeros(500, np.int16), 16000)
    (tmp_path / "f4.wav").write_bytes(good[: len(good) // 2])
    with pytest.raises(ValueError, match="f4.wav"):
        PD.Corpus.from_dir(str(tmp_path), ARCH, 64)
