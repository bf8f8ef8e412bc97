"""Input pipeline: wav corpus -> batched teacher-forcing windows (port of
`lb_wavenet_tpu/data.py`).

A deterministic, seeded, numpy-only loader. Files are mu-law encoded once
(on the CPU, with the port's bit-exact `ops/mulaw.py`) into an in-memory
corpus; each epoch is a seeded permutation of all (file, window) pairs; a
host takes rows `host_id::host_count` of every batch. For the same seed and
step the batches equal the JAX package's row for row.

A mel-conditioned arch's batches carry each window's log-mel frames
(`with_mel`): the float waveform over the window's model-input span, zero
outside the file, through the port's `ops/mel.py` in one batched call per
batch (on the CPU, in the prefetch thread).

Files are ingested (parsed and mu-law encoded) by the native C++ tier
(`native/`, on a thread pool) and batches assembled by it; a wav that is
not mono PCM16, or WAVENET_NATIVE_LOADER=0, takes the Python path, with the
same bits. A packed corpus file (`pack.py`, `cli pack`) keeps the classes
on disk: `Corpus.from_pack` reads each batch's windows by pread(2), so host
memory stays O(batch) whatever the corpus size.

A mol arch (arch.output_dist == "mol") keeps 16-bit linear PCM in place of
mu-law classes: `encoded` holds each file's int16 sample values (as int32),
windows are cut by the same geometry and assembler, and `make_batches`
hands out inputs and targets as float32 samples k / 32768 in [-1, 1). Its
packed corpora are not there yet (ops/mol.py ROADMAP_PACK).
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from .config import ArchConfig, TrainConfig
from .ops import geometry
from .ops.mel import log_mel_spectrogram
from .ops.mulaw import mu_law_encode
from .utils.profiling import span


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a wav file to float32 in [-1, 1] (mono: channels averaged)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, sr


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write a float waveform in [-1, 1] as 16-bit PCM."""
    from scipy.io import wavfile

    wav = np.clip(np.asarray(wav, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, sample_rate, (wav * 32767.0).astype(np.int16))


@dataclasses.dataclass
class Batch:
    """One training batch (host-local rows)."""

    inputs: np.ndarray   # int32 (B, R-1+W) mu-law classes; float32 samples (mol)
    targets: np.ndarray  # int32 (B, W); float32 (mol)
    mask: np.ndarray     # float32 (B, W)
    mel: Optional[np.ndarray] = None       # float32 (B, F, n_mels)
    speaker: Optional[np.ndarray] = None   # int32 (B,)


def discover_layout(data_dir: str, n_speakers: int = 0):
    """Flat (`data_dir/*.wav`) or per-speaker (`data_dir/<speaker>/*.wav`,
    sorted subdirectory names -> ids 0..S-1) layout: (paths, speakers |
    None, speaker_names | None). With n_speakers == 0 a per-speaker layout
    drops its labels with a warning."""

    def wavs_in(d: str) -> list:
        return sorted(os.path.join(d, f) for f in os.listdir(d)
                      if f.lower().endswith(".wav"))

    flat = wavs_in(data_dir)
    by_speaker = [
        (name, wavs)
        for name in sorted(os.listdir(data_dir))
        if os.path.isdir(os.path.join(data_dir, name))
        and (wavs := wavs_in(os.path.join(data_dir, name)))
    ]
    speakers: Optional[list] = None
    speaker_names: Optional[list] = None
    if by_speaker and flat:
        raise ValueError(
            f"{data_dir}: ambiguous layout — wav files both at the top "
            "level and inside speaker subdirectories")
    if by_speaker:
        paths = [p for _, wavs in by_speaker for p in wavs]
        if n_speakers > 0:
            if len(by_speaker) > n_speakers:
                raise ValueError(
                    f"{data_dir}: {len(by_speaker)} speaker directories "
                    f"but arch.n_speakers={n_speakers}")
            speakers = [si for si, (_, wavs) in enumerate(by_speaker) for _ in wavs]
            speaker_names = [name for name, _ in by_speaker]
        else:
            warnings.warn(f"{data_dir} has speaker subdirectories but "
                          "arch.n_speakers == 0; training unconditioned")
    else:
        paths = flat
    if not paths:
        raise FileNotFoundError(f"No .wav files under {data_dir}")
    return paths, speakers, speaker_names


class WindowIndex:
    """Lazy flat index of (file, window) pairs from per-file window-count
    prefix sums: the same order and r -> (fi, wi) map as the materialized
    list [(fi, wi) for fi in files for wi in windows(fi)]."""

    def __init__(self, counts):
        self.prefix = np.concatenate([[0], np.cumsum(np.asarray(counts, dtype=np.int64))])
        self.n = int(self.prefix[-1])

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, r: int):
        if r < 0:
            r += self.n
        if not 0 <= r < self.n:
            raise IndexError(r)
        fi = int(np.searchsorted(self.prefix, r, side="right")) - 1
        return fi, int(r - self.prefix[fi])

    def __iter__(self):
        for fi in range(len(self.prefix) - 1):
            for wi in range(int(self.prefix[fi + 1] - self.prefix[fi])):
                yield (fi, wi)


class Corpus:
    """Mu-law-encoded corpus with its window index: in memory, or on disk
    behind a pack file (`from_pack`)."""

    _pack_fd: Optional[int] = None

    def __init__(
        self,
        waves: Sequence[np.ndarray],
        arch: ArchConfig,
        window_size: int,
        speakers: Optional[Sequence[int]] = None,
        encoded: Optional[Sequence[np.ndarray]] = None,
    ):
        self.arch = arch
        self.window_size = window_size
        self.r_field = arch.receptive_field
        self.waves = [np.asarray(w, dtype=np.float32) for w in waves]
        if arch.mol:              # 16-bit linear PCM, whatever the caller encoded
            from .ops.mol import pcm16

            self.encoded = [pcm16(w) for w in self.waves]
        elif encoded is not None:   # encoded by the native tier's table
            self.encoded = [np.asarray(e, dtype=np.int32) for e in encoded]
            if len(self.encoded) != len(self.waves):
                raise ValueError(f"{len(self.encoded)} encoded files for {len(self.waves)} waves")
        else:
            self.encoded = [
                mu_law_encode(torch.from_numpy(w), arch.quant_channels).numpy()
                for w in self.waves
            ]
        self._packed: Optional[tuple] = None   # (enc_concat, offsets), lazily
        self.speakers = list(speakers) if speakers is not None else None
        self.speaker_names: Optional[list] = None  # set by from_dir
        self.index = WindowIndex(
            [geometry.num_windows(len(e), window_size) for e in self.encoded])
        if not len(self.index):
            raise ValueError("Corpus yields no training windows")

    @classmethod
    def from_dir(cls, data_dir: str, arch: ArchConfig, window_size: int) -> "Corpus":
        """Build from a directory of wavs (flat or per-speaker layout, see
        `discover_layout`); every file must have arch.sample_rate. The
        native tier ingests the files on a thread pool; a file it does not
        take (not mono PCM16), or every file with the tier off, goes
        through `load_wav` and the torch encoder, with the same bits."""
        from . import native

        paths, speakers, speaker_names = discover_layout(data_dir, n_speakers=arch.n_speakers)
        results: list = [None] * len(paths)
        if native.is_available():
            native.mulaw_lut(arch.quant_channels)   # once, not per thread

            def ingest(i: int) -> None:
                with open(paths[i], "rb") as f:
                    raw = f.read()
                try:
                    results[i] = native.ingest_wav(raw, arch.quant_channels)
                except ValueError as e:   # name the file
                    raise ValueError(f"{paths[i]}: {e}") from e

            import concurrent.futures as cf

            with cf.ThreadPoolExecutor(min(os.cpu_count() or 1, 4)) as ex:
                list(ex.map(ingest, range(len(paths))))
        waves, encoded = [], []
        for p, res in zip(paths, results):
            if res is None:
                w, sr = load_wav(p)
                enc = mu_law_encode(torch.from_numpy(w), arch.quant_channels).numpy()
            else:
                w, enc, sr = res
            if sr != arch.sample_rate:
                raise ValueError(f"{p}: sample rate {sr} != configured {arch.sample_rate}")
            waves.append(w)
            encoded.append(enc)
        corpus = cls(waves, arch, window_size, speakers=speakers, encoded=encoded)
        corpus.speaker_names = speaker_names
        return corpus

    @classmethod
    def from_pack(cls, path: str, arch: ArchConfig, window_size: int) -> "Corpus":
        """Open a packed corpus file (`pack.pack_corpus`, `cli pack`): the
        classes (and the float waves of a with-waves pack) stay on disk
        behind read-only maps, and batches are read from the file by the
        native tier's pread path, so host RSS is O(batch). Batches equal the
        in-RAM Corpus's over the same wavs bit for bit."""
        from .pack import open_pack

        if arch.mol:
            from .ops.mol import ROADMAP_PACK

            raise NotImplementedError(f"{path}: a pack holds mu-law classes; {ROADMAP_PACK}")
        pk = open_pack(path)
        h = pk.header
        if h["quant_channels"] != arch.quant_channels:
            raise ValueError(f"{path}: pack quant_channels {h['quant_channels']} != "
                             f"arch.quant_channels {arch.quant_channels}")
        if h["sample_rate"] != arch.sample_rate:
            raise ValueError(f"{path}: pack sample_rate {h['sample_rate']} != "
                             f"arch.sample_rate {arch.sample_rate}")
        if arch.use_local_cond and pk.waves is None:
            raise ValueError(f"{path}: a mel-conditioned arch needs the float waveform "
                             "section; re-pack with `cli pack --with-waves`")
        self = cls.__new__(cls)
        self.arch = arch
        self.window_size = window_size
        self.r_field = arch.receptive_field
        off = pk.offsets
        n_files = h["n_files"]
        self.encoded = [pk.enc[off[i]: off[i + 1]] for i in range(n_files)]
        self.waves = (None if pk.waves is None
                      else [pk.waves[off[i]: off[i + 1]] for i in range(n_files)])
        self._packed = (pk.enc, off)   # the map is the packed corpus
        self._pack_path = path
        self._pack_enc_pos = pk.enc_pos
        self._pack_itemsize = np.dtype(h["enc_dtype"]).itemsize
        self._pack_fd = os.open(path, os.O_RDONLY | os.O_CLOEXEC)
        self._pack_pid = os.getpid()
        speakers = h.get("speakers")
        self.speaker_names = None
        self.speakers = None
        if speakers is not None and arch.use_global_cond:
            if max(speakers) >= arch.n_speakers:
                raise ValueError(f"{path}: pack has speaker ids up to {max(speakers)} but "
                                 f"arch.n_speakers={arch.n_speakers}")
            self.speakers = list(speakers)
            self.speaker_names = h.get("speaker_names")
        elif speakers is not None:
            warnings.warn(f"{path} carries speaker labels but arch.n_speakers == 0; "
                          "training unconditioned")
        self.index = WindowIndex(
            [geometry.num_windows(int(off[i + 1] - off[i]), window_size) for i in range(n_files)])
        if not len(self.index):
            raise ValueError("Corpus yields no training windows")
        return self

    def _pack_file(self) -> int:
        """The pack's descriptor for this process: a forked child opens its
        own rather than share the parent's."""
        if self._pack_pid != os.getpid():
            self._pack_fd = os.open(self._pack_path, os.O_RDONLY | os.O_CLOEXEC)
            self._pack_pid = os.getpid()
        return self._pack_fd

    def __del__(self):
        fd = self._pack_fd
        if fd is not None and getattr(self, "_pack_pid", None) == os.getpid():
            try:
                os.close(fd)
            except Exception:   # interpreter shutdown may have torn down os
                pass

    def example(self, fi: int, wi: int):
        return geometry.extract_window(self.encoded[fi], self.window_size, self.r_field, wi)

    def _packed_corpus(self):
        """(enc_concat int32 or the pack's uint8, offsets int64) for the
        native assembler."""
        if self._packed is None:
            offsets = np.zeros(len(self.encoded) + 1, dtype=np.int64)
            np.cumsum([len(e) for e in self.encoded], out=offsets[1:])
            concat = np.concatenate(self.encoded).astype(np.int32, copy=False)
            self._packed = (np.ascontiguousarray(concat), offsets)
        return self._packed

    def examples_batch(self, pairs: Sequence[tuple]):
        """Batched (inputs, targets, mask) for B (file, window) pairs: the
        native assembler (a pack by pread), or row by row in Python with the
        tier off; the same bits either way."""
        from . import native

        if native.is_available():
            if self._pack_fd is not None:
                return native.assemble_windows_fd(
                    self._pack_file(), self._pack_enc_pos, self._pack_itemsize,
                    self._packed[1], pairs, self.window_size, self.r_field)
            enc, offsets = self._packed_corpus()
            return native.assemble_windows(enc, offsets, pairs, self.window_size, self.r_field)
        rows = [self.example(*p) for p in pairs]
        return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]),
                np.stack([r[2] for r in rows]))

    def _window_segment(self, fi: int, wi: int) -> np.ndarray:
        """Float waveform over the window's model-input span (R - 1 + W
        samples from t0 - R), zero where the span leaves the file."""
        if self.waves is None:
            raise ValueError("this corpus carries no float waveforms (a classes-only pack); "
                             "mel frames need `cli pack --with-waves`")
        t0, _ = geometry.window_bounds(len(self.encoded[fi]), self.window_size, wi)
        in_start = t0 - self.r_field
        in_len = self.r_field - 1 + self.window_size
        wav = self.waves[fi]
        lo, hi = max(in_start, 0), min(in_start + in_len, len(wav))
        seg = np.zeros(in_len, dtype=np.float32)
        seg[lo - in_start: hi - in_start] = wav[lo:hi]
        return seg

    def mel_for_windows(self, pairs: Sequence[tuple], n_frames: int) -> np.ndarray:
        """(B, n_frames, n_mels) log-mel frames of a batch of windows, one
        batched call: frame k of row j covers samples from in_start_j + k *
        hop, so the upsampled conditioning lines up with `inputs`. Frames
        past the spectrogram's are zero."""
        arch = self.arch
        segs = torch.from_numpy(np.stack([self._window_segment(fi, wi) for fi, wi in pairs]))
        frames = log_mel_spectrogram(segs, n_mels=arch.n_mels, hop=arch.hop_size,
                                     sample_rate=arch.sample_rate).numpy()
        out = np.zeros((len(pairs), n_frames, arch.n_mels), dtype=np.float32)
        n = min(n_frames, frames.shape[1])
        out[:, :n] = frames[:, :n]
        return out


def mel_frames(corpus: Corpus) -> int:
    """Mel frames per window of the corpus: ceil((R - 1 + W) / hop)."""
    return -(-(corpus.r_field - 1 + corpus.window_size) // corpus.arch.hop_size)


class LaneSchedule:
    """Lane-continuous ("virtual batch") window order: one seeded
    permutation of the FILES defines a circle of all n (file, window) pairs;
    lane k starts at (k * n) // B and advances one window per step, so a
    lane walks consecutive spans of one file."""

    def __init__(self, corpus: Corpus, train: TrainConfig):
        rng = np.random.default_rng(np.random.SeedSequence([train.seed, 7]))
        self.file_order = rng.permutation(len(corpus.encoded))
        counts = [geometry.num_windows(len(corpus.encoded[fi]), corpus.window_size)
                  for fi in self.file_order]
        self.prefix = np.concatenate([[0], np.cumsum(counts)])
        self.n = int(self.prefix[-1])
        self.batch_size = train.batch_size

    def pair(self, lane: int, step: int) -> tuple:
        """(file, window) for `lane` at `step`."""
        pos = (lane * self.n // self.batch_size + step) % self.n
        j = int(np.searchsorted(self.prefix, pos, side="right")) - 1
        return int(self.file_order[j]), int(pos - self.prefix[j])


def load_corpus(path: str, arch: ArchConfig, window_size: int) -> Corpus:
    """Corpus from a directory of wavs (in memory) or a packed corpus file
    (on disk; `pack.pack_corpus`, `cli pack`)."""
    if os.path.isfile(path):
        return Corpus.from_pack(path, arch, window_size)
    return Corpus.from_dir(path, arch, window_size)


def make_batches(
    corpus: Corpus,
    train: TrainConfig,
    host_id: int = 0,
    host_count: int = 1,
    start_step: int = 0,
    with_mel: bool = False,
) -> Iterator[Batch]:
    """Infinite deterministic batch stream; the host takes rows
    host_id::host_count. Each epoch is a seeded permutation of all windows
    (per ROW: global position g = step * B + k draws perm_{g // n}[g % n],
    so a batch across an epoch seam takes its tail from the next epoch);
    with train.lane_continuous each lane walks files instead. `start_step`
    resumes exactly (the dataset cursor is the step count). `with_mel` adds
    each window's log-mel frames (Corpus.mel_for_windows)."""
    if with_mel and not corpus.arch.use_local_cond:
        raise ValueError("with_mel needs a mel-conditioned arch (arch.n_mels > 0)")
    if train.batch_size % host_count:
        raise ValueError("global batch size must divide evenly across hosts")
    n = len(corpus.index)
    lanes = LaneSchedule(corpus, train) if train.lane_continuous else None
    step = start_step
    perms: dict[int, np.ndarray] = {}  # epoch -> permutation (<= 2 live)

    def perm_for(epoch: int) -> np.ndarray:
        p = perms.get(epoch)
        if p is None:
            rng = np.random.default_rng(np.random.SeedSequence([train.seed, epoch]))
            p = perms[epoch] = rng.permutation(n)
            for e in [e for e in perms if e < epoch - 1]:
                del perms[e]
        return p

    while True:
        if lanes is not None:
            pairs = [lanes.pair(k, step) for k in range(train.batch_size)][host_id::host_count]
        else:
            base = step * train.batch_size
            picks = [perm_for((base + k) // n)[(base + k) % n]
                     for k in range(train.batch_size)]
            pairs = [corpus.index[r] for r in picks[host_id::host_count]]
        inputs, targets, mask = corpus.examples_batch(pairs)
        if corpus.arch.mol:   # PCM values -> samples in [-1, 1)
            inputs = inputs.astype(np.float32) / np.float32(32768.0)
            targets = targets.astype(np.float32) / np.float32(32768.0)
        mel = corpus.mel_for_windows(pairs, mel_frames(corpus)) if with_mel else None
        speaker = None
        if corpus.speakers is not None:
            speaker = np.asarray([corpus.speakers[p[0]] for p in pairs], dtype=np.int32)
        yield Batch(inputs, targets, mask, mel, speaker)
        step += 1


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run `iterator` in a daemon thread, keeping `depth` items ready; an
    exception in the producer is raised on the consumer side. Closing the
    returned generator (or dropping it) stops the thread and waits for it:
    a daemon thread still inside native code when the interpreter exits
    can abort the process ("terminate called without an active
    exception")."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    closed = threading.Event()

    def put(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except Exception as e:  # surfaced to the consumer below
            put(e)
        put(stop)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            with span("data.wait"):
                item = q.get()
            if item is stop:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        closed.set()
        thread.join(timeout=60.0)  # the item in hand, then at most 0.1 s


def synthetic_corpus(
    arch: ArchConfig,
    window_size: int,
    n_files: int = 4,
    file_len: int = 16000,
    seed: int = 0,
) -> Corpus:
    """Deterministic synthetic corpus (mixed sinusoids + noise), the same
    waves as the JAX package's for the same arguments."""
    rng = np.random.default_rng(seed)
    waves = []
    for _ in range(n_files):
        t = np.arange(file_len, dtype=np.float32) / arch.sample_rate
        f0 = rng.uniform(80, 400)
        w = (0.5 * np.sin(2 * np.pi * f0 * t)
             + 0.2 * np.sin(2 * np.pi * 2.7 * f0 * t)
             + 0.05 * rng.standard_normal(file_len))
        waves.append(np.clip(w, -1, 1).astype(np.float32))
    return Corpus(waves, arch, window_size)
