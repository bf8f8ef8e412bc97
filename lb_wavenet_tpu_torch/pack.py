"""Out-of-core packed corpus (port of `lb_wavenet_tpu/pack.py`): training
on corpora larger than host memory.

The in-RAM Corpus (data.py) holds float waves and int32 classes, about 8
bytes a sample (46 GB for 100 hours of 16 kHz audio). A pack holds the
mu-law classes once, in one flat file (uint8 for Q <= 256: 1 byte a
sample), and training reads each batch's windows from it with pread(2)
through the native tier (native/loader.cpp), so host RSS stays O(batch)
whatever the corpus size. The format is the JAX package's byte for byte: a
pack written by either package opens in the other.

Layout (one file, 64-byte-aligned sections whose positions follow from the
header, so readers never guess alignment):

    bytes 0..8    magic  b"WNPACK01"
    bytes 8..16   header length (uint64 LE)
    header        JSON: quant_channels, sample_rate, enc_dtype, n_files,
                  n_samples, with_waves, speakers?, speaker_names?, files?
    offsets       int64[n_files + 1]  prefix offsets into enc
    enc           enc_dtype[n_samples]  mu-law classes, all files packed
    waves         float32[n_samples]  (only with_waves: mel-conditioned
                  archs read the float waveform; classes-only packs are 4x
                  smaller)

The packer streams one file at a time through the native ingest tier (the
Python path for a wav that is not mono PCM16, or with the tier switched
off): peak RAM is one audio file. A pack stores exactly the classes the
in-RAM loader would hold, so batches from a pack-backed Corpus equal the
in-RAM ones bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import tempfile
from typing import Optional, Sequence

import numpy as np

MAGIC = b"WNPACK01"
_ALIGN = 64


def _align(pos: int) -> int:
    return -(-pos // _ALIGN) * _ALIGN


def _positions(header: dict, header_len: int) -> dict:
    """Byte positions of the binary sections, derived (not stored)."""
    n_files = header["n_files"]
    n_samples = header["n_samples"]
    enc_itemsize = np.dtype(header["enc_dtype"]).itemsize
    offsets_pos = _align(16 + header_len)
    enc_pos = _align(offsets_pos + 8 * (n_files + 1))
    waves_pos = (
        _align(enc_pos + enc_itemsize * n_samples)
        if header["with_waves"] else None
    )
    return {"offsets": offsets_pos, "enc": enc_pos, "waves": waves_pos}


class PackWriter:
    """Streaming pack writer: add_file() per audio file, then close().

    Sections are staged in sibling temp files (enc/waves append-only) and
    assembled into the final pack atomically at close — an interrupted pack
    never leaves a truncated file behind the final name. Peak RAM is one
    file's arrays plus the F+1 offsets.
    """

    def __init__(
        self,
        out_path: str,
        quant_channels: int,
        sample_rate: int,
        with_waves: bool = False,
    ):
        self.out_path = out_path
        self.quant_channels = quant_channels
        self.sample_rate = sample_rate
        self.with_waves = with_waves
        # uint8 holds every class for Q <= 256 — the 4x disk/page-cache win
        # that makes 100h-scale practical; wider quantization stays int32.
        self.enc_dtype = "uint8" if quant_channels <= 256 else "int32"
        self._lengths: list[int] = []
        self._dir = os.path.dirname(os.path.abspath(out_path))
        os.makedirs(self._dir, exist_ok=True)
        self._enc_tmp = tempfile.NamedTemporaryFile(
            dir=self._dir, suffix=".enc.tmp", delete=False
        )
        self._waves_tmp = (
            tempfile.NamedTemporaryFile(
                dir=self._dir, suffix=".wav.tmp", delete=False
            )
            if with_waves else None
        )
        self._closed = False

    def add_file(
        self, encoded: np.ndarray, wave: Optional[np.ndarray] = None
    ) -> None:
        encoded = np.asarray(encoded)
        if encoded.ndim != 1:
            raise ValueError(f"encoded must be 1-D, got {encoded.shape}")
        if self.enc_dtype == "uint8":
            if encoded.size and (
                encoded.min() < 0 or encoded.max() >= 256
            ):
                raise ValueError("classes out of uint8 range")
        self._enc_tmp.write(
            np.ascontiguousarray(encoded, dtype=self.enc_dtype).tobytes()
        )
        if self.with_waves:
            if wave is None:
                raise ValueError("with_waves pack needs the float waveform")
            wave = np.ascontiguousarray(wave, dtype=np.float32)
            if wave.shape != encoded.shape:
                raise ValueError(
                    f"wave {wave.shape} != encoded {encoded.shape}"
                )
            self._waves_tmp.write(wave.tobytes())
        self._lengths.append(int(encoded.size))

    def close(
        self,
        speakers: Optional[Sequence[int]] = None,
        speaker_names: Optional[Sequence[str]] = None,
        files: Optional[Sequence[str]] = None,
    ) -> dict:
        """Assemble the final pack; returns the header dict."""
        if self._closed:
            raise RuntimeError("PackWriter already closed")
        self._closed = True
        self._enc_tmp.flush()
        if self._waves_tmp is not None:
            self._waves_tmp.flush()
        offsets = np.zeros(len(self._lengths) + 1, dtype=np.int64)
        np.cumsum(self._lengths, out=offsets[1:])
        header = {
            "quant_channels": self.quant_channels,
            "sample_rate": self.sample_rate,
            "enc_dtype": self.enc_dtype,
            "n_files": len(self._lengths),
            "n_samples": int(offsets[-1]),
            "with_waves": self.with_waves,
        }
        if speakers is not None:
            header["speakers"] = [int(s) for s in speakers]
        if speaker_names is not None:
            header["speaker_names"] = list(speaker_names)
        if files is not None:
            header["files"] = [os.path.basename(f) for f in files]
        hbytes = json.dumps(header).encode()
        pos = _positions(header, len(hbytes))

        with tempfile.NamedTemporaryFile(
            dir=self._dir, suffix=".pack.tmp", delete=False
        ) as out:
            out.write(MAGIC)
            out.write(struct.pack("<Q", len(hbytes)))
            out.write(hbytes)
            out.write(b"\0" * (pos["offsets"] - out.tell()))
            out.write(offsets.tobytes())
            out.write(b"\0" * (pos["enc"] - out.tell()))
            self._enc_tmp.seek(0)
            shutil.copyfileobj(self._enc_tmp.file, out.file, 1 << 22)
            if self.with_waves:
                out.write(b"\0" * (pos["waves"] - out.tell()))
                self._waves_tmp.seek(0)
                shutil.copyfileobj(self._waves_tmp.file, out.file, 1 << 22)
            tmp_name = out.name
        os.replace(tmp_name, self.out_path)
        self._cleanup()
        return header

    def _cleanup(self) -> None:
        for tmp in (self._enc_tmp, self._waves_tmp):
            if tmp is not None:
                tmp.close()
                try:
                    os.unlink(tmp.name)
                except OSError:
                    pass

    def abort(self) -> None:
        self._closed = True
        self._cleanup()


@dataclasses.dataclass
class PackData:
    """An opened pack: header + mmap views (lazily paged, shared RO)."""

    header: dict
    offsets: np.ndarray            # int64[F + 1], read eagerly (tiny)
    enc: np.ndarray                # memmap enc_dtype[n_samples]
    waves: Optional[np.ndarray]    # memmap float32[n_samples] | None
    path: str = ""
    enc_pos: int = 0               # byte position of the enc section


def open_pack(path: str) -> PackData:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != MAGIC:
            raise ValueError(
                f"{path}: not a corpus pack (magic {magic!r} != {MAGIC!r})"
            )
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    pos = _positions(header, hlen)
    n_files, n_samples = header["n_files"], header["n_samples"]
    with open(path, "rb") as f:
        f.seek(pos["offsets"])
        offsets = np.frombuffer(
            f.read(8 * (n_files + 1)), dtype=np.int64
        ).copy()
    if offsets[-1] != n_samples:
        raise ValueError(
            f"{path}: offsets[-1]={offsets[-1]} != n_samples={n_samples} "
            f"(truncated or corrupt pack)"
        )
    enc = np.memmap(
        path, dtype=np.dtype(header["enc_dtype"]), mode="r",
        offset=pos["enc"], shape=(n_samples,),
    )
    waves = None
    if header["with_waves"]:
        waves = np.memmap(
            path, dtype=np.float32, mode="r",
            offset=pos["waves"], shape=(n_samples,),
        )
    # Training draws windows in a seeded random permutation: the kernel's
    # default readahead faults in hundreds of KB around each touched window,
    # defeating O(batch) residency for readers of the mapping (mel
    # segments). MADV_RANDOM keeps faults to the pages actually read.
    import mmap as _mmap

    for arr in (enc, waves):
        if arr is not None and hasattr(arr, "_mmap"):
            try:
                arr._mmap.madvise(_mmap.MADV_RANDOM)
            except (AttributeError, OSError, ValueError):
                pass  # non-Linux / old-Python: correctness is unaffected
    return PackData(header, offsets, enc, waves, path, pos["enc"])


def pack_corpus(
    data_dir: str,
    out_path: str,
    quant_channels: int = 256,
    sample_rate: int = 16000,
    with_waves: bool = False,
    n_speakers: int = 0,
) -> dict:
    """Pack a wav directory (flat or per-speaker layout, exactly
    data.Corpus.from_dir's rules) into `out_path`; returns the header.

    Streams one file at a time through the native ingest tier (the Python
    path file by file where it does not take one): peak RAM is one audio
    file. `with_waves` stores the float32 waveform section that
    mel-conditioned archs need.
    """
    import torch

    from . import native
    from .data import discover_layout, load_wav
    from .ops.mulaw import mu_law_encode

    paths, speakers, speaker_names = discover_layout(
        data_dir, n_speakers=n_speakers
    )
    use_native = native.is_available()
    if use_native:
        native.mulaw_lut(quant_channels)
    writer = PackWriter(
        out_path, quant_channels, sample_rate, with_waves=with_waves
    )
    try:
        for p in paths:
            res = None
            if use_native:
                with open(p, "rb") as f:
                    raw = f.read()
                try:
                    res = native.ingest_wav(raw, quant_channels)
                except ValueError as e:
                    raise ValueError(f"{p}: {e}") from e
            if res is None:  # tier off / not mono PCM16: the Python path
                wav, sr = load_wav(p)
                enc = mu_law_encode(torch.from_numpy(wav), quant_channels).numpy()
            else:
                wav, enc, sr = res
            if sr != sample_rate:
                raise ValueError(
                    f"{p}: sample rate {sr} != configured {sample_rate}"
                )
            writer.add_file(enc, wave=wav if with_waves else None)
    except BaseException:
        writer.abort()
        raise
    return writer.close(
        speakers=speakers, speaker_names=speaker_names, files=paths
    )
