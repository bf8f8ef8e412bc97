"""Native (C++) host-side ingest and assembly tier of the port: compiled on
first use, loaded with ctypes (port of `lb_wavenet_tpu/native/`).

It owns the input pipeline's byte work: wav parsing, mu-law encoding (by a
table over the 65,536 PCM16 values computed by the port's torch encoder,
so it is bit-identical to `ops/mulaw.py` by construction) and
teacher-forcing window assembly, multithreaded and outside the GIL. No GPU
is involved.

Build: `loader.cpp` is compiled with `g++ -O3 -std=c++17 -shared -fPIC
-pthread` into `lb_wavenet_tpu_torch/build/loader-<source hash>.so`
(listed in `.gitignore`), to a temporary name first and then renamed, so
concurrent ranks and test workers are safe. A failed build raises, naming
the command and its stderr; nothing falls back. WAVENET_NATIVE_LOADER=0
asks for the Python path explicitly (and never builds). A wav that is not
mono PCM16 takes the Python path file by file, a rule about formats.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).with_name("loader.cpp")
BUILD = Path(__file__).resolve().parents[1] / "build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_loaded: list = []


def enabled() -> bool:
    """False when WAVENET_NATIVE_LOADER=0 asks for the Python path."""
    return os.environ.get("WAVENET_NATIVE_LOADER", "1") != "0"


def library_path() -> Path:
    """Where the library of the current source lives (built or not)."""
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD / f"loader-{tag}.so"


def build() -> Tuple[Path, bool]:
    """Compile loader.cpp unless its library exists; (path, built now).
    Raises RuntimeError with the command and g++'s stderr on failure."""
    target = library_path()
    if target.exists():
        return target, False
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise RuntimeError(f"native loader: {' '.join(cmd)} failed: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native loader: {' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, target)
    return target, True


def _i32p():
    return ctypes.POINTER(ctypes.c_int32)


def _lib() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    with _lock:
        if not _loaded:
            lib = ctypes.CDLL(str(build()[0]))
            i32, i64, f32 = _i32p(), ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float)
            lib.wavenet_ingest_wav.restype = ctypes.c_int64
            lib.wavenet_ingest_wav.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32, i32, f32,
                                               i32]
            tail = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32, i32, f32, ctypes.c_int32]
            for fn, enc_t in (("wavenet_assemble", i32),
                              ("wavenet_assemble_u8", ctypes.POINTER(ctypes.c_uint8))):
                f = getattr(lib, fn)
                f.restype = ctypes.c_int64
                f.argtypes = [enc_t, i64, ctypes.c_int64, i32, i32, *tail]
            lib.wavenet_assemble_fd.restype = ctypes.c_int64
            lib.wavenet_assemble_fd.argtypes = [ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
                                                i64, ctypes.c_int64, i32, i32, *tail]
            _loaded.append(lib)
        return _loaded[0]


def is_available() -> bool:
    """The tier is on (and then built and loaded: a failed build raises)."""
    if not enabled():
        return False
    _lib()
    return True


@functools.lru_cache(maxsize=4)
def mulaw_lut(quant_channels: int = 256) -> np.ndarray:
    """int32 class table over the PCM16 grid: lut[s + 32768] =
    mu_law_encode(s / 32768) for every int16 s, by the port's encoder."""
    import torch

    from ..ops.mulaw import mu_law_encode

    grid = torch.arange(-32768, 32768, dtype=torch.float32) / 32768.0
    lut = mu_law_encode(grid, quant_channels).numpy().astype(np.int32)
    lut.setflags(write=False)
    return lut


def ingest_wav(raw: bytes, quant_channels: int = 256
               ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Parse and encode one in-memory wav: (wave float32 in [-1, 1], int32
    classes, sample rate), or None where the Python path takes the file
    (the tier is off, or the wav is not mono PCM16). A malformed container
    raises ValueError."""
    if not enabled():   # the kill switch must not trigger a build
        return None
    lib = _lib()
    lut = mulaw_lut(quant_channels)
    max_n = len(raw) // 2 + 1
    enc = np.empty(max_n, dtype=np.int32)
    wav = np.empty(max_n, dtype=np.float32)
    sr = ctypes.c_int32(0)
    n = lib.wavenet_ingest_wav(
        raw, len(raw), lut.ctypes.data_as(_i32p()), enc.ctypes.data_as(_i32p()),
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.byref(sr))
    if n in (-2, -4):   # not PCM16 / not mono: the Python path reads it
        return None
    if n < 0:
        raise ValueError(f"malformed wav container (native parser code {n})")
    return wav[:n].copy(), enc[:n].copy(), int(sr.value)


def _batch_arrays(pairs, window_size: int, r_field: int):
    b = len(pairs)
    fis = np.ascontiguousarray([p[0] for p in pairs], dtype=np.int32)
    wis = np.ascontiguousarray([p[1] for p in pairs], dtype=np.int32)
    out = (np.empty((b, r_field - 1 + window_size), dtype=np.int32),
           np.empty((b, window_size), dtype=np.int32),
           np.empty((b, window_size), dtype=np.float32))
    return fis, wis, out


def _tail_args(fis, wis, out, window_size: int, r_field: int, n_threads):
    inputs, targets, mask = out
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 4)
    return (fis.ctypes.data_as(_i32p()), wis.ctypes.data_as(_i32p()), len(fis), window_size,
            r_field, inputs.ctypes.data_as(_i32p()), targets.ctypes.data_as(_i32p()),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(n_threads))


def _out_of_range(pairs, row: int, n_files: int, window_size: int) -> IndexError:
    return IndexError(f"window pair {pairs[row]} (row {row}) is out of range for the packed "
                      f"corpus ({n_files} files, W={window_size})")


def assemble_windows(enc_concat: np.ndarray, offsets: np.ndarray,
                     pairs: Sequence[Tuple[int, int]], window_size: int, r_field: int,
                     n_threads: Optional[int] = None
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """A batch of (inputs, targets, mask) windows, exactly
    ops/geometry.extract_window over the packed corpus (enc_concat int32, or
    uint8 as a pack stores it, widened during assembly; offsets int64 of
    length F + 1); None when the tier is off. A (fi, wi) pair outside the
    corpus raises IndexError naming it."""
    if not enabled():
        return None
    lib = _lib()
    if enc_concat.dtype not in (np.int32, np.uint8) or not enc_concat.flags.c_contiguous:
        raise ValueError(f"enc_concat must be contiguous int32 or uint8, got {enc_concat.dtype}")
    if offsets.dtype != np.int64 or not offsets.flags.c_contiguous:
        raise ValueError("offsets must be contiguous int64")
    fis, wis, out = _batch_arrays(pairs, window_size, r_field)
    if enc_concat.dtype == np.uint8:
        fn, enc_t = lib.wavenet_assemble_u8, ctypes.c_uint8
    else:
        fn, enc_t = lib.wavenet_assemble, ctypes.c_int32
    rc = fn(enc_concat.ctypes.data_as(ctypes.POINTER(enc_t)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(offsets) - 1,
            *_tail_args(fis, wis, out, window_size, r_field, n_threads))
    if rc < 0:
        raise _out_of_range(pairs, -rc - 1, len(offsets) - 1, window_size)
    return out


def assemble_windows_fd(fd: int, enc_byte_pos: int, itemsize: int, offsets: np.ndarray,
                        pairs: Sequence[Tuple[int, int]], window_size: int, r_field: int,
                        n_threads: Optional[int] = None
                        ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """assemble_windows over an on-disk pack by pread(2): the same output,
    O(batch) process residency. `fd` is a read-only descriptor of the pack,
    `enc_byte_pos` the byte position of its classes, `itemsize` 1 (uint8)
    or 4 (int32). None when the tier is off; OSError on an I/O failure."""
    if not enabled():
        return None
    lib = _lib()
    if offsets.dtype != np.int64 or not offsets.flags.c_contiguous:
        raise ValueError("offsets must be contiguous int64")
    fis, wis, out = _batch_arrays(pairs, window_size, r_field)
    rc = lib.wavenet_assemble_fd(
        int(fd), int(enc_byte_pos), int(itemsize),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(offsets) - 1,
        *_tail_args(fis, wis, out, window_size, r_field, n_threads))
    if rc == -(2 ** 63):   # INT64_MIN: I/O failure
        raise OSError("pread failed while assembling windows from the pack")
    if rc < 0:
        raise _out_of_range(pairs, -rc - 1, len(offsets) - 1, window_size)
    return out
