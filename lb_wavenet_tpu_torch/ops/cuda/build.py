"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded with ctypes. All sources are built
at first use, one `nvcc` process per source, started together. A library is
named after the hash of its sources, so an edited source rebuilds and an
unchanged one loads from `build/` (listed in `.gitignore`) at once. A failed
build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ...utils.profiling import span

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict = {}
# ptxas resource lines of the last build (registers, shared memory, spills).
build_log: dict = {}
# Seconds of each nvcc compile this process made.
build_seconds: dict = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    return BUILD / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every source (or those named) whose library is missing, one
    nvcc each, all at once; return {name: path}. The seconds of each
    compile made by this process go to `build_seconds`, its ptxas report
    to `build_log` and to a `.log` beside the library (read back into
    `build_log` when the library was built by another process)."""
    sources = [s for s in sorted(CSRC.glob("*.cu")) if names is None or s.stem in names]
    targets = {s.stem: _target(s) for s in sources}
    todo = [s for s in sources if not targets[s.stem].exists()]
    for s in sources:
        log = targets[s.stem].with_suffix(".log")
        if s not in todo and s.stem not in build_log and log.exists():
            build_log[s.stem] = log.read_text()
    if todo:
        BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()

        def compile_one(src: Path):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
            os.close(fd)
            t0 = time.perf_counter()
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            return src, tmp, proc, time.perf_counter() - t0

        with ThreadPoolExecutor(len(todo)) as ex:
            results = list(ex.map(compile_one, todo))
        failed = []
        for src, tmp, proc, seconds in results:
            build_log[src.stem] = proc.stdout
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{src.name}:\n{proc.stdout}")
            else:
                targets[src.stem].with_suffix(".log").write_text(proc.stdout)
                os.replace(tmp, targets[src.stem])
                build_seconds[src.stem] = seconds
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (built on first use)."""
    with _lock:
        if name not in _libs:
            for stem, path in build_all().items():
                _libs[stem] = ctypes.CDLL(str(path))
        return _libs[name]


_entries: dict = {}


def entry(lib: ctypes.CDLL, fn: str, argtypes, restype):
    """lib.fn with its argument and result types set, once per library."""
    key = (id(lib), fn)
    f = _entries.get(key)
    if f is None:
        f = getattr(lib, fn)
        f.argtypes, f.restype = argtypes, restype
        _entries[key] = f
    return f


def launch(lib: ctypes.CDLL, fn: str, args: ctypes.Structure, device) -> int:
    """Call `fn(&args, stream, &n)` on the current stream of `device`, inside
    the span `kernel.<fn>`; the function adds the kernels it launched to n.
    Raise with CUDA's message if a launch was refused. Returns n."""
    import torch

    f = entry(lib, fn, [ctypes.c_void_p] * 3, ctypes.c_int)
    n = ctypes.c_int(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    with span("kernel." + fn):
        err = f(ctypes.addressof(args), stream, ctypes.addressof(n))
    if err != 0:
        msg = entry(lib, "wn_error_string", [ctypes.c_int], ctypes.c_char_p)(err).decode()
        raise RuntimeError(f"{fn}: CUDA error {err}: {msg}")
    return n.value


def on_card(device, what: str) -> bool:
    """True for a CUDA device (launch the kernel), False for the CPU (run
    the plain version); anything else raises."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {device}")
    return device.type == "cuda"


@functools.lru_cache(maxsize=None)
def int32_table(values: tuple, device: str):
    """A small constant int32 tensor on `device` (e.g. the dilations),
    uploaded once per process."""
    import torch

    return torch.tensor(values, dtype=torch.int32, device=device)


_prepared: "OrderedDict" = OrderedDict()


def prepared(tag: str, sources: tuple, make):
    """`make()` (e.g. the weights cast to the compute dtype), computed once
    per `sources` and reused while each source tensor keeps its storage and
    has not been written in place since (its version counter). A view keys
    by its own shape and strides, so a slice of a weight (a rank's skip
    slice) is keyed apart from the whole. The entry holds the sources, so
    their storage cannot be reused by another tensor while it is cached; the
    few newest entries are kept."""
    import torch

    if torch.compiler.is_exporting():  # traced into the program: no storage to key by
        return make()
    key = (tag,) + tuple((t.data_ptr(), t._version, t.dtype, tuple(t.shape), t.stride())
                         for t in sources)
    hit = _prepared.get(key)
    if hit is None:
        hit = _prepared[key] = (sources, make())
        if len(_prepared) > 8:
            _prepared.popitem(last=False)
    else:
        _prepared.move_to_end(key)
    return hit[1]


def ptr(t) -> int:
    """Device pointer of a tensor (0 for None)."""
    return 0 if t is None else t.data_ptr()
