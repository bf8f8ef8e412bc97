"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It reads BENCHMARK.json there, runs the cell
on the card it starts on (lb_wavenet_tpu_torch, the PyTorch/CUDA port),
prints each compared number beside its limit as the last lines of standard
error, and one JSON line as the last line of standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
`checks` last. Without a card, without the port, or with JAX loaded in
this process once the window has closed, it prints no result and exits
non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lb_wavenet_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold,
    compared whole (lb_wavenet_tpu_torch is the port, not the JAX package)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so only
    the first run of a checkout builds (the port's nvcc libraries live in
    lb_wavenet_tpu_torch/build/ there already)."""
    cache = root / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    try:
        with open(root / "BENCHMARK.json") as f:
            bench = json.load(f)
    except OSError as e:
        print(f"portbench: no BENCHMARK.json in {root}: {e}", file=sys.stderr)
        return 2
    set_cache_dirs(root)
    sys.path.insert(0, str(root))
    from portbench.harness import find_cell, run_cell

    try:
        cell = find_cell(bench, args.workload)
    except KeyError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    try:
        import torch

        import lb_wavenet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not here: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the port's benchmark runs without JAX",
              file=sys.stderr)
        return 4
    for key, value in out.pop("info").items():
        print(f"{key}: {value}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(finite(out)), flush=True)
    return 0


def finite(x):
    """x with every infinite or NaN number as null (the result line stays
    strict JSON; such a number never passes its limit)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
