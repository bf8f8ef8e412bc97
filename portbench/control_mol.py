"""The readings that the limits of `tacotron2_mol.train`'s `correct` are set
from, on the chip at the cell's own size, many seeds in one process
(`control.py`'s counterpart for the mol cell, whose reference and controls
are its driver's own).

    python3 -m portbench.control_mol --seeds 1,2,3 --control-seeds 1 \\
        --seconds 2 [--gen-samples 24000]

For every seed it runs the cell as a run does (a shorter window) and
prints one JSON line with the program's compared numbers (the lower
readings). For the control seeds it adds the controls' (the upper ones):
the reference in fp8 e4m3 and half the batch left out against the
reference at the configuration's precision, and the fp8 reference's head
outputs over the program's generated samples (`drivers/train_mol.py`
`control_readings`). --gen-samples lengthens the generation the check
compares (24000: one second at 24 kHz).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

CELL = "tacotron2_mol.train"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--gen-samples", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = Path.cwd()
    sys.path.insert(0, str(root))
    from portbench.harness import load_module, make_run
    from portbench.run import set_cache_dirs

    set_cache_dirs(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    traffic = {"check_gen_samples": args.gen_samples} if args.gen_samples else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run = make_run(bench, CELL, seed, args.seconds, False, args.device, t0,
                       traffic_override=traffic)
        driver = load_module("drivers", run.traffic["driver"])
        driver.drive(run)
        out = {"cell": CELL, "seed": seed,
               "program": {n: v for n, v, _ in driver.check(run)},
               "steps_per_s": run.steps / run.window_s if run.steps else None,
               "generated": run.info.get("generated"),
               "loss_gaps_by_step": run.info.get("loss_gaps_by_step")}
        if seed in controls:
            out.update(driver.control_readings(run))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
