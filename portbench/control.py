"""The readings that the limits of `correct` are set from, on the chip at
the cell's own size, many seeds in one process.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 30

For every seed it runs the cell as a run does (a shorter window, long
enough to finish the mix's longest requests) and prints one JSON line with
the program's compared numbers (the lower readings). For the control
seeds it also prints the control's: the reference in the nearest precision
below the configuration's (fp8 e4m3 for bfloat16) put in the program's
place (serving: at each step of the same served classes, the gap of the
class the control puts first; training: the control's three steps against
the reference's), and for training the fault of half the batch left out,
the mean taken over the rest. A step that returns its state unchanged
reads 1 on change_gap by its definition and needs no run.

With --look (training) it also prints what parts the two sides after the
first step: per leaf, the elements whose first gradient has the other sign
in the program than in the reference (Adam's first update is -lr times
that sign, so each such element moves 2 lr apart), and the reference's
steps 2 and 3 taken on from the program's own state after step 1, whose
loss gaps against the program's then hold only what those steps add.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--look", action="store_true")
    args = ap.parse_args(argv)
    root = Path.cwd()
    sys.path.insert(0, str(root))
    from portbench.run import set_cache_dirs

    set_cache_dirs(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(bench, args.workload, seed, args.seconds, args.device,
                                  seed in controls, look=args.look)), flush=True)
    return 0


def readings(bench, cell, seed, seconds, device, control, config_override=None,
             traffic_override=None, look=False) -> dict:
    from portbench.harness import load_module, make_run

    run = make_run(bench, cell, seed, seconds, False, device, time.perf_counter(),
                   config_override, traffic_override)
    run.check_state["keep_step1"] = look
    driver = load_module("drivers", run.traffic["driver"])
    driver.drive(run)
    out = {"cell": cell, "seed": seed, "program": {n: v for n, v, _ in driver.check(run)},
           "info": run.info}
    if control:
        out.update(control_readings(run))
    if look:
        out["look"] = adam_look(run)
    return out


def adam_look(run) -> dict:
    """What parts program and reference after the first step (see the
    module's note): per leaf [elements, elements of the other sign, the
    largest |reference gradient| among those over the leaf's median
    |gradient|], their sum, and the loss gaps of steps 2 and 3 with the
    reference taken on from the program's state after step 1."""
    import torch

    from portbench.reference import checks

    st = run.check_state
    prog, (r_loss, r_g, _) = st["program"], st["ref"]
    leaves, total = {}, [0, 0]
    for k, g in r_g.items():
        pg = prog["grad"][k].to(g.device)
        other = (torch.sign(pg) * torch.sign(g)) < 0
        n = int(other.sum())
        med = float(g.abs().median())
        top = float(g[other].abs().max()) / max(med, 1e-30) if n else 0.0
        leaves["/".join(map(str, k))] = [g.numel(), n, top]
        total[0] += g.numel()
        total[1] += n
    prec = "bfloat16" if run.arch["compute_dtype"] == "bfloat16" else "float32"
    on = checks.reference_steps(st["params"], run.arch, run.train, st["waves"],
                                st["loader_seed"], 3, prec, run.device,
                                start=prog["step1"])[0]
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], r_loss)]
    return {"other_sign": leaves, "other_sign_total": total,
            "loss_gaps_by_step": gaps,
            "loss_gaps_taken_on": [abs(a - b) / abs(b) for a, b in zip(prog["losses"][1:], on)]}


def control_readings(run) -> dict:
    from portbench.reference import checks, model

    model.set_precision()
    st = run.check_state
    if "sample" in st:
        gaps = [checks.control_gap(st["params"], run.arch, cls, "fp8")
                for _, cls in st["sample"]]
        return {"control": {"served_gap": max(gaps)}, "tokens": sum(n for n, _, _ in st["sample"])}
    arch, train = run.arch, run.train
    ref = st["ref"]
    p0 = dict(checks.leaves(st["params"]))
    out = {}
    for name, prec, rows in (("control", "fp8", None),
                             ("half_batch", "bfloat16", train["batch_size"] // 2)):
        losses, g, p = checks.reference_steps(st["params"], arch, train, st["waves"],
                                              st["loader_seed"], 3, prec, run.device, rows)
        nums = checks.train_numbers({"losses": losses, "grad": g, "params": p}, ref, p0)
        out[name] = {k: nums[k] for k in ("loss_gaps", "grad_gap", "change_gap")}
    return out


if __name__ == "__main__":
    sys.exit(main())
