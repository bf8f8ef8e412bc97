"""The control comes out not correct: the reference in the nearest
precision below the configuration's (fp8 e4m3 for bfloat16) put in the
program's place, at the cells' widths and depth with shorter sequences and
a smaller batch than the cells time (the chip readings at the cells' own
sizes are `python3 -m portbench.control`'s, in PERF.md)."""
import json

import pytest
import torch

from portbench.lib import signals
from portbench.reference import checks, model

from .tiny import ROOT

CFG = ROOT / "portbench" / "configs"


def cell_config(name):
    return json.loads((CFG / f"{name}.json").read_text())


def limits(cell):
    return json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())


def greedy(params, arch, n):
    """The reference's own greedy classes (a sound program serves these)."""
    q = arch["quant_channels"]
    cls = []
    with torch.no_grad():
        for _ in range(n):
            x = torch.tensor([[q // 2] + cls], dtype=torch.int64)
            cls.append(int(model.logits(params, arch, x, "bfloat16")[0, -1].argmax()))
    return cls


def test_serving_control_fails():
    torch.set_num_threads(4)
    model.set_precision()
    arch = cell_config("wavenet30")["arch"]
    params = signals.make_params(arch, 5, torch.device("cpu"))
    cls = greedy(params, arch, 160)
    assert checks.served_gap(params, arch, cls) == 0.0
    gap = checks.control_gap(params, arch, cls, "fp8")
    assert gap > limits("wavenet30.serve_full")["served_gap"]


@pytest.mark.parametrize("cell,name", [("wavenet30.train", "wavenet30"),
                                       ("wavenet30_mel.train", "wavenet30_mel")])
def test_training_control_fails(cell, name):
    torch.set_num_threads(4)
    cfg = cell_config(name)
    arch, train = cfg["arch"], dict(cfg["train"], batch_size=2, window_size=256)
    params = signals.make_params(arch, 5, torch.device("cpu"))
    waves = [w.numpy() for w in signals.chords([110.0, 220.0], 16000, 16000, "cpu")]
    ref = checks.reference_steps(params, arch, train, waves, 3, 3, "bfloat16", "cpu")
    ctl = checks.reference_steps(params, arch, train, waves, 3, 3, "fp8", "cpu")
    p0 = dict(checks.leaves(params))
    nums = checks.train_numbers({"losses": ctl[0], "grad": ctl[1], "params": ctl[2]}, ref, p0)
    lim = limits(cell)
    assert any(nums[k] > lim[k] for k in lim), nums


def test_adam_look_takes_the_reference_on_from_the_programs_state():
    """control.py --look on a small mel run: every leaf is listed, and the
    reference taken on from the program's state after step 1 reads the
    program's step-2 loss as closely as the first step's."""
    from portbench import control

    from .tiny import BENCH, TRAFFIC, config

    torch.set_num_threads(2)
    out = control.readings(BENCH, "wavenet30_mel.train", 7, 1, "cpu", False,
                           config("wavenet30_mel.train"), TRAFFIC["wavenet30_mel.train"],
                           look=True)
    look = out["look"]
    assert len(look["other_sign"]) == out["info"]["leaves"]["compared"]
    n, other = look["other_sign_total"]
    assert n > 0 and 0 <= other < n
    assert len(look["loss_gaps_taken_on"]) == 2
    assert look["loss_gaps_taken_on"][0] <= max(10 * look["loss_gaps_by_step"][0], 1e-6)
