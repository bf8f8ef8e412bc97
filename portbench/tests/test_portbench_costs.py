"""The benchmark's frozen cost arithmetic against the port's and PERF.md's
bounds."""
import json

import pytest

from portbench.lib import costs

from .tiny import ROOT


def arch(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())["arch"]


def test_mega_bound_matches_perf():
    """PERF.md row 2: mega's bound is 1.320 ms at B=512, T=1024 (operations)."""
    ms, kind = costs.bound_ms(*costs.mega_cost(arch("wavenet30"), 512, 1024, 3, 2))
    assert kind == "operations"
    assert round(ms, 3) == 1.320


def test_train_step_bound_matches_perf():
    """PERF.md / `cli info`: the recipe's train step bound is 0.9395 ms."""
    a = arch("wavenet30")
    assert round(costs.train_step_bound(a, 8, 10240)["step_ms"], 4) == 0.9395


@pytest.mark.parametrize("name", ["wavenet30", "wavenet30_mel"])
def test_costs_equal_the_ports(name):
    """The frozen copies give the port's numbers at the cells' shapes, and
    the shape-only parameter count the port's count of its init."""
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.utils import profiling as P

    a = arch(name)
    pa = Config.from_dict({"arch": a}).arch
    cc = costs.cond_width(a)
    assert costs.mega_cost(a, 1024, 1024, 3, 2, cc) == P.mega_cost(pa, 1024, 1024, 3, 2, cc)
    for bwd in (False, True):
        assert costs.train_stack_cost(a, 8, 13310, 2, bwd, cc) == \
            P.train_stack_cost(pa, 8, 13310, 2, bwd, cc)
    assert costs.n_params(a) == P.n_params(pa)
    sol = P.train_step_speed_of_light(pa, 8, 6144)
    mine = costs.train_step_bound(a, 8, 6144)
    assert mine["flops"] == sol["mxu_flops_per_step"]
    assert mine["step_ms"] == pytest.approx(sol["sol_step_ms"], rel=1e-12)
