"""The metric readers on made-up traces and records: kernel attribution by
csrc name, the interval union, shares and percentiles."""
import types

import pytest

from portbench import harness
from portbench.lib import costs, readers
from portbench.lib.trace import TraceData, union_us

from .tiny import BENCH, ROOT


def run_of(cell, **kw):
    cfg = harness.load_json(ROOT / "portbench" / "configs" / f"{cell.split('.')[0]}.json")
    traffic = harness.load_json(ROOT / "portbench" / "traffic"
                                / f"{harness.find_cell(BENCH, cell)['traffic']}.json")
    r = types.SimpleNamespace(arch=cfg["arch"], train=cfg["train"], traffic=traffic,
                              trace_data=None, t0=0.0, t1=10.0, window_s=10.0)
    r.__dict__.update(kw)
    return r


def test_union_and_idle_share():
    assert union_us([(0, 10), (5, 20), (30, 40)]) == 30
    td = TraceData([("k", 0.0, 2e6), ("k", 1e6, 3e6)], [], 4.0)
    assert td.busy_s == 3.0
    assert readers.idle_share(run_of("wavenet30.train", trace_data=td)) == pytest.approx(25.0)
    assert td.idle_gaps() == []
    gap = TraceData([("k", 0.0, 1e6), ("k", 3e6, 4e6)], [("optimizer", 1.5e6, 2.5e6, 0.0)], 4.0)
    assert gap.idle_gaps() == [["optimizer", 2.0]]


def test_stack_kernels_split_forward_and_backward():
    fwd, bwd = readers.stack_kernels(False), readers.stack_kernels(True)
    names = {"void wn::tsc::fwd_layer_tc<true>(wn::tsc::FwdTc)": (True, False),
             "wn::tsc::fwd_skip_tc(__nv_bfloat16 const*)": (True, False),
             "void wn::tsc::bwd_layer_tc<true>(wn::tsc::BwdTc)": (False, True),
             "wn::tsc::reduce_tc(float const*)": (False, True),
             "void wn::reduce_partials(float const*, float*, int)": (False, True),
             "wn::ptc::reduce_tc(float const*)": (False, False),
             "wn::ptc::wgrad_tc(x)": (False, False),
             "void wn::mega_tc_kernel<3>(wn::MegaArgs, int)": (False, False)}
    for name, want in names.items():
        assert (fwd(name), bwd(name)) == want, name


def test_stack_roofline_per_call():
    """Two calls whose kernels take 2.38 ms each: the forward's bound is
    0.238 ms at the recipe's shape (PERF.md row 5), so 10%."""
    kern = [("void wn::tsc::fwd_layer_tc<true>(wn::tsc::FwdTc)", 0.0, 2380.0)] * 2
    spans = [("stack_fwd", 0.0, 1.0, 0.0)] * 2
    r = run_of("wavenet30.train", trace_data=TraceData(kern, spans, 1.0))
    assert readers.stack_roofline(r, backward=False) == pytest.approx(10.0, rel=2e-3)
    assert readers.stack_roofline(r, backward=True) is None


def test_mega_roofline_and_mfu():
    r = run_of("wavenet30.serve_full", deliveries=[(1.0, 1024 * 1024)],
               trace_data=TraceData([("void wn::mega_tc_kernel<3>(wn::MegaArgs, int)", 0.0,
                                      132000.0)], [], 1.0))
    bound, _ = costs.bound_ms(*costs.mega_cost(r.arch, 1024, 1024, 3, 2))
    assert readers.mega_roofline(r) == pytest.approx(100 * bound / 132.0)
    assert readers.serve_mfu(r) == pytest.approx(
        100 * 1024 * 1024 * costs.mega_flops_per_sample(r.arch) / 10.0 / 989e12)



