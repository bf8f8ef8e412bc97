"""The `tacotron2_mol.train` cell on the CPU at a small size: its files found
by name, whole runs correct under the cell's limits, the faults coming out
not correct, the fp8 control not correct at the configuration's widths, the
reference against the port's CPU path, and `lib/mol_costs.py` against hand
counts."""
import copy
import json
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.lib import mol_costs, mol_signals
from portbench.reference import mol as RM

from .tiny import BENCH, ROOT

CELL = "tacotron2_mol.train"
TRAFFIC = {"corpus_files": 4, "file_s": 0.2, "check_gen_lanes": 2, "check_gen_samples": 64}


def config(dtype: str = "float32") -> dict:
    """The cell's configuration at a CPU size: the layout (mel through two
    stages, 10 components, 24 kHz), small widths, the recipe's flags."""
    c = copy.deepcopy(json.loads((ROOT / "portbench" / "configs" / "tacotron2_mol.json").read_text()))
    c["arch"].update(n_blocks=1, n_layers_per_block=3, residual_channels=16, skip_channels=32,
                     gate_channels=16, n_mels=8, cond_channels=8, upsample_factors=[2, 3],
                     compute_dtype=dtype)
    c["train"].update(batch_size=2, window_size=256)
    return c


def run(seed: int, dtype: str = "float32") -> dict:
    torch.set_num_threads(2)
    return harness.run_cell(BENCH, CELL, seed, 1, False, "cpu", time.perf_counter(),
                            config(dtype), TRAFFIC)


def test_files_resolve_and_costs():
    cell = harness.find_cell(BENCH, CELL)
    assert cell["chips"] == 1 and cell["config"] == "tacotron2_mol"
    traffic = harness.load_json(ROOT / "portbench" / "traffic" / "train_mol.json")
    assert traffic["driver"] == "train_mol"
    limits = harness.load_json(ROOT / "portbench" / "limits" / f"{CELL}.json")
    assert set(limits) <= {"loss_gap", "loss1_gap", "grad_gap", "change_gap", "broad_grad_gap",
                           "gen_gap"}
    names = [m["name"] for m in harness.metrics_for(BENCH, CELL, "per_layer")]
    for want in ("mol_post_roofline", "mol_head_ms.train", "mfu.mol_train",
                 "train_stack_fwd_roofline", "idle_share.train", "upsample_idle_ms.train"):
        assert want in names
    assert "mfu.train" not in names
    for m in harness.metrics_for(BENCH, CELL, "per_layer"):
        assert callable(harness.load_reader(m["name"]).read)
    arch = harness.load_json(ROOT / "portbench" / "configs" / "tacotron2_mol.json")["arch"]
    s, n3, b, w = 256, 30, 8, 7200
    t = 3071 - 1 + w
    fwd = mol_costs.mol_post_cost(arch, b, t, w, False)
    assert fwd == (4 * b * w * s + 8 * b * w + 4 * (s * n3 + n3) + 4, 2 * b * w * s * n3)
    bwd = mol_costs.mol_post_cost(arch, b, t, w, True)
    assert bwd == (fwd[0] + 4 * b * t * s + 4 * (s * n3 + n3), 3 * fwd[1])
    # 1,673,246 parameters: input conv 192, stack 30 x 37,312, head 7,710,
    # w_cond 30 x 8,192, projection 5,184, stages 31 x 4,096 + 64 and 41 x 4,096 + 64.
    assert mol_costs.n_params(arch) == 192 + 30 * 37312 + 7710 + 30 * 8192 + 5184 + (
        31 * 4096 + 64) + (41 * 4096 + 64)
    assert 0 < mol_costs.mol_post_bound_ms(arch, b, w) < 0.1


def test_params_match_the_program_layout():
    """The seeded weights have the program's leaves and shapes."""
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.models.wavenet import init_params
    from lb_wavenet_tpu_torch.train import tree_leaves, tree_paths

    cfg = config()
    mine = mol_signals.make_params(cfg["arch"], 5, torch.device("cpu"))
    prog = init_params(0, Config.from_dict(cfg).arch)
    assert tree_paths(mine) == tree_paths(prog)
    assert [x.shape for x in tree_leaves(mine)] == [x.shape for x in tree_leaves(prog)]


def test_reference_against_the_ports_forward():
    """The benchmark's reference and the port's plain forward give the same
    head outputs from the same weights and samples."""
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.models.wavenet import forward

    cfg = config()
    arch = cfg["arch"]
    p = mol_signals.make_params(arch, 7, torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(0).integers(-32768, 32767, (2, 90)) / 32768.0)
    x = x.to(torch.float32)
    got = forward(p, Config.from_dict(cfg).arch, x)
    torch.testing.assert_close(got, RM.head_outputs(p, arch, x, "float32"), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_run_is_correct(dtype):
    out = run(2 ** 31 + 19, dtype)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"loss1_gap", "grad_gap", "change_gap", "broad_grad_gap",
                                  "gen_gap"}
    assert {"train_samples_per_s", "setup_s"} <= set(out["metrics"])
    assert out["info"]["generated"] == [2, 64]


@pytest.fixture
def half_batch(monkeypatch):
    from lb_wavenet_tpu_torch import train as PT

    real = PT.train_step

    def broken(state, batch, arch, train):
        half = batch["inputs"].shape[0] // 2
        return real(state, {k: v[:half] for k, v in batch.items()}, arch, train)

    monkeypatch.setattr(PT, "train_step", broken)


@pytest.fixture
def unchanged_state(monkeypatch):
    from lb_wavenet_tpu_torch import train as PT

    def broken(state, batch, arch, train):
        loss, _ = PT.value_and_grads(state.params, batch, arch, train)
        return state, loss

    monkeypatch.setattr(PT, "train_step", broken)


@pytest.fixture
def skewed_head(monkeypatch):
    """Generation whose head outputs are moved after the step."""
    from lb_wavenet_tpu_torch import generate as G

    real = G.generate_classes

    def broken(*a, **kw):
        x, y = real(*a, **kw)
        return x, y * 1.2

    monkeypatch.setattr(G, "generate_classes", broken)


@pytest.fixture
def halved_backward(monkeypatch):
    """The head pair's backward hands the stack half its skip gradient."""
    from lb_wavenet_tpu_torch.ops.cuda import post_mol as PM

    real = PM.post_mol_bwd_plain

    def broken(*a, **kw):
        dskip, grads = real(*a, **kw)
        return 0.5 * dskip, grads

    monkeypatch.setattr(PM, "post_mol_bwd_plain", broken)


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_state", "skewed_head",
                                   "halved_backward"])
def test_fault_is_not_correct(fault, request):
    request.getfixturevalue(fault)
    out = run(41)
    assert not out["correct"], out["checks"]
    if fault == "halved_backward":   # Adam's steps hide it; the broad gradient shows it
        assert out["checks"]["broad_grad_gap"]["value"] > out["checks"]["broad_grad_gap"]["limit"]


def test_fp8_control_is_not_correct():
    """The control through the cell's own check and the harness's verdict:
    the reference in fp8 e4m3 (the nearest precision below the
    configuration's bfloat16) in the program's place, at the
    configuration's widths and depth with a shorter window and batch than
    the cell times (the chip readings at the cell's size are
    `python3 -m portbench.control_mol`'s, in PERF.md)."""
    from portbench.drivers import train_mol
    from portbench.harness import _passes

    torch.set_num_threads(4)
    cfg = copy.deepcopy(json.loads(
        (ROOT / "portbench" / "configs" / "tacotron2_mol.json").read_text()))
    cfg["train"].update(batch_size=2, window_size=256)
    run = harness.make_run(BENCH, CELL, 2 ** 31 + 23, 1, False, "cpu", time.perf_counter(),
                           cfg, {"corpus_files": 2, "file_s": 0.5, "check_gen_lanes": 1,
                                 "check_gen_samples": 96})
    arch, train = run.arch, run.train
    params = mol_signals.make_params(arch, run.seed, run.device)
    w = train_mol.waves(run)
    seed = run.seed % (1 << 31)
    losses, g, p = RM.reference_steps(params, arch, train, w, seed, 3, "fp8", run.device)
    _, g_broad, _ = RM.reference_steps(RM.broaden(params, arch, train_mol.BROAD_SHIFT), arch,
                                       train, w, seed, 1, "fp8", run.device)
    frames = train_mol.gen_frames(run, w)
    x = torch.from_numpy(RM.pcm16(w[0][:96]) / 32768.0).to(torch.float32)[None]
    prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
    cond = RM.model.upsample(params["upsampler"], arch, frames)[:, :96]
    with torch.no_grad():
        y = RM.head_outputs(params, arch, prev, "fp8", cond)
    run.check_state.update(
        params=params, waves=w, loader_seed=seed,
        program={"losses": losses, "grad": g, "params": p, "broad_grad": g_broad},
        gen={"samples": x, "y": y, "frames": frames})
    rows = {n: (v, lim) for n, v, lim in train_mol.check(run)}
    assert not all(_passes(v, lim) for v, lim in rows.values()), rows
    v, lim = rows["broad_grad_gap"]
    assert not _passes(v, lim), rows
