"""The plain reference against the port's CPU path at configs/tiny.json,
and whole runs of every cell on the CPU at a small size coming out
correct under the cells' own limits."""
import numpy as np
import pytest
import torch

from portbench.lib import signals
from portbench.reference import model

from .tiny import BENCH, config, run


@pytest.mark.parametrize("cell", ["wavenet30.serve_full", "wavenet30_mel.train"])
def test_reference_logits_equal_the_ports_forward(cell):
    """Teacher-forced logits of the reference and of the port's plain
    forward (models/wavenet.py), the same weights and classes."""
    from lb_wavenet_tpu_torch.config import Config
    from lb_wavenet_tpu_torch.models.conditioning import upsample_cond
    from lb_wavenet_tpu_torch.models.wavenet import forward

    cfg = config(cell)
    arch = cfg["arch"]
    params = signals.make_params(arch, 3, torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 300)))
    cond = None
    pcfg = Config.from_dict(cfg)
    if arch["n_mels"]:
        frames = torch.randn(2, 40, arch["n_mels"], generator=torch.Generator().manual_seed(1))
        cond = model.upsample(params["upsampler"], arch, frames)[:, :300]
        pc = upsample_cond(params["upsampler"], pcfg.arch, frames, torch.float32)[:, :300]
        torch.testing.assert_close(cond, pc, rtol=1e-5, atol=1e-5)
    got = forward(params, pcfg.arch, x, cond=cond)
    want = model.logits(params, arch, x, "float32", cond)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_precisions_order():
    """bf16 and fp8 operands move the logits by about their rounding."""
    arch = config("wavenet30.serve_full")["arch"]
    params = signals.make_params(arch, 3, torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 200)))
    lg = {p: model.logits(params, arch, x, p) for p in ("float32", "bfloat16", "fp8")}
    d_bf = (lg["bfloat16"] - lg["float32"]).abs().max()
    d_f8 = (lg["fp8"] - lg["float32"]).abs().max()
    assert 0 < d_bf < d_f8


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_whole_run_is_correct(cell):
    out = run(cell, 2 ** 31 + 17)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and list(out["checks"])
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
