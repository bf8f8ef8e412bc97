"""Port tests: config, mu-law, the import guard and the no-fallback guard.

The port (lb_wavenet_tpu_torch) is held against the JAX package on the same
inputs; CPU only (the kernels' plain versions)."""
import ast
import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lb_wavenet_tpu import config as jcfg
from lb_wavenet_tpu.ops import mulaw as jmulaw
from lb_wavenet_tpu_torch import config as pcfg
from lb_wavenet_tpu_torch.ops import mulaw as pmulaw

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))
)
def test_configs_load_identically(path):
    j, p = jcfg.Config.load(path), pcfg.Config.load(path)
    for section in ("arch", "train", "gen"):
        assert dataclasses.asdict(getattr(p, section)) == dataclasses.asdict(
            getattr(j, section)
        )
    assert p.arch.dilations == j.arch.dilations
    assert p.arch.receptive_field == j.arch.receptive_field
    assert p.to_json() == j.to_json()


def test_override_and_unknown_key():
    p = pcfg.Config().override({"arch.residual_channels": 32, "gen.seed": 3})
    assert p.arch.residual_channels == 32 and p.gen.seed == 3
    with pytest.raises(ValueError, match="bogus_knob"):
        pcfg.Config().override({"arch.bogus_knob": 1})
    with pytest.raises(ValueError, match="section.name"):
        pcfg.Config().override({"nodot": 1})


def test_mu_law_bit_exact():
    """Encode on a dense grid past [-1, 1] and decode of every class:
    identical bits (all float32 arithmetic, op for op)."""
    x = np.linspace(-1.2, 1.2, 200_001, dtype=np.float32)
    enc_j = np.asarray(jmulaw.mu_law_encode(jnp.asarray(x)))
    enc_p = pmulaw.mu_law_encode(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(enc_p, enc_j)
    y = np.arange(256, dtype=np.int32)
    dec_j = np.asarray(jmulaw.mu_law_decode(jnp.asarray(y)))
    dec_p = pmulaw.mu_law_decode(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(dec_p, dec_j)


def _port_sources():
    files = glob.glob(os.path.join(ROOT, "lb_wavenet_tpu_torch", "**", "*.py"),
                      recursive=True)
    # The rank worker of tests/test_torch_tp.py runs in processes that must
    # not import JAX either.
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py"),
                            os.path.join(ROOT, "tests", "torch_tp_ranks.py")]


def test_port_imports_neither_jax_nor_the_jax_package():
    """AST scan: no `import jax`, no import of lb_wavenet_tpu (relative
    imports inside the port are its own modules)."""
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "optax", "orbax") or \
                        top == "lb_wavenet_tpu":
                    bad.append(f"{os.path.relpath(path, ROOT)}: {n}")
    assert not bad, bad
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    training_slice = {
        "lb_wavenet_tpu_torch/train.py", "lb_wavenet_tpu_torch/data.py",
        "lb_wavenet_tpu_torch/ops/geometry.py", "lb_wavenet_tpu_torch/utils/metrics.py",
        "lb_wavenet_tpu_torch/utils/checkpoint.py", "lb_wavenet_tpu_torch/utils/convert.py",
        "lb_wavenet_tpu_torch/ops/cuda/train_stack.py",
        "lb_wavenet_tpu_torch/ops/cuda/post_loss.py", "chip_smoke.py",
        "lb_wavenet_tpu_torch/eval.py", "lb_wavenet_tpu_torch/ops/cuda/frontend.py",
        "lb_wavenet_tpu_torch/ops/cuda/ar_turbo.py",
        "lb_wavenet_tpu_torch/ops/cuda/ar_tp.py", "lb_wavenet_tpu_torch/parallel/mesh.py",
        "lb_wavenet_tpu_torch/parallel/synthesis.py",
        "lb_wavenet_tpu_torch/utils/multihost.py", "tests/torch_tp_ranks.py",
    }
    assert training_slice <= scanned, training_slice - scanned
    assert len(scanned) > 15


def test_entry_points_raise_without_cuda(monkeypatch):
    """The default device is the card: with no CUDA they raise rather than
    run on the CPU."""
    from lb_wavenet_tpu_torch.generate import generate_classes, start_stream
    from lb_wavenet_tpu_torch.models.wavenet import init_params
    from lb_wavenet_tpu_torch.serving import SessionPool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = pcfg.ArchConfig(n_blocks=1, n_layers_per_block=2, residual_channels=8,
                           skip_channels=8, gate_channels=8,
                           compute_dtype="float32")
    params = init_params(0, arch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SessionPool(params, arch, batch=2, rng=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_classes(params, arch, 0, 2, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        start_stream(arch, 8, 0, engine="mega", params=params)


def test_kernel_wrappers_refuse_unknown_devices_and_unported_options():
    from lb_wavenet_tpu_torch.generate import generate_classes
    from lb_wavenet_tpu_torch.models.wavenet import init_params
    from lb_wavenet_tpu_torch.ops.cuda.ar_step import fused_stack

    arch = pcfg.ArchConfig(n_blocks=1, n_layers_per_block=2, residual_channels=8,
                           skip_channels=8, gate_channels=8,
                           compute_dtype="float32")
    params = init_params(0, arch)
    h = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_stack(params["layers"], arch, h, torch.zeros((3, 2, 8), device="meta"), 0)
    # Conditioning is ported; an unconditioned arch refuses it.
    for kw, msg in ((dict(cond=torch.zeros(2, 4, 3)), "no w_cond"),
                    (dict(speaker_ids=torch.zeros(2)), "no speaker table")):
        with pytest.raises(ValueError, match=msg):
            generate_classes(params, arch, 0, 2, 4, device="cpu", **kw)
    # The model axis is ported; it is a process group, not an axis name.
    with pytest.raises(TypeError, match="process group"):
        generate_classes(params, arch, 0, 2, 4, device="cpu", model_axis="model")

