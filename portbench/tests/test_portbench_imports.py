"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared whole:
lb_wavenet_tpu_torch is the port, lb_wavenet_tpu the JAX package)."""
import ast

import pytest

from .tiny import ROOT

PKG = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "lb_wavenet_tpu"}


def top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "lb_wavenet_tpu_torch" not in top_imports(path)
    assert "portbench" not in top_imports(path)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys

    from portbench.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "lb_wavenet_tpu_torch_fake", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert forbidden_modules() == ["jaxlib"]
