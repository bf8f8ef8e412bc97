"""Whole runs with the timed path broken underneath must come out not
correct, for each fault the cells can have: a served token altered where
it is produced; a training step that returns its state unchanged; half of
the batch left out, the mean taken over the rest. (No cell spans chips, so
no exchange between chips can be left out.)"""
import pytest

from .tiny import run


@pytest.fixture
def altered_tokens(monkeypatch):
    """Every 7th class of every chunk moved half the class range away."""
    from lb_wavenet_tpu_torch import generate

    real = generate.stream_chunk

    def broken(*a, **kw):
        out = real(*a, **kw)
        cls = out[0].clone()
        q = a[1].quant_channels
        cls[:, ::7] = (cls[:, ::7] + q // 2) % q
        return (cls,) + tuple(out[1:])

    monkeypatch.setattr(generate, "stream_chunk", broken)


def test_altered_token(altered_tokens):
    out = run("wavenet30.serve_full", 41)
    assert not out["correct"], out["checks"]
    assert out["checks"]["served_gap"]["value"] > out["checks"]["served_gap"]["limit"]


@pytest.fixture
def unchanged_state(monkeypatch):
    from lb_wavenet_tpu_torch import train as PT

    def broken(state, batch, arch, train):
        loss, _ = PT.value_and_grads(state.params, batch, arch, train)
        return state, loss

    monkeypatch.setattr(PT, "train_step", broken)


@pytest.fixture
def half_batch(monkeypatch):
    from lb_wavenet_tpu_torch import train as PT

    real = PT.train_step

    def broken(state, batch, arch, train):
        half = batch["inputs"].shape[0] // 2
        return real(state, {k: v[:half] for k, v in batch.items()}, arch, train)

    monkeypatch.setattr(PT, "train_step", broken)


@pytest.mark.parametrize("cell", ["wavenet30.train", "wavenet30_mel.train"])
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_training_fault(cell, fault, request):
    request.getfixturevalue(fault)
    out = run(cell, 43)
    assert not out["correct"], out["checks"]
