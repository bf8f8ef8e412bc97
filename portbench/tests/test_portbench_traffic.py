"""Traffic from the seed: the same seed gives the same traffic, another
seed the same sizes in another order."""
import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import pool_closed, train
from portbench.lib import signals

from .tiny import BENCH, TRAFFIC, config

SEEDS = (5, 2 ** 31 + 11)


def make(cell, seed):
    return harness.make_run(BENCH, cell, seed, 2, False, "cpu", 0.0, config(cell),
                            TRAFFIC[cell])


def test_closed_loop_requests():
    a, b = (pool_closed._requests(make("wavenet30.serve_full", s), 64) for s in SEEDS)
    a2 = pool_closed._requests(make("wavenet30.serve_full", SEEDS[0]), 64)
    key = [(r.n_samples, r.seed, r.temperature) for r in a]
    assert key == [(r.n_samples, r.seed, r.temperature) for r in a2]
    assert [r.n_samples for r in a] != [r.n_samples for r in b]
    assert sorted(r.n_samples for r in a) == sorted(r.n_samples for r in b)


@pytest.mark.parametrize("cell", ["wavenet30.train", "wavenet30_mel.train"])
def test_corpus_and_weights(cell):
    w1, w2 = (train.waves(make(cell, s)) for s in SEEDS)
    assert all(np.array_equal(x, y) for x, y in zip(w1, train.waves(make(cell, SEEDS[0]))))
    assert not np.array_equal(w1[0], w2[0])
    arch = config(cell)["arch"]
    p = [signals.make_params(arch, s, torch.device("cpu")) for s in (SEEDS[0], SEEDS[0], 9)]
    assert torch.equal(p[0]["post"]["w2"], p[1]["post"]["w2"])
    assert not torch.equal(p[0]["post"]["w2"], p[2]["post"]["w2"])


def test_stratified_laws():
    lengths = signals.log_uniform_lengths(1000, 1.0, 10.0, signals.rng(1))
    assert 1.0 < lengths.min() and lengths.max() < 10.0
    assert abs(lengths.mean() - 9.0 / np.log(10.0)) < 0.01
