"""Parameter trees across frameworks: a JAX parameter pytree (as nested
dicts of numpy arrays) to the port's dict of float32 tensors, and back.

The layouts are identical (`models/wavenet.py`), so conversion is leaf by
leaf, through dicts and lists (the upsampler's stages are a list of dicts);
this is how tests and `chip_smoke.py` hand one set of weights to both
packages. `train_state_from_jax` carries a whole JAX train state (params,
Adam moments and count, step, EMA) across the same way.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu"):
    """Nested dicts and lists of array-likes -> the same structure of
    float32 tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def params_to_numpy(params):
    """Inverse of params_from_jax: the same structure of float32 numpy
    arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().to("cpu", torch.float32).numpy()


def train_state_from_jax(state, device="cpu"):
    """A JAX `TrainState` (params, optax chain state, step, ema) as the
    port's train.TrainState: params, Adam's mu/nu and count, the step and
    the EMA copy, leaf by leaf. The Adam moments are found by their fields
    inside the optax state (with or without the clipping stage)."""
    from ..train import TrainState

    def find_adam(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node
        if isinstance(node, (tuple, list)):
            for child in node:
                found = find_adam(child)
                if found is not None:
                    return found
        return None

    adam = find_adam(state.opt_state)
    if adam is None:
        raise ValueError("no Adam moments (mu, nu) in the optimizer state")
    opt = {"count": int(np.asarray(adam.count)),
           "mu": params_from_jax(adam.mu, device), "nu": params_from_jax(adam.nu, device)}
    ema = params_from_jax(state.ema, device) if state.ema else None
    return TrainState(params_from_jax(state.params, device), opt,
                      int(np.asarray(state.step)), ema)
