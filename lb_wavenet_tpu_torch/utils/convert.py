"""Parameter trees across frameworks: a JAX parameter pytree (as nested
dicts of numpy arrays) to the port's dict of float32 tensors, and back.

The layouts are identical (`models/wavenet.py`), so conversion is leaf by
leaf; this is how tests and `chip_smoke.py` hand one set of weights to both
packages.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict, device="cpu") -> dict:
    """Nested dict of array-likes -> nested dict of float32 tensors."""
    return {
        k: params_from_jax(v, device) if isinstance(v, dict)
        else torch.tensor(np.asarray(v, np.float32), device=device)
        for k, v in tree.items()
    }


def params_to_numpy(params: dict) -> dict:
    """Inverse of params_from_jax: nested dict of float32 numpy arrays."""
    return {
        k: params_to_numpy(v) if isinstance(v, dict)
        else v.detach().to("cpu", torch.float32).numpy()
        for k, v in params.items()
    }
