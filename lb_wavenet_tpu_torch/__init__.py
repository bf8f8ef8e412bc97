"""lb_wavenet_tpu_torch — the PyTorch/CUDA port of lb_wavenet_tpu.

Same model, parameter layout and serving surface as the JAX package, with
each Pallas kernel replaced by a CUDA kernel written for Hopper (sm_90a)
under `csrc/`. Imports torch only; the JAX package is its test reference.
"""
__version__ = "0.1.0"

from .config import ArchConfig, Config, GenConfig, TrainConfig  # noqa: F401
