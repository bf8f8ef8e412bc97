"""Configuration system of the PyTorch/CUDA port.

A copy of `lb_wavenet_tpu/config.py`: the port loads the same
`configs/*.json`, applies the same dotted overrides and rejects unknown keys
the same way, without importing the JAX package. Knobs named after TPU
kernels (`fused_stack`, `tapcat`, `global_rng`, ...) keep their names; the
port maps them onto its own kernels as those slices land (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass(frozen=True)
class ArchConfig:
    """Architecture of the dilated-causal-conv WaveNet stack.

    Receptive field R = 1 + sum(dilations) for width-2 causal convs
    (the initial causal input conv contributes its own (kernel-1)).
    """

    n_blocks: int = 3                 # number of dilation blocks
    n_layers_per_block: int = 10      # dilations 2^0 .. 2^(n-1) inside a block
    residual_channels: int = 64       # width of the residual stream
    skip_channels: int = 256          # width of the skip accumulator
    gate_channels: int = 64           # width of each of tanh/sigmoid branches
    quant_channels: int = 256         # mu-law classes (output softmax size)
    # Width of the causal input conv. 2 is standard WaveNet; ALL engines
    # (incl. the fused turbo/mega kernels, r3) support any K >= 1 — the
    # kernels carry the K-1 past input-conv embeddings as an explicit
    # stack (tests/test_generate.py K-parametrized parity).
    input_kernel: int = 2
    # Local conditioning (mel vocoder mode). n_mels == 0 disables it.
    n_mels: int = 0
    cond_channels: int = 64           # projected conditioning width
    # Upsampling factors from frame rate to sample rate (product == hop size).
    upsample_factors: Sequence[int] = ()
    # Global conditioning (speaker id). 0 disables it.
    n_speakers: int = 0
    speaker_embed_dim: int = 16
    sample_rate: int = 16000
    # Compute dtype for matmuls ("bfloat16" or "float32"); params stay fp32.
    compute_dtype: str = "bfloat16"

    @property
    def dilations(self) -> tuple:
        """Per-layer dilations: n_blocks repeats of [1, 2, 4, ... 2^(L-1)]."""
        return tuple(
            2 ** l
            for _ in range(self.n_blocks)
            for l in range(self.n_layers_per_block)
        )

    @property
    def receptive_field(self) -> int:
        """Number of past samples (incl. current) a logit depends on."""
        return 1 + (self.input_kernel - 1) + sum(self.dilations)

    @property
    def hop_size(self) -> int:
        h = 1
        for f in self.upsample_factors:
            h *= f
        return h

    @property
    def use_local_cond(self) -> bool:
        return self.n_mels > 0

    @property
    def use_global_cond(self) -> bool:
        return self.n_speakers > 0


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8               # global batch (split across data mesh axis)
    window_size: int = 4096           # trainable samples per window (excl. context)
    learning_rate: float = 2e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    grad_clip_norm: float = 0.0       # 0 disables clipping
    # LR schedule: "constant" | "cosine" | "linear" | "exponential".
    # Warmup is linear from 0 over warmup_steps; decay runs over decay_steps
    # (0 -> n_steps - warmup_steps) down to learning_rate * lr_min_ratio.
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 0
    lr_min_ratio: float = 0.0
    # Exponential moving average of params (0 disables). When on, the train
    # state carries an EMA copy updated each step; generation can restore it
    # (restore_params(..., prefer_ema=True) / `wavenet generate --ema`).
    ema_decay: float = 0.0
    n_steps: int = 10000
    log_every: int = 50
    checkpoint_every: int = 1000
    seed: int = 0
    data_dir: str = ""
    checkpoint_dir: str = "/tmp/wavenet_ckpt"
    metrics_path: str = ""            # JSONL metrics stream ("" → stdout only)
    tensorboard_dir: str = ""         # optional TB event stream ("" → off)
    mesh_data: int = -1               # -1: all devices on the data axis
    mesh_model: int = 1
    # Held-out evaluation (eval.py). eval_every = 0 disables in-training
    # eval; eval_batches = 0 sweeps the full eval corpus; eval_batch_size = 0
    # reuses batch_size.
    eval_dir: str = ""
    eval_every: int = 0
    eval_batch_size: int = 0
    eval_batches: int = 0
    lane_continuous: bool = False     # reference-style virtual-batch lanes
    # Sequence-parallel training (parallel/halo.py): the mesh's `data` axis
    # shards the TIME dimension of each window (batch replicated) with a
    # recompute-with-halo exchange of R-1 boundary samples — for windows too
    # long for one chip's activation memory. Mel/speaker conditioning and
    # multi-process meshes supported; composes with fused_stack/tapcat (the
    # Pallas kernel runs per time shard with an in-kernel halo mask) and
    # with grad_accum (batch-row microbatches; time stays sharded).
    seq_parallel: bool = False
    remat: bool = False               # jax.checkpoint per layer (memory vs FLOPs)
    fused_stack: bool = False         # fused Pallas training-stack kernel
    tapcat: bool = False              # fused kernel: K=2C merged tap matmul
    # Fuse the post-network + masked CE (fwd AND bwd) into a Pallas kernel
    # pair (ops/pallas/post_loss.py): hidden/logits/softmax stay in VMEM
    # and the unscored receptive-field head is skipped statically. Loss ==
    # the XLA path to float tolerance (reduction order differs). Works in
    # seq_parallel too (r3): each time shard runs the kernel over its full
    # local length with the mask carrying the exclusion.
    fused_post: bool = False
    # Embedding-gradient via a blocked one-hot MXU contraction instead of
    # the gather's scatter-add VJP (models/wavenet.embed_lookup_mm);
    # HIGHEST-precision contraction == scatter to f32 rounding. Measured
    # faster on-chip (scripts/frontend_ab.py).
    mm_embed_grad: bool = False
    # Fuse the whole input frontend (one-hot MXU embedding + width-K causal
    # input conv, fwd AND bwd) into a Pallas kernel pair
    # (ops/pallas/frontend.py): the embed gather, the tap matmuls, and the
    # embedding-grad machinery (incl. mm_embed_grad's chunked scan and its
    # weight-layout staging copies) collapse into one kernel per pass.
    # Bit-exact vs the XLA frontend for bf16 compute; subsumes
    # mm_embed_grad when enabled. Supports the seq_parallel input mask.
    fused_frontend: bool = False
    # Gradient accumulation: split each batch into grad_accum microbatches
    # scanned inside ONE jitted step (peak activation memory drops
    # ~grad_accum-fold; the masked-mean loss/grads are EXACT — per-micro
    # sums are weighted by their mask denominators). batch_size must divide.
    grad_accum: int = 1


@dataclass(frozen=True)
class GenConfig:
    batch_size: int = 64              # utterances synthesized in parallel
    n_samples: int = 16000            # samples per utterance
    temperature: float = 1.0
    seed: int = 0
    checkpoint_dir: str = "/tmp/wavenet_ckpt"
    out_dir: str = "/tmp/wavenet_out"
    use_pallas: bool = False          # legacy alias for engine="pallas"
    # AR engine: "xla" | "pallas" (bit-matches xla) | "turbo" | "mega"
    # (fastest; see ops/pallas/ar_mega.py). "" -> use_pallas legacy mapping.
    engine: str = ""
    # Fused-engine (turbo/mega) sampling opt-out. DEFAULT (false): noise
    # comes from the stateless per-lane counter hash with seeds derived
    # from the session seed (generate.derive_lane_seeds) — platform-
    # independent (CPU == TPU), oracle-goldenable, replayable per lane,
    # measured cost-neutral on-chip. true: the session-global platform
    # PRNG chain (pltpu.prng_random_bits on TPU; splitmix fallback on CPU
    # interpret — streams then differ across platforms).
    global_rng: bool = False
    # XLA-engine AUDIT knob: run the xla engine under
    # jax.default_matmul_precision(value) ("default"|"high"|"highest").
    # Measured on-chip (scripts/audit_check.py, BASELINE.md): the
    # bit-matching xla <-> pallas pair is ALREADY exact over 1000
    # free-running sampled steps at default precision, and the xla <-> mega
    # greedy divergence (t=168) is the mega kernel's merged-contraction
    # accumulation order, which no precision flag undoes (ar_mega.py
    # precision note) — so this knob matters only for fp32-compute archs
    # where XLA's default fp32 matmul is reduced-precision. XLA engine
    # only: the raised context would inject fp32 contract precision into
    # the Pallas kernels' bf16 matmuls (Mosaic rejects it).
    matmul_precision: str = ""



def _from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"Unknown {cls.__name__} keys: {sorted(unknown)}")
    kwargs = dict(d)
    if "upsample_factors" in kwargs and kwargs["upsample_factors"] is not None:
        kwargs["upsample_factors"] = tuple(kwargs["upsample_factors"])
    return cls(**kwargs)


@dataclass(frozen=True)
class Config:
    """Top-level config bundling arch/train/gen, JSON round-trippable."""

    arch: ArchConfig = field(default_factory=ArchConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    gen: GenConfig = field(default_factory=GenConfig)

    def to_json(self) -> str:
        return json.dumps(
            {
                "arch": dataclasses.asdict(self.arch),
                "train": dataclasses.asdict(self.train),
                "gen": dataclasses.asdict(self.gen),
            },
            indent=2,
        )

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return cls(
            arch=_from_dict(ArchConfig, d.get("arch", {})),
            train=_from_dict(TrainConfig, d.get("train", {})),
            gen=_from_dict(GenConfig, d.get("gen", {})),
        )

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def override(self, dotted: dict[str, Any]) -> "Config":
        """Apply {"arch.residual_channels": 32}-style overrides."""
        d = json.loads(self.to_json())
        for key, value in dotted.items():
            section, _, name = key.partition(".")
            if not name or section not in d:
                raise ValueError(f"Override key must be section.name, got {key!r}")
            d[section][name] = value
        return Config.from_dict(d)
