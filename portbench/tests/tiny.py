"""Small configurations and traffic for the CPU tests: configs/tiny.json
with the recipe's fused flags, and pools and corpora a CPU run holds."""
import copy
import json
import time

from portbench import harness

ROOT = harness.ROOT
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
POOL = {"pool": {"engine": "mega", "batch": 8, "chunk": 64, "pipeline": True,
                 "temperature": 1.0},
        "length_s": [0.005, 0.02], "greedy_every": 2}
TRAFFIC = {
    "wavenet30.serve_full": dict(POOL, outstanding_beyond_pool=4, requests=400),
    "wavenet30.train": {"corpus_files": 4, "file_s": 1.0},
    "wavenet30_mel.train": {"corpus_files": 4, "file_s": 1.0},
}


def config(cell: str, dtype: str = "float32") -> dict:
    """configs/tiny.json (float32 as written, or `dtype`), mel-conditioned
    for the mel cells, with the training recipe's fused flags."""
    c = copy.deepcopy(json.loads((ROOT / "configs" / "tiny.json").read_text()))
    c["arch"]["compute_dtype"] = dtype
    if cell.startswith("wavenet30_mel"):
        c["arch"].update(n_mels=8, cond_channels=8, upsample_factors=[2, 4])
    c["train"].update(batch_size=2, window_size=256, fused_stack=True, tapcat=True,
                      fused_post=True, fused_frontend=True)
    return c


def run(cell: str, seed: int, seconds: int = 1, dtype: str = "float32") -> dict:
    """One whole run of `cell` on the CPU at the small size."""
    import torch

    torch.set_num_threads(2)
    return harness.run_cell(BENCH, cell, seed, seconds, False, "cpu", time.perf_counter(),
                            config(cell, dtype), TRAFFIC[cell])
