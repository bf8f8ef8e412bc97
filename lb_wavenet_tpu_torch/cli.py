"""Command-line entry points of the port: `train`, `eval`, `serve --requests`
and `generate` (the unconditioned, single-device parts of
`lb_wavenet_tpu/cli.py`).

    python -m lb_wavenet_tpu_torch.cli train --config configs/wavenet30.json \
        --set train.data_dir=/data/wavs
    python -m lb_wavenet_tpu_torch.cli eval --config configs/wavenet30.json \
        --data-dir /data/heldout --set gen.checkpoint_dir=/ckpt
    python -m lb_wavenet_tpu_torch.cli serve --config configs/wavenet30.json \
        --requests requests.jsonl --set gen.checkpoint_dir=/ckpt
    python -m lb_wavenet_tpu_torch.cli generate --config configs/wavenet30.json \
        --set gen.batch_size=8 --set gen.n_samples=16000 --set gen.engine=turbo

`--set section.key=value` overrides any config field (values parsed as JSON,
falling back to string). `--device` defaults to `cuda`; pass `--device cpu`
to run the plain PyTorch paths. `train` writes its checkpoints to
train.checkpoint_dir and resumes from them; `generate`/`serve` read the
params of the latest checkpoint in gen.checkpoint_dir (a training directory
or `utils.checkpoint.save_params` files), and so does `eval`. The other
subcommands (info, export, warm, pack), `train --profile` and the serving
options (--listen, --artifact, --mesh-model, mel/speaker requests) are
ROADMAP.md items.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        key, _, val = p.partition("=")
        if not _:
            raise SystemExit(f"--set expects section.key=value, got {p!r}")
        try:
            out[key] = json.loads(val)
        except json.JSONDecodeError:
            out[key] = val
    return out


def _load_config(args):
    from .config import Config

    cfg = Config.load(args.config) if args.config else Config()
    return cfg.override(_parse_overrides(args.set))


def _engine(cfg, default: str) -> str:
    return cfg.gen.engine or ("pallas" if cfg.gen.use_pallas else default)


def _read_requests(path: str, cfg):
    """[(id, n_samples, seed, temperature)] from a JSONL file, validated."""
    requests = []
    seen = set()
    seen_safe: dict = {}
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
                rid, n = str(r["id"]), int(r["n_samples"])
                seed = int(r["seed"]) if "seed" in r else None
                temp = float(r["temperature"]) if "temperature" in r else None
            except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
                raise SystemExit(f"{path}:{ln}: {e}")
            if temp is not None and temp < 0:
                raise SystemExit(f"{path}:{ln}: temperature must be >= 0")
            if rid in seen:
                raise SystemExit(f"{path}:{ln}: duplicate id {rid!r}")
            seen.add(rid)
            # Output paths come from the SANITIZED id: reject ids that
            # sanitize alike, or one wav would overwrite the other.
            safe = re.sub(r"[^A-Za-z0-9._-]", "_", rid)
            if safe in seen_safe:
                raise SystemExit(
                    f"{path}:{ln}: id {rid!r} collides with "
                    f"{seen_safe[safe]!r} after filename sanitization "
                    f"({safe}.wav)"
                )
            seen_safe[safe] = rid
            if "mel" in r or "speaker" in r:
                raise SystemExit(
                    f"{path}:{ln}: mel/speaker requests are not ported yet "
                    "(ROADMAP.md A queue item 4)"
                )
            if seed is not None and cfg.gen.global_rng:
                raise SystemExit(
                    f"{path}:{ln}: per-request seeds need the per-lane "
                    "sampling default (gen.global_rng=false)"
                )
            if temp is not None and (cfg.gen.global_rng or cfg.gen.temperature <= 0):
                raise SystemExit(
                    f"{path}:{ln}: per-request temperature needs the "
                    "per-lane sampling default (gen.global_rng=false) and a "
                    "sampled pool (gen.temperature > 0)"
                )
            requests.append((rid, n, seed, temp))
    if not requests:
        raise SystemExit(f"{path}: no requests")
    return requests


def cmd_train(args) -> int:
    """Teacher-forced training from train.data_dir (JSONL metrics on
    stdout, checkpoints in train.checkpoint_dir)."""
    from .train import run_training

    state = run_training(_load_config(args), device=args.device)
    print(json.dumps({"trained_to_step": int(state.step)}), flush=True)
    return 0


def cmd_eval(args) -> int:
    """Held-out teacher-forced evaluation (eval.py) of the latest checkpoint
    in gen.checkpoint_dir: one JSON line of metrics."""
    cfg = _load_config(args)
    from .data import load_corpus
    from .eval import evaluate
    from .utils.checkpoint import restore_params

    params = restore_params(cfg.gen.checkpoint_dir, prefer_ema=args.ema)
    data_dir = args.data_dir or cfg.train.eval_dir or cfg.train.data_dir
    if not data_dir:
        raise SystemExit("eval needs --data-dir or train.eval_dir/data_dir")
    corpus = load_corpus(data_dir, cfg.arch, cfg.train.window_size)
    metrics = evaluate(params, cfg.arch, corpus,
                       cfg.train.eval_batch_size or cfg.train.batch_size,
                       max_batches=cfg.train.eval_batches, device=args.device)
    print(json.dumps(metrics), flush=True)
    return 0


def cmd_serve(args) -> int:
    """Continuous-batching request server (serving.SessionPool): replay a
    requests JSONL through ONE fixed-shape streaming batch, writing each
    request's wav as it completes."""
    cfg = _load_config(args)
    import numpy as np
    import torch

    from .data import write_wav
    from .ops.mulaw import mu_law_decode
    from .serving import SessionPool
    from .utils.checkpoint import restore_params

    requests = _read_requests(args.requests, cfg)
    params = restore_params(cfg.gen.checkpoint_dir)
    chunk = args.stream_chunk or 1024
    engine = _engine(cfg, "mega")
    acc = 0
    if args.deliver == "request":
        # Ring capacity: the longest request plus two chunks of slack.
        max_n = max(r[1] for r in requests)
        acc = max(-(-(max_n + 2 * chunk) // chunk) * chunk, 4 * chunk)
    pool = SessionPool(
        params, cfg.arch, cfg.gen.batch_size, cfg.gen.seed,
        engine=engine, chunk_size=chunk, temperature=cfg.gen.temperature,
        deliver=args.deliver, **({"acc_samples": acc} if acc else {}),
        per_lane_rng=not cfg.gen.global_rng, pipeline=args.pipeline,
        device=args.device,
    )
    os.makedirs(cfg.gen.out_dir, exist_ok=True)

    next_req = 0
    parts: dict = {}
    used_seed: dict = {}

    def fill():
        nonlocal next_req
        while next_req < len(requests):
            rid, n, seed, temp = requests[next_req]
            if seed is None and pool.per_lane_rng:
                # Deterministic per-request seed, logged on completion so a
                # served request can be replayed on a dedicated session.
                seed = (cfg.gen.seed * 0x9E3779B1 + next_req) & 0x7FFFFFFF
            if not pool.submit(rid, n, seed=seed if pool.per_lane_rng else None,
                               temperature=temp):
                break
            parts[rid] = []
            used_seed[rid] = seed
            next_req += 1

    t0 = time.perf_counter()
    fill()
    n_done = 0
    while pool.active or next_req < len(requests):
        for rid, (classes, done) in pool.step().items():
            parts[rid].append(classes)
            if done:
                wav = mu_law_decode(
                    torch.from_numpy(np.concatenate(parts.pop(rid))),
                    cfg.arch.quant_channels,
                ).numpy()
                safe = re.sub(r"[^A-Za-z0-9._-]", "_", rid)
                path = os.path.join(cfg.gen.out_dir, f"{safe}.wav")
                write_wav(path, wav, cfg.arch.sample_rate)
                n_done += 1
                rec = {"done": rid, "n_samples": int(len(wav)), "wav": path}
                if used_seed.get(rid) is not None:
                    rec["seed"] = int(used_seed[rid])
                print(json.dumps(rec), flush=True)
        fill()
    wall = time.perf_counter() - t0
    total = sum(r[1] for r in requests)
    nst = max(pool.stats["steps"], 1)
    summary = {
        "served": n_done,
        "audio_sec": round(total / cfg.arch.sample_rate, 2),
        "wall_s": round(wall, 2),
        "engine": engine,
        "batch": cfg.gen.batch_size,
        "chunk": chunk,
        "device": str(pool.device),
        "out_dir": cfg.gen.out_dir,
        # Where each serving step's wall went (SessionPool's phase timers):
        # 'fetch' is the device wait + device-to-host copy.
        "phase_ms_per_step": {
            k[:-2]: round(1000.0 * v / nst, 2)
            for k, v in pool.stats.items() if k.endswith("_s")
        },
    }
    if pool.device.type == "cuda":
        summary["gpu"] = torch.cuda.get_device_name(pool.device)
    print(json.dumps(summary), flush=True)
    return 0


def cmd_generate(args) -> int:
    """Batched synthesis: one-shot, or streamed in --stream-chunk chunks."""
    cfg = _load_config(args)
    import numpy as np

    from .data import write_wav
    from .generate import (
        generate, mu_law_decode, padded_stream_batch, start_stream,
        stream_chunk,
    )
    from .utils.checkpoint import restore_params

    params = restore_params(cfg.gen.checkpoint_dir)
    engine = _engine(cfg, "xla")
    b = cfg.gen.batch_size
    if args.stream_chunk:
        chunk = int(args.stream_chunk)
        if chunk <= 0:
            raise SystemExit(f"--stream-chunk must be positive, got {chunk}")
        device_b = padded_stream_batch(b, engine)
        stream = start_stream(cfg.arch, device_b, cfg.gen.seed, engine=engine,
                              params=params, device=args.device)
        parts = []
        emitted = 0
        while emitted < cfg.gen.n_samples:
            classes, stream = stream_chunk(
                params, cfg.arch, stream, chunk,
                temperature=cfg.gen.temperature, engine=engine,
                global_rng=cfg.gen.global_rng,
            )
            classes = classes[:b]  # drop pad lanes
            parts.append(mu_law_decode(classes, cfg.arch.quant_channels).cpu().numpy())
            emitted += chunk
            print(json.dumps({"streamed_samples": emitted}), flush=True)
        wav_np = np.concatenate(parts, axis=1)[:, : cfg.gen.n_samples]
    else:
        wav_np = generate(
            params, cfg.arch, cfg.gen.seed, batch=b,
            n_samples=cfg.gen.n_samples, temperature=cfg.gen.temperature,
            engine=engine, global_rng=cfg.gen.global_rng, device=args.device,
        ).cpu().numpy()

    os.makedirs(cfg.gen.out_dir, exist_ok=True)
    for i in range(wav_np.shape[0]):
        write_wav(os.path.join(cfg.gen.out_dir, f"gen_{i:04d}.wav"), wav_np[i],
                  cfg.arch.sample_rate)
    summary = {"generated": int(wav_np.shape[0]),
               "n_samples": int(wav_np.shape[1]), "out_dir": cfg.gen.out_dir}
    if args.stream_chunk:
        summary["streamed"] = True
    print(json.dumps(summary), flush=True)
    return 0


def _add_common(p):
    p.add_argument("--config", default="", help="JSON config file")
    p.add_argument("--set", action="append", metavar="SECTION.KEY=VALUE",
                   help="config override (repeatable)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                   "plain PyTorch paths)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="wavenet-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_train = sub.add_parser("train", help="teacher-forced training")
    _add_common(p_train)
    p_eval = sub.add_parser("eval", help="held-out teacher-forced metrics")
    _add_common(p_eval)
    p_eval.add_argument("--data-dir", default="",
                        help="eval corpus (default: train.eval_dir, then train.data_dir)")
    p_eval.add_argument("--ema", action="store_true",
                        help="evaluate the checkpoint's EMA params")
    p_gen = sub.add_parser("generate", help="batched AR synthesis")
    _add_common(p_gen)
    p_gen.add_argument(
        "--stream-chunk", default=0, type=int,
        help="emit audio incrementally in chunks of this many samples "
        "(streaming session; chunked output equals one-shot)",
    )
    p_serve = sub.add_parser(
        "serve", help="continuous-batching request server over one streaming batch",
    )
    _add_common(p_serve)
    p_serve.add_argument(
        "--requests", required=True,
        help='JSONL of {"id": ..., "n_samples": N[, "seed": N]'
        '[, "temperature": T]} requests; "seed" pins the per-lane sampling '
        "seed (defaults to a deterministic derivation, logged on completion "
        "for replay)",
    )
    p_serve.add_argument("--stream-chunk", default=0, type=int,
                         help="samples emitted per pool step (default 1024)")
    p_serve.add_argument(
        "--pipeline", action=argparse.BooleanOptionalAction, default=True,
        help="double-buffer the serving loop (dispatch chunk t+1 while "
        "delivering chunk t; bit-identical output)",
    )
    p_serve.add_argument(
        "--deliver", choices=("chunk", "request"), default="chunk",
        help="'request': accumulate classes in a device-side uint8 time ring "
        "and fetch each request once at completion",
    )
    args = parser.parse_args(argv)
    return {"train": cmd_train, "eval": cmd_eval, "generate": cmd_generate,
            "serve": cmd_serve}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
