"""Command-line entry points of the port: `train`, `eval`, `serve`,
`generate` and `export` (the parts of `lb_wavenet_tpu/cli.py` ported so far).

    python -m lb_wavenet_tpu_torch.cli train --config configs/wavenet30.json \
        --set train.data_dir=/data/wavs
    python -m lb_wavenet_tpu_torch.cli eval --config configs/wavenet30.json \
        --data-dir /data/heldout --set gen.checkpoint_dir=/ckpt
    python -m lb_wavenet_tpu_torch.cli serve --config configs/wavenet30.json \
        --requests requests.jsonl --set gen.checkpoint_dir=/ckpt
    python -m lb_wavenet_tpu_torch.cli generate --config configs/wavenet30.json \
        --set gen.batch_size=8 --set gen.n_samples=16000 --set gen.engine=turbo
    python -m lb_wavenet_tpu_torch.cli generate --config configs/wavenet30_mel.json \
        --mel frames.npy --set gen.checkpoint_dir=/ckpt

The mel-conditioned vocoder takes `generate --mel <(B, F, n_mels) .npy>`
(upsampled once, or streamed through the StreamingUpsampler with
--stream-chunk) and `serve` request lines with "mel": "<(F, n_mels) .npy>";
speaker-conditioned archs take `generate --speakers 3` (or one id per lane)
and "speaker" in request lines.

Model-sharded serving and synthesis run one process per rank under
torchrun (`torch.distributed`; NCCL when each rank has a card, gloo when
ranks share one or run on the CPU):

    torchrun --standalone --nproc-per-node 2 -m lb_wavenet_tpu_torch.cli serve \
        --mesh-model 2 --config configs/stress_gen.json --requests requests.jsonl
    torchrun --standalone --nproc-per-node 2 -m lb_wavenet_tpu_torch.cli generate \
        --mesh-model 2 --device cpu --config configs/stress_gen.json

`--mesh-model N` splits the model's skip width over N ranks (the data axis
takes the rest of the ranks); `generate --fleet` shards the batch over every
rank with the model replicated. Rank 0 writes the outputs and prints the
summary, which states the mesh and its backend.

Training runs across ranks the same way (train.py): data-parallel over the
data axis, sequence-parallel with `--set train.seq_parallel=true` (the data
axis shards time), skip-split model-parallel with `--mesh-model N`:

    torchrun --standalone --nproc-per-node 2 -m lb_wavenet_tpu_torch.cli train \
        --config configs/multihost_mel.json --set train.data_dir=/data/wavs
    torchrun --standalone --nproc-per-node 2 -m lb_wavenet_tpu_torch.cli train \
        --config configs/wavenet30_mel.json --set train.seq_parallel=true ...

Rank (0, 0) logs the metrics, writes the checkpoints and prints the summary
line, which states the mesh and its backend (gloo when the ranks share a
card or run on the CPU, NCCL when each has its own).

Serving from a frozen artifact (utils/export.py) and over HTTP (server.py):

    python -m lb_wavenet_tpu_torch.cli export --config configs/wavenet30.json \
        --out /art/mega --engine mega --batch 512 --chunk 1024 --per-lane
    python -m lb_wavenet_tpu_torch.cli serve --config configs/wavenet30.json \
        --artifact /art/mega --listen 127.0.0.1:8000 --set gen.batch_size=512 \
        --set gen.checkpoint_dir=/ckpt
    python -m lb_wavenet_tpu_torch.cli generate --config configs/wavenet30.json \
        --artifact /art/turbo --set gen.checkpoint_dir=/ckpt

`export` writes the programs for the device it runs on (`--device`);
weights are not baked in: `generate`/`serve --artifact` read them from
gen.checkpoint_dir. `serve --listen HOST:PORT` answers POST /synthesize and
GET /healthz (server.py) instead of replaying a --requests file.

`--set section.key=value` overrides any config field (values parsed as JSON,
falling back to string). `--device` defaults to `cuda`; pass `--device cpu`
to run the plain PyTorch paths. `train` writes its checkpoints to
train.checkpoint_dir and resumes from them; `generate`/`serve` read the
params of the latest checkpoint in gen.checkpoint_dir (a training directory
or `utils.checkpoint.save_params` files), and so does `eval`. The other
subcommands (info, warm, pack), `train --profile` and `generate --prime`
are ROADMAP.md items.
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
    """[(id, n_samples, speaker, mel, seed, temperature)] from a JSONL file,
    validated."""
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
                speaker = int(r["speaker"]) if "speaker" in r else None
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
            mel = r.get("mel")
            if cfg.arch.use_local_cond and not mel:
                raise SystemExit(
                    f"{path}:{ln}: mel-conditioned arch: each request needs "
                    '"mel": "<frames.npy>" ((F, n_mels), F * hop_size >= n_samples)')
            if mel and not cfg.arch.use_local_cond:
                raise SystemExit(f"{path}:{ln}: request has mel but the arch is not "
                                 "mel-conditioned (arch.n_mels == 0)")
            if speaker is not None and not (0 <= speaker < cfg.arch.n_speakers):
                raise SystemExit(f"{path}:{ln}: speaker {speaker} is not one of the arch's "
                                 f"{cfg.arch.n_speakers} speakers")
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
            requests.append((rid, n, speaker, mel, seed, temp))
    if not requests:
        raise SystemExit(f"{path}: no requests")
    return requests


def _start_mesh(args, mesh_model: int):
    """Join the ranks' process group (torchrun's environment, unless this
    process already belongs to one) and make the (world / N, N) mesh.
    Returns (mesh, whether this call started the group)."""
    import torch.distributed as dist

    from .parallel.mesh import make_mesh
    from .utils.multihost import init_distributed

    started = not dist.is_initialized()
    try:
        init_distributed(device=args.device)
        return make_mesh(-1, mesh_model, device=args.device), started
    except ValueError as e:
        raise SystemExit(f"--mesh-model {mesh_model}: {e}")


def _distributed(args) -> bool:
    return args.mesh_model > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1


def cmd_train(args) -> int:
    """Teacher-forced training from train.data_dir (JSONL metrics on
    stdout, checkpoints in train.checkpoint_dir); across the ranks of
    torchrun when there are several (--mesh-data, --mesh-model, and
    train.seq_parallel as the config says)."""
    import dataclasses

    import torch.distributed as dist

    from .train import run_training
    from .utils.multihost import init_distributed, shutdown

    cfg = _load_config(args)
    overrides = {k: v for k, v in (("mesh_data", args.mesh_data),
                                   ("mesh_model", args.mesh_model)) if v is not None}
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **overrides))
    started = False
    if (int(os.environ.get("WORLD_SIZE", "1")) > 1 or cfg.train.mesh_model > 1
            or cfg.train.mesh_data > 1):
        started = not dist.is_initialized()
        init_distributed(device=args.device)
    try:
        state = run_training(cfg, device=args.device)
        summary = {"trained_to_step": int(state.step)}
        if dist.is_initialized():
            if dist.get_rank() != 0:   # rank 0 is (data 0, model 0)
                return 0
            model = cfg.train.mesh_model
            summary["mesh"] = {"data": dist.get_world_size() // model, "model": model,
                               "backend": dist.get_backend()}
            summary["seq_parallel"] = cfg.train.seq_parallel
        print(json.dumps(summary), flush=True)
    finally:
        if started:
            shutdown()
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

    if args.listen and args.requests:
        raise SystemExit("pass --requests FILE or --listen HOST:PORT, not both")
    if not args.listen and not args.requests:
        raise SystemExit("pass --requests FILE (batch) or --listen HOST:PORT (online daemon)")
    if args.listen and args.deliver == "request":
        # Request-mode ring capacity is sized from the batch file's longest
        # request; an online daemon has no such bound up front.
        raise SystemExit("--listen serves with chunk delivery; drop --deliver request")
    if args.listen and _distributed(args):
        raise SystemExit("--listen serves a single-process pool; drop --mesh-model / torchrun")
    requests = _read_requests(args.requests, cfg) if args.requests else []
    params = restore_params(cfg.gen.checkpoint_dir)
    chunk = args.stream_chunk or 1024
    engine = _engine(cfg, "mega")
    art = None
    if args.artifact:
        # A FROZEN per-lane artifact: engine and chunk from its manifest,
        # the weights from the checkpoint (artifacts do not bake them in).
        from .utils.export import load_serving

        art = load_serving(args.artifact)
        if not art.manifest.get("per_lane"):
            raise SystemExit(f"{args.artifact}: pool serving needs a per-lane artifact "
                             "(re-export with `cli export --per-lane`)")
        if art.arch != cfg.arch:
            raise SystemExit(f"{args.artifact}: artifact arch does not match the "
                             "configured arch")
        if _distributed(args):
            raise SystemExit("--artifact pools are single-device")
        if cfg.gen.global_rng:
            raise SystemExit("--artifact pools use per-lane sampling (gen.global_rng=false)")
        if cfg.gen.temperature <= 0.0:
            raise SystemExit("--artifact pools need gen.temperature > 0 (greedy requests "
                             'are "temperature": 0 submits)')
        if args.stream_chunk and args.stream_chunk != art.manifest["chunk_size"]:
            raise SystemExit(f"--stream-chunk {args.stream_chunk} != artifact chunk "
                             f"{art.manifest['chunk_size']}")
        chunk = int(art.manifest["chunk_size"])
        engine = art.manifest["engine"]
    mesh, started = None, False
    if _distributed(args):
        # Model-sharded pool: skip-split sessions over the model axis.
        mesh, started = _start_mesh(args, args.mesh_model)
        if cfg.gen.global_rng and cfg.gen.temperature > 0:
            raise SystemExit("mesh serving needs the per-lane sampling default "
                             "(gen.global_rng=false) or temperature 0")
    lead = mesh is None or (mesh.data_rank, mesh.model_rank) == (0, 0)
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
        mesh=mesh, device=args.device, artifact=art,
    )

    def make_cond_fn(mel_path: str, n_samples: int, where: str):
        """A request's conditioning: its (F, n_mels) frames upsampled ONCE
        on the pool's device, served to the pool in slices. The frames are
        zero-padded to a multiple of 32 first, as the JAX CLI pads them (to
        bound its compiled shapes), so the two serve the same cond."""
        from .models.conditioning import upsample_cond
        from .models.wavenet import compute_dtype

        frames = np.load(mel_path)
        if frames.ndim != 2 or frames.shape[1] != cfg.arch.n_mels:
            raise SystemExit(f"{where}: mel {mel_path} has shape {frames.shape}, "
                             f"expected (F, {cfg.arch.n_mels})")
        if frames.shape[0] * cfg.arch.hop_size < n_samples:
            raise SystemExit(f"{where}: mel {mel_path} covers "
                             f"{frames.shape[0] * cfg.arch.hop_size} samples < "
                             f"n_samples={n_samples}")
        padded = np.zeros((1, -(-frames.shape[0] // 32) * 32, cfg.arch.n_mels), np.float32)
        padded[0, : frames.shape[0]] = frames
        cond = upsample_cond(pool.params["upsampler"], cfg.arch,
                             torch.from_numpy(padded).to(pool.device),
                             compute_dtype(cfg.arch))[0, :n_samples]

        def cond_fn(t_local: int, n: int):
            return cond[t_local: t_local + n]

        return cond_fn

    if args.listen:
        return _serve_http(args, cfg, pool, engine, chunk, make_cond_fn)
    if lead:
        os.makedirs(cfg.gen.out_dir, exist_ok=True)
    next_req = 0
    parts: dict = {}
    used_seed: dict = {}

    def fill():
        nonlocal next_req
        while next_req < len(requests):
            rid, n, speaker, mel, seed, temp = requests[next_req]
            if seed is None and pool.per_lane_rng:
                # Deterministic per-request seed, logged on completion so a
                # served request can be replayed on a dedicated session.
                seed = (cfg.gen.seed * 0x9E3779B1 + next_req) & 0x7FFFFFFF
            if not pool.free_lanes():
                break
            cond_fn = (make_cond_fn(mel, n, f"{args.requests}:{rid}") if mel else None)
            if not pool.submit(rid, n, speaker=speaker, cond_fn=cond_fn,
                               seed=seed if pool.per_lane_rng else None, temperature=temp):
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
            if done and not lead:
                parts.pop(rid)
            elif done:
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
    if mesh is not None:
        summary["mesh"] = mesh.describe()
    if lead:
        print(json.dumps(summary), flush=True)
    if started:
        from .utils.multihost import shutdown

        shutdown()
    return 0


def _serve_http(args, cfg, pool, engine: str, chunk: int, make_cond_fn) -> int:
    """The online daemon: the pool behind HTTP (server.py) until SIGTERM or
    SIGINT; one worker thread steps the pool, handlers enqueue and wait."""
    import signal

    from .server import PoolServer, make_http_server

    host, _, port_s = args.listen.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        raise SystemExit(f"--listen expects HOST:PORT, got {args.listen!r}")
    cond_builder = None
    if cfg.arch.use_local_cond:
        def cond_builder(mel_path, n_samples):
            return make_cond_fn(mel_path, n_samples, f"mel {mel_path}")
    pool_server = PoolServer(pool)
    pool_server.start()
    httpd = make_http_server(pool_server, cfg.arch, host or "127.0.0.1", port,
                             cond_builder=cond_builder, request_timeout=args.request_timeout)

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    bound = httpd.server_address
    print(json.dumps({"listening": f"{bound[0]}:{bound[1]}", "engine": engine,
                      "batch": cfg.gen.batch_size, "chunk": chunk,
                      "artifact": args.artifact or None, "device": str(pool.device)}),
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        pool_server.stop()
    return 0


def _generate_from_artifact(args, cfg, params, cond_frames) -> int:
    """Synthesis from a serving artifact (utils/export.py): init once, step
    per chunk, decode, write wavs; no model code is traced."""
    import numpy as np

    from .data import write_wav
    from .ops.mulaw import mu_law_decode
    from .utils.export import load_serving

    art = load_serving(args.artifact)
    if art.arch != cfg.arch:
        raise SystemExit("artifact arch differs from --config arch; pass the config the "
                         "artifact was exported with")
    if args.speakers:
        raise SystemExit("--artifact bakes the session shape; --speakers needs the "
                         "in-process path")
    if _distributed(args) or args.fleet:
        raise SystemExit("--artifact synthesis is single-process")
    m = art.manifest
    batch, chunk = m["batch"], m["chunk_size"]
    if m.get("per_lane"):
        raise SystemExit(f"{args.artifact} was exported --per-lane for pools: serve it "
                         "(cli serve --artifact) or re-export without --per-lane")
    cond_chunks = None
    if m["with_cond"]:
        if cond_frames is None:
            raise SystemExit("artifact was exported with_cond: pass --mel")
        if cond_frames.shape[0] != batch:
            raise SystemExit(f"--mel batch {cond_frames.shape[0]} != artifact batch {batch}")
        cond_chunks = _cond_chunks(params, cfg.arch, cond_frames, chunk, batch,
                                   params["embed"].device)
    elif cond_frames is not None:
        raise SystemExit(
            "artifact was exported WITHOUT conditioning but the config is "
            "mel-conditioned; re-export from this config (with_cond is set "
            "automatically) or generate without --artifact")
    state = art.init(params, cfg.gen.seed)
    parts, emitted = [], 0
    while emitted < cfg.gen.n_samples:
        classes, state = art.step(params, state,
                                  cond=None if cond_chunks is None else next(cond_chunks))
        parts.append(mu_law_decode(classes, cfg.arch.quant_channels).cpu().numpy())
        emitted += chunk
    wav_np = np.concatenate(parts, axis=1)[:, : cfg.gen.n_samples]
    os.makedirs(cfg.gen.out_dir, exist_ok=True)
    for i in range(wav_np.shape[0]):
        write_wav(os.path.join(cfg.gen.out_dir, f"gen_{i:04d}.wav"), wav_np[i],
                  cfg.arch.sample_rate)
    print(json.dumps({"generated": int(wav_np.shape[0]), "n_samples": int(wav_np.shape[1]),
                      "out_dir": cfg.gen.out_dir, "artifact": args.artifact,
                      "engine": m["engine"]}), flush=True)
    return 0


def cmd_export(args) -> int:
    """Export a serving artifact (utils/export.py) for `--device`; with
    --mesh-model N a model-sharded one for the (world / N, N) mesh of the
    torchrun ranks that will load it (WORLD_SIZE; N ranks without it)."""
    cfg = _load_config(args)
    from .generate import resolve_device
    from .models.wavenet import init_params
    from .utils.export import export_serving, export_sharded_serving

    params = init_params(0, cfg.arch, device=resolve_device(args.device))
    batch = args.batch or cfg.gen.batch_size
    if args.per_lane and args.mesh_model > 1:
        raise SystemExit("--per-lane is for single-device pool artifacts")
    if args.mesh_model > 1:
        world = int(os.environ.get("WORLD_SIZE", args.mesh_model))
        if world % args.mesh_model:
            raise SystemExit(f"--mesh-model {args.mesh_model} must divide the {world} ranks")
        try:
            manifest = export_sharded_serving(
                params, cfg.arch, batch=batch, chunk_size=args.chunk, out_dir=args.out,
                engine=args.engine, temperature=cfg.gen.temperature,
                mesh_data=world // args.mesh_model, mesh_model=args.mesh_model,
                with_cond=cfg.arch.use_local_cond)
        except ValueError as e:
            raise SystemExit(str(e))
        print(json.dumps({"exported": args.out, **{k: manifest[k] for k in (
            "engine", "batch", "chunk_size", "with_cond", "mesh_data", "mesh_model",
            "device_kind")}}), flush=True)
        return 0
    from .generate import MEGA_LANE_MULTIPLE

    if args.engine == "mega" and batch % MEGA_LANE_MULTIPLE:
        raise SystemExit(f"--engine mega needs batch % {MEGA_LANE_MULTIPLE} == 0 (got "
                         f"{batch}); pass --batch <multiple of {MEGA_LANE_MULTIPLE}> or "
                         "--engine turbo")
    if args.per_lane and cfg.gen.temperature <= 0.0:
        raise SystemExit("--per-lane needs gen.temperature > 0 (greedy lanes are "
                         "inverse-temperature 0 at serve time)")
    manifest = export_serving(
        params, cfg.arch, batch=batch, chunk_size=args.chunk, out_dir=args.out,
        engine=args.engine, temperature=cfg.gen.temperature,
        with_cond=cfg.arch.use_local_cond, per_lane=args.per_lane)
    print(json.dumps({"exported": args.out, **{k: manifest[k] for k in (
        "engine", "batch", "chunk_size", "with_cond", "per_lane", "device_kind")}}),
        flush=True)
    return 0


def cmd_generate(args) -> int:
    """Batched synthesis: one-shot, or streamed in --stream-chunk chunks, or
    from a serving artifact (--artifact)."""
    cfg = _load_config(args)
    import numpy as np

    from .data import write_wav
    from .generate import (
        generate, mu_law_decode, padded_stream_batch, start_stream,
        stream_chunk,
    )
    from .utils.checkpoint import restore_params

    params = restore_params(cfg.gen.checkpoint_dir)
    b = cfg.gen.batch_size
    if not (_distributed(args) or args.fleet):
        # Once, not per chunk: the kernels' packed weights are cached per
        # weight tensor (ops/cuda/build.prepared).
        from .generate import resolve_device
        from .models.wavenet import params_to

        params = params_to(params, resolve_device(args.device))
    cond_frames = None
    if cfg.arch.use_local_cond:
        if not args.mel:
            raise SystemExit("mel-conditioned arch needs --mel <npy file of (B, F, n_mels)>")
        cond_frames = np.load(args.mel).astype(np.float32)
        if cond_frames.shape[0] != b or cond_frames.ndim != 3 \
                or cond_frames.shape[2] != cfg.arch.n_mels:
            raise SystemExit(f"--mel {args.mel}: shape {cond_frames.shape}, expected "
                             f"({b}, F, {cfg.arch.n_mels})")
        if cond_frames.shape[1] * cfg.arch.hop_size < cfg.gen.n_samples:
            raise SystemExit(f"--mel frames cover {cond_frames.shape[1] * cfg.arch.hop_size} "
                             f"samples < gen.n_samples={cfg.gen.n_samples}")
    elif args.mel:
        raise SystemExit("--mel given but the arch is not mel-conditioned (arch.n_mels == 0)")
    speaker_ids = None
    if args.speakers:
        if not cfg.arch.use_global_cond:
            raise SystemExit("--speakers given but arch.n_speakers == 0")
        ids = [int(x) for x in args.speakers.split(",")]
        ids = ids * b if len(ids) == 1 else ids
        if len(ids) != b:
            raise SystemExit(f"--speakers needs 1 or {b} ids, got {len(ids)}")
        speaker_ids = np.asarray(ids, np.int64)
    if args.artifact:
        return _generate_from_artifact(args, cfg, params, cond_frames)
    if _distributed(args) or args.fleet:
        if args.stream_chunk:
            raise SystemExit("--stream-chunk sessions are single-process; drop it for "
                             "mesh synthesis (or serve through `serve --mesh-model`)")
        return _generate_mesh(args, cfg, params, cond_frames, speaker_ids)
    engine = _engine(cfg, "xla")
    if args.stream_chunk:
        chunk = int(args.stream_chunk)
        if chunk <= 0:
            raise SystemExit(f"--stream-chunk must be positive, got {chunk}")
        device_b = padded_stream_batch(b, engine)
        stream = start_stream(cfg.arch, device_b, cfg.gen.seed, engine=engine,
                              params=params, device=args.device)
        cond_chunks = None if cond_frames is None else _cond_chunks(
            params, cfg.arch, cond_frames, chunk, device_b, params["embed"].device)
        spk = None if speaker_ids is None else np.concatenate(
            [speaker_ids, np.zeros(device_b - b, np.int64)])   # pad lanes: speaker 0
        parts = []
        emitted = 0
        while emitted < cfg.gen.n_samples:
            classes, stream = stream_chunk(
                params, cfg.arch, stream, chunk,
                cond=None if cond_chunks is None else next(cond_chunks), speaker_ids=spk,
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
            n_samples=cfg.gen.n_samples, cond_frames=cond_frames, speaker_ids=speaker_ids,
            temperature=cfg.gen.temperature, engine=engine,
            global_rng=cfg.gen.global_rng, device=args.device,
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


def _cond_chunks(params, arch, cond_frames, chunk: int, device_b: int, device):
    """Yield (device_b, chunk, Cc) conditioning chunks from frame-rate mel
    (B, F, n_mels) through the StreamingUpsampler (a fixed lookahead of
    cond_halo_frames), so the chunked output equals the one-shot mel path.
    The tail past the last frame and the pad lanes are zeros (the caller
    trims those samples and lanes)."""
    import torch

    from .models.conditioning import StreamingUpsampler
    from .models.wavenet import compute_dtype, params_to

    dt = compute_dtype(arch)
    ups = StreamingUpsampler(params_to(params["upsampler"], device), arch, dt)
    b, cc = cond_frames.shape[0], arch.cond_channels
    pending = torch.zeros((b, 0, cc), dtype=dt, device=device)
    fed, done = 0, False
    fpc = max(chunk // arch.hop_size, 1)   # frames fed per refill
    while True:
        while pending.shape[1] < chunk and not done:
            if fed < cond_frames.shape[1]:
                out = ups.feed(cond_frames[:, fed: fed + fpc])
                fed += fpc
            else:
                out = ups.finish()
                done = True
            pending = torch.cat([pending, out], 1)
        out = torch.zeros((device_b, chunk, cc), dtype=dt, device=device)
        out[:b, : min(chunk, pending.shape[1])] = pending[:, :chunk]
        yield out
        pending = pending[:, chunk:]


def _generate_mesh(args, cfg, params, cond_frames=None, speaker_ids=None) -> int:
    """Synthesis over a (data, model) process mesh: the GLOBAL
    gen.batch_size is split over the data axis; --mesh-model N > 1 splits
    the model's skip width over the model axis (mesh_generate_classes),
    otherwise the model is replicated (fleet_generate_classes). The classes
    are gathered on every rank; rank 0 writes the wavs and the summary.
    Mel frames are upsampled once on each rank, host-replicated as every
    input."""
    import numpy as np
    import torch

    from .data import write_wav
    from .generate import mu_law_decode
    from .ops.cuda.ar_mega import LANE_TILE
    from .parallel.synthesis import fleet_generate_classes, mesh_generate_classes
    from .utils.multihost import shutdown

    mesh, started = _start_mesh(args, args.mesh_model)
    batch = cfg.gen.batch_size
    if batch % mesh.data:
        raise SystemExit(f"gen.batch_size {batch} must divide by the data axis {mesh.data}")
    engine = _engine(cfg, "mega" if (batch // mesh.data) % LANE_TILE == 0 else "turbo")
    cond = None
    if cond_frames is not None:
        from .models.conditioning import upsample_cond
        from .models.wavenet import compute_dtype, params_to

        cond = upsample_cond(params_to(params["upsampler"], mesh.device), cfg.arch,
                             torch.from_numpy(cond_frames).to(mesh.device),
                             compute_dtype(cfg.arch))
    run = mesh_generate_classes if mesh.model > 1 else fleet_generate_classes
    classes = run(params, cfg.arch, cfg.gen.seed, batch, cfg.gen.n_samples, mesh,
                  engine=engine, temperature=cfg.gen.temperature,
                  global_rng=cfg.gen.global_rng, cond=cond, speaker_ids=speaker_ids)
    if (mesh.data_rank, mesh.model_rank) == (0, 0):
        wav_np = mu_law_decode(classes, cfg.arch.quant_channels).cpu().numpy()
        os.makedirs(cfg.gen.out_dir, exist_ok=True)
        for i in range(wav_np.shape[0]):
            write_wav(os.path.join(cfg.gen.out_dir, f"gen_{i:04d}.wav"), wav_np[i],
                      cfg.arch.sample_rate)
        print(json.dumps({
            "generated": int(wav_np.shape[0]), "n_samples": int(wav_np.shape[1]),
            "mesh": mesh.describe(), "engine": engine, "device": str(mesh.device),
            "out_dir": cfg.gen.out_dir,
        }), flush=True)
    if started:
        shutdown()
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
    p_train.add_argument("--mesh-data", default=None, type=int, metavar="N",
                         help="ranks of the data axis (train.mesh_data; -1: the world "
                         "size over --mesh-model); run under torchrun")
    p_train.add_argument("--mesh-model", default=None, type=int, metavar="N",
                         help="split the skip width over an N-rank model axis "
                         "(train.mesh_model); run under torchrun")
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
    p_gen.add_argument(
        "--mesh-model", default=1, type=int, metavar="N",
        help="split the model's skip width over an N-rank model axis (run under "
        "torchrun; the data axis takes the rest of the ranks)",
    )
    p_gen.add_argument("--mel", default="",
                       help="mel-conditioned archs: .npy of frames (B, F, n_mels)")
    p_gen.add_argument(
        "--speakers", default="",
        help="speaker-conditioned archs: comma-separated speaker ids, one per "
        "lane or a single id for every lane",
    )
    p_gen.add_argument(
        "--fleet", action="store_true",
        help="shard gen.batch_size over every rank with the model replicated "
        "(implied under torchrun with more than one rank)",
    )
    p_gen.add_argument(
        "--artifact", default="", metavar="DIR",
        help="synthesize through a serving artifact (cli export) instead of the "
        "in-process engines; batch, chunk and engine come from its manifest",
    )
    p_serve = sub.add_parser(
        "serve", help="continuous-batching request server over one streaming batch",
    )
    _add_common(p_serve)
    p_serve.add_argument(
        "--artifact", default=None, metavar="DIR",
        help="serve a FROZEN artifact (cli export --per-lane) instead of the "
        "in-process session: engine and chunk come from its manifest, the weights "
        "from gen.checkpoint_dir",
    )
    p_serve.add_argument(
        "--listen", default=None, metavar="HOST:PORT",
        help="run as an online daemon instead of replaying a --requests file: "
        "POST /synthesize {n_samples[, seed][, temperature][, speaker][, mel_path]"
        "[, format: wav|classes]} -> audio/wav; GET /healthz -> pool stats "
        "(server.py)",
    )
    p_serve.add_argument(
        "--request-timeout", default=600.0, type=float,
        help="--listen: seconds a handler waits for synthesis (504 after)",
    )
    p_serve.add_argument(
        "--requests", default=None,
        help='JSONL of {"id": ..., "n_samples": N[, "seed": N]'
        '[, "temperature": T][, "mel": "<(F, n_mels) .npy>"][, "speaker": N]} '
        'requests; "seed" pins the per-lane sampling seed (defaults to a '
        "deterministic derivation, logged on completion for replay); mel "
        "(mel-conditioned archs, required there) and speaker condition the "
        "request",
    )
    p_serve.add_argument("--stream-chunk", default=0, type=int,
                         help="samples emitted per pool step (default 1024)")
    p_serve.add_argument(
        "--pipeline", action=argparse.BooleanOptionalAction, default=True,
        help="double-buffer the serving loop (dispatch chunk t+1 while "
        "delivering chunk t; bit-identical output)",
    )
    p_serve.add_argument(
        "--mesh-model", default=1, type=int, metavar="N",
        help="serve a model-sharded pool: the skip width split over an N-rank "
        "model axis (run under torchrun; the data axis takes the rest)",
    )
    p_serve.add_argument(
        "--deliver", choices=("chunk", "request"), default="chunk",
        help="'request': accumulate classes in a device-side uint8 time ring "
        "and fetch each request once at completion",
    )
    p_export = sub.add_parser("export", help="export a serving artifact (torch.export)")
    _add_common(p_export)
    p_export.add_argument("--out", required=True, help="artifact directory")
    p_export.add_argument("--engine", default="mega",
                          choices=["xla", "pallas", "turbo", "mega"])
    p_export.add_argument(
        "--mesh-model", type=int, default=1, metavar="N",
        help="export a MODEL-SHARDED session artifact for a (ranks / N, N) mesh "
        "(turbo/mega engines)",
    )
    p_export.add_argument("--batch", type=int, default=0,
                          help="session batch (default gen.batch_size)")
    p_export.add_argument("--chunk", type=int, default=4096, help="samples per step call")
    p_export.add_argument(
        "--per-lane", action="store_true",
        help="add the (3, B) per-lane block (seeds, lease times, 1/tau bits) to the "
        "exported step, so `serve --artifact` can pool it with per-request seeds and "
        "temperatures",
    )
    args = parser.parse_args(argv)
    return {"train": cmd_train, "eval": cmd_eval, "generate": cmd_generate,
            "serve": cmd_serve, "export": cmd_export}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
