"""Serving driver of the port: LoCaLUT-quantized batched inference on the GPU.

Builds the model (random weights from a seed, drawn and quantized one unit at
a time), prepares it — at one spec, or leaf by leaf under an autotuned
:class:`repro_torch.tune.ModelPlan` (``--plan``, ``--autotune``) — and serves
batched requests through pad-masked prefill + greedy decode.

Examples:
    # the GPU, full width, through the hand-written lut_dequant_gemm kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --full --mode pallas
    # the GPU, full width, the paper's int-LUT mode with frozen activation
    # scales, through the hand-written lut_stream_gemm kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --full --mode lut --bw 1 --ba 3 --calibrate 32
    # the GPU, full width, int-LUT under a plan autotuned inline to a 16 GiB budget
    PYTHONPATH=src python -m repro_torch.launch.serve --full --mode lut --bw 1 --ba 3 --autotune 16384 --batch 4
    # the GPU, gemma2-2b at full width and its 8192-token context under the
    # serve profile (ring-window local caches, int8 global caches, bf16-operand
    # attention)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --full --mode pallas --profile serve --batch 4 --max-seq 8192 --prompt-len 4000 --max-new 64
    # the GPU, full width, int-LUT: the first run prepares and saves the
    # serve-ready tree, a rerun restores it (skipping quantize + prepare);
    # every wave's tokens go to a durable log, and a rerun over the same log
    # replays them (0 new waves)
    PYTHONPATH=src python -m repro_torch.launch.serve --full --mode lut --bw 1 --ba 3 --calibrate 32 --batch 4 --prepared-ckpt build/serve_ckpt --request-log build/serve.jsonl
    # the GPU, deepseek-v2-lite-16b (MoE + multi-head latent attention) whole
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --full --mode pallas --batch 4 --max-seq 512
    # the GPU, zamba2-7b (Mamba2 + a shared attention block) whole
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --full --mode pallas --batch 4 --max-seq 512
    # the GPU, rwkv6-3b (RWKV6 "Finch": attention-free, O(1) state a request) whole
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --full --mode pallas --batch 4 --max-seq 512
    # the GPU, whisper-large-v3 (encoder-decoder) whole, text only as the
    # reference's launcher serves it: no frames, so the decoder's cross
    # attention reads a zero cross cache and the encoder does not run
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 --full --mode pallas --batch 4 --max-seq 448
    # the CPU, smoke size, through the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --mode pallas --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --smoke --mode pallas --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama4-maverick-400b-a17b --smoke --mode lut --calibrate 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --smoke --mode lut --calibrate 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --smoke --mode pallas --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 --smoke --mode pallas --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --mode lut --calibrate 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --mode lut --bw 1 --ba 3 --plan plan.json --decode chunked --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --mode lut --calibrate 32 --prepared-ckpt /tmp/lo/ckpt --request-log /tmp/lo/serve.jsonl --device cpu

``--trace PATH`` records the zero-sync ``repro_torch.obs`` trace and writes
it as Chrome/Perfetto JSON; ``--metrics [PATH]`` prints the metrics and SLO
snapshot and, with a PATH, writes them as JSONL:
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --mode lut --calibrate 32 --trace build/obs/trace.json --metrics build/obs/metrics.jsonl --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import timing
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import LutLinearSpec
from repro_torch.models.model import build_model
from repro_torch.models.profiles import PROFILES, apply_perf_profile
from repro_torch.serve.serving import Request, ServeEngine


def build_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--bw", type=int, default=4)
    ap.add_argument("--ba", type=int, default=4)
    ap.add_argument("--mode", default="dequant",
                    # no "stream": the slice-streaming dataflow is a simulation
                    # of the PIM device's traffic, not a serve path (plans
                    # exclude it for the same reason)
                    choices=["dequant", "lut", "pallas"],
                    help="base execution mode of the quantized projections "
                         "(pallas: the hand-written packed-code kernel on the "
                         "GPU; lut: the int-LUT engine, whose int32 sums come "
                         "from the hand-written lut_stream_gemm kernel on the "
                         "GPU)")
    ap.add_argument("--no-prepare", dest="prepare", action="store_false",
                    help="serve raw QuantizedLinear params")
    ap.add_argument("--decode", default="scan", choices=["scan", "chunked", "loop"],
                    help="continuous in-flight batching (1 host sync per "
                         "admission wave), the fixed-chunk baseline (1 host "
                         "sync per chunk) or the per-token loop oracle")
    ap.add_argument("--plan", default=None, metavar="PLAN_JSON",
                    help="serve through a repro_torch.tune ModelPlan artifact "
                         "(per-layer autotuned configs; fingerprint-checked)")
    ap.add_argument("--autotune", type=float, default=None, metavar="BUDGET_MB",
                    help="run the repro_torch.tune planner inline under this "
                         "LUT-capacity budget (MB) and serve the result")
    ap.add_argument("--prompt-bucket", type=int, default=8,
                    help="power-of-two prompt-length bucketing floor (1 disables)")
    ap.add_argument("--profile", default="baseline", choices=list(PROFILES),
                    help="serve: ring-window caches, int8 KV caches and bf16-operand "
                         "attention, where the config allows them "
                         "(repro_torch.models.profiles)")
    ap.add_argument("--calibrate", type=int, default=None, metavar="TOKENS",
                    help="freeze per-layer activation scales from a seeded "
                         "synthetic calibration batch of this many tokens at "
                         "prepare time: the int-LUT engines become "
                         "batch-composition invariant")
    ap.add_argument("--prepared-ckpt", default=None, metavar="DIR",
                    help="prepared-pytree checkpoint dir: restore the serve-ready tree "
                         "from it when present (fast cold start, skipping quantize + "
                         "prepare), else save one after preparing; either package's "
                         "checkpoint restores")
    ap.add_argument("--request-log", default=None, metavar="PATH",
                    help="serve under repro_torch.serve.ops.LiveServer with a durable "
                         "request log at PATH: every admission wave's tokens are "
                         "fsynced, a crashed engine restarts and replays its in-flight "
                         "slots token for token, and a rerun over the same log replays "
                         "what it holds (requires --decode scan)")
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="record the zero-sync repro_torch.obs trace and write it as "
                         "Chrome/Perfetto trace_event JSON; recording happens only at "
                         "existing host syncs, so tokens and sync counts are those of "
                         "an untraced serve")
    ap.add_argument("--metrics", nargs="?", const="-", default=None, metavar="OUT_JSONL",
                    help="print the repro_torch.obs metrics + SLO snapshot after serving; "
                         "with a PATH, also write the metrics (snapshot, SLO stats, "
                         "per-request lifecycle records) as JSONL")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.request_log and args.decode != "scan":
        ap.error("--request-log needs the continuous driver (--decode scan): "
                 "wave-level token logging is its host-sync hook")
    if args.plan and args.autotune is not None:
        ap.error("--plan and --autotune are mutually exclusive")
    if args.calibrate is not None and (
        not args.prepare or args.plan or args.autotune is not None
    ):
        ap.error("--calibrate freezes activation scales during the plain "
                 "prepare step: it requires --prepare (no "
                 "--no-prepare/--plan/--autotune)")
    return args


def _quantize_and_prepare(args, cfg, model):
    """The seeded weights, quantized and prepared at one spec (or left raw
    for a plan, which ``ServeEngine`` applies); returns ``(params, plan)``."""
    t0 = time.time()
    params = model.init_quantized(
        LutLinearSpec(bw=args.bw, ba=args.ba, mode=args.mode), seed=0, device=args.device
    )
    timing.block_until_ready(params["embed"])
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"W{args.bw}A{args.ba} ({args.mode}) initialized + quantized in "
          f"{time.time()-t0:.1f}s")
    plan = None
    if args.plan:
        from repro_torch.tune import ModelPlan

        plan = ModelPlan.load(args.plan)
        print(f"loaded plan {args.plan}: {len(plan.layers)} layers, "
              f"{plan.total_bytes:,} B under a {plan.budget_bytes:,} B budget")
    elif args.autotune is not None:
        from repro_torch.tune import plan_model

        t0 = time.time()
        plan = plan_model(params, lut_budget_bytes=int(args.autotune * 1024 * 1024),
                          n_hint=args.batch)
        print(f"autotuned {len(plan.layers)} layers in {time.time()-t0:.1f}s: "
              f"{plan.total_bytes:,} B spent of {plan.budget_bytes:,} B budget")
    elif args.prepare:
        t0 = time.time()
        if args.calibrate is not None:
            crng = np.random.default_rng(1)
            cal = crng.integers(1, cfg.vocab_size, (2, max(1, args.calibrate // 2))).astype(np.int32)
            params = model.prepare(params, calibrate=cal, n_hint=args.batch)
            print(f"prepared + froze activation scales on {cal.size} synthetic "
                  f"calibration tokens in {time.time()-t0:.1f}s")
        else:
            params = model.prepare(params, n_hint=args.batch)
            print(f"prepared weight-stationary serve products in {time.time()-t0:.1f}s")
    return params, plan


def main(argv=None):
    args = build_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.calibrate is not None and cfg.is_encdec:
        raise SystemExit(f"{cfg.name}: --calibrate runs a forward over tokens alone, and an "
                         f"encoder-decoder forward without frames has no cross keys and values "
                         f"(the reference raises there too; ROADMAP Queue 3): calibrate with "
                         f"calibrate_tree and a closure that passes prefix_embeds")
    if args.profile != "baseline":
        cfg = apply_perf_profile(cfg, args.profile)
        print(f"perf profile: {args.profile}")
    model = build_model(cfg)
    plan = None
    restored = False
    if args.prepared_ckpt:
        from repro_torch.ckpt import checkpoint as ckpt

        latest = ckpt.latest_step(args.prepared_ckpt)
        if latest is not None:
            params, dt = timing.timed(ckpt.restore_prepared, args.prepared_ckpt, latest,
                                      device=args.device)
            print(f"restored prepared checkpoint step {latest} from {args.prepared_ckpt} "
                  f"in {dt:.2f}s (skipped quantize + prepare)")
            restored = True
    if not restored:
        params, plan = _quantize_and_prepare(args, cfg, model)
    obs = None
    if args.trace or args.metrics:
        from repro_torch.obs import Observer

        obs = Observer()
    # ``plan`` routes through ServeEngine's autotuned path (spec rewrite +
    # prepare happen inside, fingerprint-checked).
    eng = ServeEngine(model, params, batch=args.batch, max_seq=args.max_seq,
                      decode=args.decode, prompt_bucket=args.prompt_bucket,
                      plan=plan, obs=obs, device=args.device)
    if args.prepared_ckpt and not restored and (args.prepare or plan is not None):
        _path, dt = timing.timed(ckpt.save_prepared, args.prepared_ckpt, 0, eng.params)
        print(f"saved prepared checkpoint to {args.prepared_ckpt} in {dt:.2f}s (the next "
              f"cold start restores it)")
    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                max_new_tokens=args.max_new)
        for _ in range(args.requests)
    ]
    if args.request_log:
        from repro_torch.serve.ops import LiveServer

        served = eng.params      # prepared / plan-applied
        server = LiveServer(
            lambda: ServeEngine(model, served, batch=args.batch, max_seq=args.max_seq,
                                decode="scan", prompt_bucket=args.prompt_bucket,
                                device=args.device),
            log_path=args.request_log,
            obs=obs, trace_path=args.trace,
        )
        del eng
        outs, dt = timing.timed(server.serve, reqs)
        eng = server.engine
        print(f"live serve: {server.restarts} restarts, log at {args.request_log}")
    else:
        outs, dt = timing.timed(eng.generate, reqs)
    total_tokens = sum(len(o) for o in outs)
    print(f"served {len(reqs)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s), {eng.host_syncs} host syncs")
    if args.decode == "scan":
        print(f"admission order (request -> slot): {eng.admissions}")
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: {o}")
    if eng.device.type == "cuda":
        print(f"{torch.cuda.get_device_name(eng.device)}: peak memory "
              f"{torch.cuda.max_memory_allocated(eng.device)/1e9:.2f} GB")
    if obs is not None:
        from repro_torch.obs import snapshot_text, write_metrics_jsonl, write_perfetto

        if args.trace:
            path = write_perfetto(obs, args.trace)
            print(f"perfetto trace: {path} ({len(obs.tracer)} events, "
                  f"{obs.tracer.dropped} dropped)")
        if args.metrics:
            print(snapshot_text(obs, title=f"repro.serve {args.arch}"))
            if args.metrics != "-":
                path = write_metrics_jsonl(obs, args.metrics)
                print(f"metrics jsonl: {path}")
    return outs


if __name__ == "__main__":
    main()
