#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

(``--phase tc_cp_async``, ``--phase gemma2_serve``, ``--phase live_ops``,
``--phase obs``, ``--phase deepseek``, ``--phase zamba2``, ``--phase rwkv``,
``--phase whisper``, ``--phase vlm_train``, ``--phase dist``, ``--phase dist_train``,
``--phase seq_shard``, ``--phase dryrun`` or ``--phase plans_families`` runs one
phase alone after the build; ``--src DIR`` drives the ``repro_torch`` under DIR, so two
trees' kernels can be compared in one call.)  It builds every kernel of the port from the sources in the checkout (one
``nvcc`` per source, started together), holds each against its plain
PyTorch version on the card, and drives three paths through the port's own
entry points at published full widths:

* stablelm-12b (20 of its 40 layers) served in W4A4,
  ``mode="pallas"``, prepared — the
  ``lut_dequant_gemm`` kernel (bf16 activations on an int grid, so every
  launch takes its tensor-core route, ``lut_dequant_gemm_sm90.cu``);
* stablelm-12b served in W1A3 p=4, ``mode="lut"``, calibrated and prepared —
  the paper's int-LUT mode: each projection's activation codes are
  canonicalized (and the LUT slices composed) by one launch of
  ``lut_canon.cu`` and its int32 sums come from the ``lut_stream_gemm``
  kernel (the pack's route: the int8 tensor cores,
  ``lut_stream_gemm_sm90.cu``);
* gemma2-2b's cache-free forward (``Model.forward``) over one sequence of
  8192 tokens, W4A4 ``pallas`` prepared, ``attn_impl="flash"`` — the
  ``flash_attention`` kernel (alternating 4096-window and global layers,
  softcap 50, GQA 8/4, head dim 256; bf16, so all 26 launches take its
  tensor-core route, ``flash_attention_sm90.cu``) beside
  ``lut_dequant_gemm``, held against ``attn_impl="xla"``; both kernels are
  also held against their plain versions at this forward's own shapes;

* gemma2-2b served at full width and its published 8192-token context,
  W4A4 ``pallas`` prepared, bf16 — under ``--profile serve`` (ring-window
  caches of 4096 slots on the local layers, int8 K/V with per-row scales on
  the global ones, bf16-operand attention) and under the baseline (plain
  8192-slot caches), every projection on ``lut_dequant_gemm``'s tensor-core
  route; first one f32 "LG" unit at full width holds the ring against the
  full cache, the decode against the cache-free forward and the profile
  against the baseline, and last the bf16 profile's teacher-forced
  decode is held against the cache-free f32 forward (phase 14; 14b at 12 of
  the 26 layers);

* deepseek-v2-lite-16b (phase 17): 4 of its 27 layers at published widths
  (multi-head latent attention with its compressed latent cache; 64 routed
  experts top-6 + 2 shared, the published capacity factor; a dense first
  layer), W4A4 ``pallas`` prepared, bf16, served through ``ServeEngine`` —
  every applied projection on ``lut_dequant_gemm``'s tensor-core route, the
  expert stacks decoded and multiplied in plain torch as the reference does;
  then the chunked 4608-token MLA prefill, a 4-layer W1A3 ``lut`` serve and
  a 2-layer f32 prefill against the CPU (logits and expert ids);

* zamba2-7b (phase 18): 6 of its 81 layers at published widths (Mamba2 SSD
  mixers, and one shared attention + FFN block applied by one of them), W4A4 ``pallas`` prepared, bf16, served through
  ``ServeEngine`` — 19 applied projections a forward on ``lut_dequant_gemm``'s tensor-core
  route, the recurrence in plain torch as the reference's XLA; then a
  6-layer W1A3 ``lut`` serve and a 6-layer f32 prefill against the CPU and
  against a prefill followed by decode steps;

* rwkv6-3b (phase 19): 8 of its 32 RWKV6 "Finch" layers at published
  widths (no attention; an O(1) recurrent state a request, the same bytes
  at any context), W4A4 ``pallas`` prepared, bf16, served through
  ``ServeEngine`` — 64 applied projections a forward on
  ``lut_dequant_gemm``'s tensor-core route, the WKV recurrence in plain
  torch as the reference's XLA; then a 4-layer W1A3 ``lut`` serve (scan ==
  loop == chunked) and a 2-layer f32 prefill against the CPU and against a
  prefill followed by decode steps;

* whisper-large-v3 (phase 20): 4 of its 32 encoder and 4 of its 32
  decoder layers at published widths, W4A4 ``pallas`` prepared, bf16 — the transcription
  path: ``Model.prefill(prefix_embeds=)`` over 4 x 1500 frames (the encoder:
  ``flash_attention`` with ``causal=False`` and ``lut_dequant_gemm`` at
  6000 rows, all on the tensor cores), then 64 greedy decode steps over the
  cross cache; ``ServeEngine`` text only; f32 frames on the CUDA-core
  routes and a 2 + 2-layer f32 prefill against the CPU; a 4 + 4-layer
  W1A3 ``lut`` copy calibrated with frames; the kernels at whisper's
  shapes;

* internvl2-1b (phase 21): 6 of its 24 layers at published widths, the
  stub vision frontend's 256 patches of 1024 projected and prepended to the
  tokens, W4A4 ``pallas`` prepared, bf16, ``attn_impl="flash"`` — a
  cache-free forward over 4 x (256 + 128) positions (``flash_attention`` at
  head dim 64, causal, and ``lut_dequant_gemm``, all on the tensor cores),
  ``Model.prefill(prefix_embeds=)`` and 64 greedy decode steps,
  ``ServeEngine`` text only; a 2-layer f32 copy against the CPU and against
  its own forward, a 4-layer W1A3 ``lut`` copy, the kernels at its shapes;
  then **training** at full width (``repro_torch.train``: f32 parameters,
  bf16 compute, each unit checkpointed, the chunked head, AdamW) for 10
  steps under ``run_supervised`` with a failure at step 6, against a clean
  run of the same steps;

* the distribution layer (phase 22, ``repro_torch.dist``): an NCCL world of
  one rank serving stablelm-12b (10 layers, W1A3 lut) through
  ``ServeEngine(ctx=)`` with the tokens of the same tree served without a
  ctx; every rank's shard of stablelm-12b's 7 projections at tp 2 / 4 / 8
  through its kernels (lut bit-equal, pallas within 1e-4 of the unsharded
  layer); one deepseek-v2-lite-16b MoE layer under expert parallelism at tp
  4; ``compressed_psum`` and ``pipeline_apply`` over NCCL;

* sharded training (phase 23, ``make_train_step(ctx=)``, ``ckpt.save`` /
  ``restore(shardings=)``): internvl2-1b at full width trained on a
  ``(1, 1)`` mesh of an NCCL world of one rank, bit-equal to the plain
  step, its sharded save byte-equal to the plain save and restored
  bit-equal; then a gloo world of two ranks sharing the card, chatglm3-6b
  at published widths cut to 2 layers, f32: an FSDP + TP step on ``(1, 2)``
  and on ``(2, 1)``, every gradient shard held to the local step's, and a
  save from ``(1, 2)`` restored on ``(2, 1)``;

* ``seq_shard`` (phase 24): zamba2-7b's shared attention at the reference's
  ``long_500k`` decode shape (524288 positions) split into 2 and 4 sequence
  shards, their partials combined by the function the collective path
  combines with, against the unsharded attention; then a gloo world of two
  ranks sharing the card serving zamba2-7b at published widths (one
  ``"MMMMMS"`` unit, W4A4 ``pallas``) through ``ServeEngine(ctx=)`` with
  the caches cut along the sequence (4096 of 8192 positions a rank), held
  to the same tree run whole;

* the device-less dry-run (phase 25, ``repro_torch.launch.dryrun``): one
  rank of the 256-rank production mesh traced on ``meta`` over a fake
  process group for stablelm-12b at ``decode_32k`` and ``prefill_32k`` and
  zamba2-7b at ``long_500k``, with the roofline's three terms (derived, not
  measured); then stablelm-12b at 20 layers, W4A4 ``dequant``, a decode
  step and a prefill counted on ``meta`` and run on the card: the counted
  argument bytes and matmul FLOPs equal the real step's;

* plans, prepared checkpoints and live ops over the trees the autotuner
  once refused (phase 26): deepseek-v2-lite-16b at 4 layers, zamba2-7b at
  6, rwkv6-3b at 4 and whisper-large-v3 at 4 + 4, at published widths, W1A3
  ``lut`` calibrated, bf16 — an analytic plan at 64 MiB served through
  ``ServeEngine(plan=)`` with the unplanned serve's tokens and
  ``lut_stream_gemm``'s launches counted per route (the int8 tensor cores
  and the lookup route) from the plan's applied projections; the planned
  tree saved with ``save_prepared``, restored and served again; deepseek
  planned once more by measuring on the card (an expert stack's unit slice
  too) and hot-swapped mid-serve to a 256 MiB plan; whisper and zamba2
  killed and replayed by a ``LiveServer``;

the serve paths with continuous batching; and the int-LUT model again under
the capacity-budgeted autotuner (``repro_torch.tune``, phase 13, at 10 of
stablelm-12b's 40 layers): ``ServeEngine(plan=)`` with per-layer packing
degrees from analytic plans at 16 and 1 GiB and a plan measured on the card,
so ``lut_stream_gemm`` runs on two of its routes (the int8 tensor cores at p
<= 5; at p = 6-8, R = 64-256, the lookup route,
``lut_stream_lookup_sm90.cu``, the composed LUT slices streamed through
shared memory), and the fixed-chunk driver (``decode="chunked"``); every
planned serve gives the tokens of the same tree served without a plan.  Last, phase 8's model under live
operations (phase 15, at 10 of its 40 layers; ``repro_torch.ckpt``, ``serve.ops``, ``ft``): a
prepared checkpoint saved and restored onto the card, a ``LiveServer`` whose
factory restores it, killed at three waves, with its durable request log
replayed, a plan swap staged on a side stream and flipped at a wave
boundary, the chaos sweep at a cut depth, and the kernels' refusal of
inputs that require grad.  Then the same model traced (phase 16,
``repro_torch.obs``): ``ServeEngine(obs=)`` must leave the tokens, host syncs,
admissions, kernel launches and synchronizing calls of the untraced serve,
the chunked and loop drivers and a ``Measurer`` under phase 13's plan
traced, a traced ``LiveServer`` killed once and a traced swap at a cut
depth, and ``launch/serve.py --trace --metrics``.  Every
kernel's launch count is set to 0 just before a path and read just after.  It checks the card
against the CPU and the continuous driver against the per-token loop.  Any
failed phase exits non-zero.  It imports no JAX and nothing of the JAX
package.  The second-to-last line is a JSON object describing each kernel
(launches on its path, error, times beside its bound); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import types
import warnings
import zlib

ROOT = pathlib.Path(__file__).resolve().parent
N_LAYERS = 20                 # serve depth of phases 3 and 8 (stablelm-12b has 40; cut to 20
                              # to keep the script in its time limit)
TOL_REL = 1e-4                # kernel vs plain: f32 sums in another order, K <= 13824
TOL_CPU = 1e-3                # card vs CPU logits, relative to max |logit|
TOL_CPU_LUT = 2e-2            # the same for the int-LUT model: 3-bit activation
                              # codes turn f32 last-bit differences (attention,
                              # norms) into whole-step code changes
TOL_FLASH_F32 = 2e-4          # flash kernel vs plain, f32: the reference's sweep tolerance,
                              # relative to max(1, max |out|); sums in another order
TOL_FLASH_BF16 = 2.0**-7      # bf16: one rounding of the output, relative to max |out|
TOL_FLASH_BF16_ROW = 2.0**-7  # bf16, each row (b, s, h) against the plain version in f32
                              # on the same inputs, relative to the row's max |out|: the
                              # output's rounding (at most 2^-8 of each element) and P's
                              # rounding to bf16 before P @ V (the tensor-core route)
FLASH_Q_SCALE = 16.0          # q scaled so that the scores reach the softcap (std 16 before
                              # the cap of 30 or 50, where cap * tanh(s / cap) bends)
TOL_FORWARD_F32 = 1e-3        # gemma2 flash vs xla forward in f32 activations, 26 layers:
                              # max abs difference of the final hidden states and of the
                              # last 512 positions' logits, relative to their max |value|
                              # (f32 sums in another order, grown through 26 layers)
TOL_FORWARD_BF16 = 2.0        # in bf16: the two forwards' relative distance (Frobenius)
                              # at most twice the bf16 xla forward's own distance from the
                              # f32 one: rounding of the two attentions' bf16 outputs at
                              # other places grows through the residual stream, as bf16
                              # rounding itself does
FLASH_SEQ = 8192              # gemma2-2b's published context: the forward's length
KERNELS = ("lut_dequant_gemm", "lut_stream_gemm", "flash_attention")
# The CUDA sources are kernels/build.py's SOURCES, one library each.  The three
# kernels have two routes each, fixed by what the inputs are and never by the
# batch: flash_attention by dtype and head dim (kernels/flash_attention.py::
# route), lut_dequant_gemm by dtype, grid and K (kernels/lut_dequant_gemm.py::
# route), lut_stream_gemm by the LUT pack (kernels/lut_stream_gemm.py::route:
# three routes); lut_canon.cu canonicalizes in front of lut_stream_gemm.
# Phase 6's LUT packs: the CPU tests' five, R = 4 and R = 2 on the tensor cores,
# then the lookup route's W1A3 p = 6 / 7 / 8 (a plan's) and (2,3,3) (R = 64).
STREAM_PACKS = [(1, 3, 3), (1, 3, 4), (2, 2, 4), (4, 4, 2), (1, 1, 5), (1, 4, 2), (1, 3, 1),
                (1, 3, 6), (1, 3, 7), (1, 3, 8), (2, 3, 3)]
LOOKUP_PS = (6, 7, 8)         # the packing degrees a capacity plan gives the lookup route
LOOKUP_REPEATS = 4            # phase 6: lookup calls after the first, each held to it
SLEEP_CYCLES = int(5e7)       # the card sleeps (~30 ms) while the host enqueues the timed calls
LUT_SPEC = dict(bw=1, ba=3, p=4)   # the paper's W1A3 (the reference's serve benchmark)
GEMMA_SERVE_SEQ = 8192        # phase 14: gemma2-2b's published context, the serve caches' length
GEMMA_PREFIX = 4000           # 14a: prefill tokens; the local ring (4096 slots) wraps at
GEMMA_DECODE = 160            #      decode step 96 of these teacher-forced steps
GEMMA_REQUESTS = 8            # 14b: requests of 3072-4096 prompt tokens (one bucket: 4096)
GEMMA_NEW = 64                # 14b: new tokens a request
GEMMA_BUCKET = 4096           # 14b: the requests' prefill bucket (4 x 4096 rows a prefill)
GEMMA_SERVE_LAYERS = 12       # 14b: gemma2-2b's depth (of 26: 6 "LG" units), to keep the
                              # script in its time limit (at 6 layers the allocator rounds
                              # the caches' blocks past their bytes and the check fails)
GEMMA_TF_PREFIX = 4032        # 14b: teacher-forced prefill of the cut bf16 profile; the
GEMMA_TF_DECODE = 96          #      ring wraps at decode step 64 of these steps
TOL_RING = 3e-3               # 14a: ring vs full-cache decode logits, rtol = atol: the
                              # reference's own (tests/test_perf_features.py:35)
TOL_DECODE_FWD = 1e-3         # 14a: full-cache decode vs the cache-free forward, relative
                              # to max |logit| (f32 sums in another order)
TOL_PROFILE = 0.06            # 14a: serve profile vs baseline, relative Frobenius: the
                              # reference's own (tests/test_perf_features.py:107)
TOL_INT8 = 0.05               # 14b: ring + int8 decode (f32) vs the f32 forward, relative
                              # Frobenius: the reference's int8 bound (test_perf_features.py:69)
# Phase 14b's numbers in the kernels line, per profile.
GEMMA_SERVE_KEYS = ("launches", "launches_tc", "prefills", "decode_steps", "host_syncs", "waves",
                    "wall_s", "tok_s", "prefill_wall_s", "decode_wall_s", "prefill_ms", "step_ms",
                    "prefill_profile", "decode_profile", "peak_gb", "cache_bytes", "tokens_crc32")
# Phase 13's numbers in the kernels line, per served plan.
PLANNED_KEYS = ("p", "planning_s", "candidates_measured", "analytic_vs_measured_p", "measured_us",
                "est_us", "total_bytes", "table_bytes", "prepare_s", "launches", "launches_tc",
                "launches_lookup", "launches_cuda_core", "launches_canon", "host_syncs",
                "wall_s", "tok_s",
                "prefill_wall_s", "decode_wall_s", "prefill_ms", "step_ms", "prefill_profile",
                "decode_profile", "peak_gb", "held_before_gb", "tokens_crc32")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 2 helpers: kernel vs plain version, times beside the bound
# ---------------------------------------------------------------------------

# The seven quantized projections of one stablelm-12b layer: name -> (K, F).
def layer_shapes(cfg):
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
        "w_up": (d, cfg.d_ff), "w_gate": (d, cfg.d_ff), "w_down": (cfg.d_ff, d),
    }


def bound_s(b, k, f, bw, x_bytes, card):
    """Least time the card could take: each input read once, the output
    written once, over the memory rate; 2*B*F*K operations over the peak for
    the inputs' type (bf16 x on an int grid: products exact in bf16 tensor
    cores; f32 x: the CUDA-core f32 rate).  Returns (seconds, bound_by)."""
    kb = -(-k // (8 // bw))
    nbytes = b * k * x_bytes + f * kb + 4 * f + 4 * b * f
    peak = card.peak_flops_bf16 if x_bytes == 2 else card.peak_flops_f32
    t_bytes, t_ops = nbytes / card.hbm_bandwidth, 2.0 * b * f * k / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters):
    """Mean device time per call, CUDA events around ``iters`` calls after a
    warmup call.  ``fn(i)`` takes the iteration index (to rotate inputs)."""
    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def once_ms(torch, fn):
    """``(fn(), its time)``: CUDA events around one call, ms."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def device_ms(torch, fn, iters):
    """Mean device time per call: CUDA events around ``iters`` calls that the
    host enqueues while the card sleeps (``torch.cuda._sleep``), so the calls
    run back to back and the time is the card's alone, even where the host
    takes longer to launch a call than the card to run it (:func:`host_us`).
    ``fn(i)`` takes the iteration index."""
    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters=200):
    """The host's time per call to enqueue ``fn(i)`` (perf_counter, while the
    card sleeps so that no queue fills), microseconds."""
    fn(0)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def device_time_by_kernel(torch, fn, iters):
    """Device time and launches per call of ``fn``, by kernel name, from
    ``torch.profiler`` over ``iters`` calls after a warmup call:
    ``{name: (ms, launches)}``, or ``None``
    when the profiler recorded no device time (then nothing is reported)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, tuple[float, float]] = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        ms, n = by_name.get(e.key, (0.0, 0.0))
        by_name[e.key] = (ms + us / 1e3 / iters, n + e.count / iters)
    return by_name if sum(ms for ms, _n in by_name.values()) > 0 else None


def log_breakdown(what, by_name, wall_ms, *, kernel, card):
    """Print the device time of one call by kernel, beside its wall time:
    busy share, ``kernel``'s share, the largest other kernels; returns those
    numbers (``None`` when the profiler saw no device time)."""
    if by_name is None:
        log(f"  {what}: device time by kernel not measured (the profiler saw no device time)")
        return None

    def total(keep):
        picked = [v for name, v in by_name.items() if keep(kernel in name)]
        return sum(ms for ms, _n in picked), sum(n for _ms, n in picked)

    busy, launches = total(lambda ours: True)
    ours_ms, ours_n = total(lambda ours: ours)
    log(f"  {what} [{card}]: device busy {busy:.2f} of "
        f"{wall_ms:.2f} ms (idle share {1 - busy / wall_ms:.3f}), {launches:.0f} kernel "
        f"launches; {kernel} {ours_ms:.2f} ms in {ours_n:.0f} launches "
        f"({ours_ms / busy:.3f} of busy); other kernels {busy - ours_ms:.2f} ms in "
        f"{launches - ours_n:.0f} launches, largest:")
    for ms, n, name in sorted(((ms, n, name) for name, (ms, n) in by_name.items()
                               if kernel in name), reverse=True):
        log(f"    {kernel}: {ms:8.3f} ms {n:5.0f} x  {name[:110]}")
    others = sorted(((ms, n, name) for name, (ms, n) in by_name.items()
                     if kernel not in name), reverse=True)
    for ms, n, name in others[:6]:
        log(f"    {ms:8.3f} ms {n:5.0f} x  {name[:90]}")
    return dict(busy_ms=busy, wall_ms=wall_ms, idle_share=1 - busy / wall_ms, launches=launches,
                kernel_ms=ours_ms, kernel_launches=ours_n)


def wgmma_waits(lib_path):
    """wgmma (HGMMA: bf16; IGMMA: int8) and WARPGROUP.DEPBAR counts of each
    kernel in a built library (``cuobjdump -sass``): a pipelined kernel has a
    few waits, not one after each wgmma."""
    cuobjdump = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    try:
        sass = subprocess.run([str(cuobjdump), "-sass", lib_path], capture_output=True,
                              text=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"SASS not read ({e.__class__.__name__})"
    counts, cur = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = ln.split("Function :")[-1].strip()
            counts[cur] = [0, 0]
        elif cur is not None:
            counts[cur][0] += "HGMMA" in ln or "IGMMA" in ln
            counts[cur][1] += "WARPGROUP.DEPBAR" in ln
    pairs = sorted({tuple(v) for v in counts.values()})
    return (f"{len(counts)} kernels, (HGMMA or IGMMA, WARPGROUP.DEPBAR) per kernel: "
            f"{', '.join(f'({h}, {d})' for h, d in pairs)}")


def reset_launches():
    """Set every kernel's launch count to 0 (just before a path is driven)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lut_dequant_gemm as dq
    from repro_torch.kernels import lut_stream_gemm as ss

    dq.launches = dq.launches_tc = fa.launches = fa.launches_tc = 0
    ss.launches = ss.launches_tc = ss.launches_lookup = ss.launches_canon = 0


def read_launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lut_dequant_gemm as dq
    from repro_torch.kernels import lut_stream_gemm as ss

    return {"lut_dequant_gemm": dq.launches, "lut_dequant_gemm_tc": dq.launches_tc,
            "lut_stream_gemm": ss.launches, "lut_stream_gemm_tc": ss.launches_tc,
            "lut_stream_gemm_lookup": ss.launches_lookup,
            "lut_stream_gemm_canon": ss.launches_canon,
            "flash_attention": fa.launches, "flash_attention_tc": fa.launches_tc}


def phase_kernel(torch, dev):
    """The sweep through both routes: f32 x and the fp grid on the CUDA cores,
    bf16 x on the int and uint grids (K permitting) on the tensor cores;
    every call's route counter checked, kernel vs plain at TOL_REL, and at
    B = 37 each row alone equal to the same row in the batch."""
    from repro_torch.core.api import LutLinearSpec, quantize_linear
    from repro_torch.kernels import lut_dequant_gemm as dq
    from repro_torch.kernels import ref
    from repro_torch.core.quantize import QuantSpec

    gen = torch.Generator(device=dev).manual_seed(1)
    grids = [(1, "int"), (2, "int"), (4, "int"), (8, "int"), (4, "uint"), (2, "fp"), (4, "fp"),
             (8, "fp")]
    shapes = [(32, 16), (64, 48), (129, 200), (256, 96),                    # unit-test shapes
              (5120, 5120), (5120, 1280), (5120, 13824), (13824, 5120),     # full width
              (1001, 300), (1056, 300), (1056, 301)]                        # ragged K, F
    worst_rel = worst_abs = 0.0
    n_cases = {"tc": 0, "cuda_core": 0}
    for bw, kind in grids:
        for k, f in shapes:
            w = torch.randn((k, f), generator=gen, device=dev)
            q = quantize_linear(w, LutLinearSpec(bw=bw, w_kind=kind))
            del w
            g = QuantSpec(bw, kind).grid()
            for b in (1, 4, 37, 256):
                x32 = torch.randn((b, k), generator=gen, device=dev)
                for x in (x32, x32.to(torch.bfloat16)):
                    which = dq.route(x.dtype, bw, g, k)
                    before = (dq.launches, dq.launches_tc)
                    y = dq.lut_dequant_gemm(x, q.codes, q.scale, bw=bw, k=k, grid_values=g)
                    check((dq.launches, dq.launches_tc) == (before[0] + 1,
                                                            before[1] + (which == "tc")),
                          f"route counters: bw={bw} {kind} K={k} {x.dtype} went "
                          f"{dq.launches_tc - before[1]} times to the tensor cores, want "
                          f"{int(which == 'tc')} ({which})")
                    y_plain = ref.lut_dequant_gemm_ref(x, q.codes, q.scale, bw=bw, k=k, grid=g)
                    diff = (y - y_plain).abs().max().item()
                    rel = diff / max(y_plain.abs().max().item(), 1e-30)
                    check(rel <= TOL_REL, f"kernel vs plain ({which}): bw={bw} {kind} B={b} "
                                          f"K={k} F={f} {x.dtype}: rel err {rel:.3e} > {TOL_REL}")
                    worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, diff)
                    n_cases[which] += 1
                    if b == 37:
                        alone = torch.cat([
                            dq.lut_dequant_gemm(x[i : i + 1], q.codes, q.scale, bw=bw, k=k,
                                                grid_values=g) for i in range(b)])
                        check(torch.equal(alone, y),
                              f"row alone != row in a batch of 37 ({which}): bw={bw} {kind} "
                              f"K={k} F={f} {x.dtype}")
    torch.cuda.synchronize()
    log(f"phase 2: {sum(n_cases.values())} kernel-vs-plain cases ({n_cases['tc']} on the "
        f"tensor cores, {n_cases['cuda_core']} on the CUDA cores, each call's route counter "
        f"checked) + per-row invariance at B=37 passed; worst rel err {worst_rel:.3e}, worst "
        f"abs err {worst_abs:.3e} (tol {TOL_REL})")
    return worst_rel, worst_abs


# Full-width shapes of the bf16 main paths for the across-B check: (what, K, F).
ROW_SHAPES = [("stablelm-12b wq (S=3)", 5120, 5120), ("stablelm-12b wk (S=4)", 5120, 1280),
              ("stablelm-12b w_down (S=3)", 13824, 5120), ("gemma2-2b wq (S=4)", 2304, 2048),
              ("gemma2-2b w_up (S=1)", 2304, 9216), ("gemma2-2b wo", 2048, 2304),
              ("gemma2-2b w_down", 9216, 2304)]
ROW_BS = (37, 512, 2048, 8192, 4 * 4096)   # up to gemma2-2b's served prefill, 4 x 4096 rows


def phase_row_invariance(torch, dev):
    """Per-row invariance across B on the tensor-core route at full width: 4
    fixed rows computed alone (B = 4) and at the end of batches of B = 37,
    512, 2048, 8192 and 16384 (the first alone at B = 1) are bit-equal, on split and
    unsplit layers (the split's CTAs per tile and the x rows per CTA change
    with B; its slices and their order do not)."""
    from repro_torch.core.api import LutLinearSpec, quantize_linear
    from repro_torch.kernels import lut_dequant_gemm as dq
    from repro_torch.core.quantize import QuantSpec

    gen = torch.Generator(device=dev).manual_seed(5)
    g = QuantSpec(4, "int").grid()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for what, k, f in ROW_SHAPES:
        w = torch.randn((k, f), generator=gen, device=dev)
        q = quantize_linear(w, LutLinearSpec(bw=4))
        del w
        x_all = torch.randn((max(ROW_BS), k), generator=gen, device=dev).to(torch.bfloat16)
        fixed = x_all[-4:]
        before = dq.launches_tc
        want = dq.lut_dequant_gemm(fixed, q.codes, q.scale, bw=4, k=k, grid_values=g)
        y1 = dq.lut_dequant_gemm(fixed[:1], q.codes, q.scale, bw=4, k=k, grid_values=g)
        check(torch.equal(y1, want[:1]), f"{what}: row alone at B=1 != the same row at B=4")
        plans = {}
        for b in ROW_BS:
            y = dq.lut_dequant_gemm(x_all[-b:], q.codes, q.scale, bw=4, k=k, grid_values=g)
            check(torch.equal(y[-4:], want),
                  f"{what}: rows at the end of a batch of {b} != the same rows at B=4")
            plans[b] = dq.tile_plan(b, f, k, 4, n_sm)
        check(dq.launches_tc == before + 2 + len(ROW_BS),
              f"{what}: not every launch took the tensor cores")
        plans[4] = dq.tile_plan(4, f, k, 4, n_sm)
        log(f"  {what}: rows bit-equal at B=1/4/{'/'.join(map(str, ROW_BS))} (plans (N, S, CTAs per "
            f"tile): {', '.join(f'B={b} {plans[b]}' for b in sorted(plans))})")
        del x_all, q
    torch.cuda.empty_cache()
    log("phase 2: per-row invariance across B on the tensor-core route passed at "
        f"{len(ROW_SHAPES)} full-width shapes")


def phase_kernel_times(torch, dev, cfg, card, *, bs=(4, 4 * 128), iters=(20, 5, 5),
                       label="phase 2", shapes=None):
    """Kernel, plain-version and library times at ``shapes`` (``{name: (K,
    F)}``; default: one layer's 7 projection shapes of ``cfg``) for each row
    count in ``bs`` (the serve path's decode B = 4 and largest prefill B = 4
    x 128; gemma2-2b's served decode B = 4, its 4 x 4096 prefill and its
    forward, B = 8192),
    W4, bf16 x (the tensor-core route), with ``iters`` timed calls of the
    kernel, the plain version and each yardstick, device time (:func:`device_ms`);
    the kernel is held against its plain version at each of them too.  Two
    yardsticks: ``torch.matmul`` of f32 x and the pre-decoded f32 weight (the
    same function), and bf16 ``torch.matmul`` of x and the pre-decoded bf16
    grid values times the scale (its output rounded to bf16 before the
    scale: nearly the same function).  At B = 4 also the host's time to
    launch one kernel call and one f32 ``torch.matmul``."""
    from repro_torch.core import packing
    from repro_torch.core.api import LutLinearSpec, dequantize_weights, quantize_linear
    from repro_torch.kernels import lut_dequant_gemm as dq
    from repro_torch.kernels import ref
    from repro_torch.core.quantize import QuantSpec

    gen = torch.Generator(device=dev).manual_seed(2)
    g = QuantSpec(4, "int").grid()
    g_bf16 = torch.tensor(g, dtype=torch.float32, device=dev).to(torch.bfloat16)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    worst_rel = worst_abs = 0.0
    shapes = layer_shapes(cfg) if shapes is None else shapes
    for name, (k, f) in shapes.items():
        w = torch.randn((k, f), generator=gen, device=dev)
        q = quantize_linear(w, LutLinearSpec(bw=4))
        w_t = dequantize_weights(q).T.contiguous()          # [F, K] f32, pre-decoded
        w_g = g_bf16[packing.unpack_bits(q.codes, 4)[:, :k].long()]   # [F, K] bf16 grid values
        del w
        # Rotate over enough copies of the codes that they overflow the 50 MB
        # L2: the serve path reads each layer's codes cold.
        n_copies = max(1, math.ceil(200e6 / q.codes.numel()))
        codes = [q.codes.clone() for _ in range(n_copies)]
        for b in bs:
            x = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
            x32 = x.float()
            before = dq.launches_tc
            y = dq.lut_dequant_gemm(x, q.codes, q.scale, bw=4, k=k, grid_values=g)
            check(dq.launches_tc == before + 1, f"{name} B={b} did not take the tensor cores")
            y_plain = ref.lut_dequant_gemm_ref(x, q.codes, q.scale, bw=4, k=k, grid=g)
            diff = (y - y_plain).abs().max().item()
            rel = diff / max(y_plain.abs().max().item(), 1e-30)
            check(rel <= TOL_REL, f"kernel vs plain at {name} B={b}: rel err {rel:.3e}")
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, diff)

            def kern(i):
                dq.lut_dequant_gemm(x, codes[i % n_copies], q.scale, bw=4, k=k, grid_values=g)

            ms = device_ms(torch, kern, iters[0])
            plain = device_ms(torch, lambda i: ref.lut_dequant_gemm_ref(
                x, codes[i % n_copies], q.scale, bw=4, k=k, grid=g), iters[1])
            lib = device_ms(torch, lambda i: torch.matmul(x32, w_t.T), iters[2])
            lib16 = device_ms(torch, lambda i: torch.matmul(x, w_g.T).float() * q.scale, iters[2])
            bnd, by = bound_s(b, k, f, 4, 2, card)
            nbytes = b * k * 2 + f * (-(-k // 2)) + 4 * f + 4 * b * f
            rate = (f"{2 * b * f * k / ms / 1e9:.1f} TFLOP/s" if by == "operations"
                    else f"{nbytes / ms / 1e6:.1f} GB/s")
            row = dict(proj=name, B=b, K=k, F=f, ms=ms, plain_ms=plain, library_ms=lib,
                       library_bf16_ms=lib16, bound_ms=bnd * 1e3, bound_by=by,
                       frac_bound=bnd * 1e3 / ms, plan=dq.tile_plan(b, f, k, 4, n_sm))
            line = (f"  {name:6s} B={b:4d} K={k:5d} F={f:5d} (N, S, CTAs/tile) {row['plan']}: "
                    f"kernel {ms:.4f} ms ({rate}, {row['frac_bound']:.3f} of the bound "
                    f"{bnd*1e3:.4f} ms, {by}), plain {plain:.4f} ms, torch.matmul(f32 x, f32 "
                    f"decoded) {lib:.4f} ms, torch.matmul(bf16 x, bf16 grid) x scale {lib16:.4f} "
                    f"ms (bf16 output: nearly the same function)")
            if b <= 8:
                row["host_us"] = host_us(torch, kern)
                row["library_host_us"] = host_us(torch, lambda i: torch.matmul(x32, w_t.T))
                line += (f"; host per launch {row['host_us']:.1f} us (torch.matmul "
                         f"{row['library_host_us']:.1f} us)")
            rows.append(row)
            log(line)
            del x, x32, y, y_plain
        del codes, w_t, w_g, q
    torch.cuda.empty_cache()
    for b in bs:
        picked = [r for r in rows if r["B"] == b]
        t = {key: sum(r[key] for r in picked)
             for key in ("ms", "plain_ms", "library_ms", "library_bf16_ms", "bound_ms")}
        log(f"{label}: {cfg.name}, {len(shapes)} projection shapes at B={b}: kernel "
            f"{t['ms']:.4f} ms ({t['bound_ms'] / t['ms']:.3f} of the bound {t['bound_ms']:.4f} "
            f"ms), plain {t['plain_ms']:.4f} ms, torch.matmul f32 {t['library_ms']:.4f} ms "
            f"({t['library_ms'] / t['ms']:.2f}x the kernel), bf16 {t['library_bf16_ms']:.4f} ms")
    log(f"{label}: {cfg.name}'s projection shapes at B={'/'.join(map(str, bs))} agree with the "
        f"plain version (tol {TOL_REL}); worst rel err {worst_rel:.3e}, worst abs err "
        f"{worst_abs:.3e}")
    return rows, worst_rel, worst_abs


# ---------------------------------------------------------------------------
# Phases 6-7: lut_stream_gemm vs its plain version; one full-width lut layer
# ---------------------------------------------------------------------------


def stream_bound_s(m, g, n, r, c, pf, card):
    """Least time of one lut_stream_gemm call counted in lookups: each int32
    input read once (wpacked, msrank, permid, both LUTs) and the output
    written once, over the memory rate; or its M*G*N int32 lookup-adds over
    the CUDA cores' peak operation rate (the float32 non-tensor rate of the
    table; a data-dependent gather-add has no faster unit).  Returns
    (seconds, bound_by)."""
    nbytes = 4 * (m * g + 2 * g * n + r * c + r * pf + m * n)
    t_bytes, t_ops = nbytes / card.hbm_bandwidth, m * g * n / card.peak_flops_f32
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stream_tc_bound_s(m, g, n, r, card):
    """Least time of the tensor-core route's product: wpacked (int32), the
    composed operand (N x G*R bytes) read once and the int32 output written
    once, over the memory rate; or its 2*M*G*R*N one-hot operations over the
    int8 tensor-core peak.  Returns (seconds, bound_by)."""
    nbytes = 4 * m * g + n * g * r + 4 * m * n
    t_bytes, t_ops = nbytes / card.hbm_bandwidth, 2.0 * m * g * r * n / card.peak_ops_int8
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def canon_bound_s(k, n, g, r, card):
    """Least time of the canonicalize kernel: each int32 code read once,
    msrank and permid (int32) and the composed operand (R bytes a group)
    written once, over the memory rate (a handful of integer operations a
    group is far below the CUDA cores' rate).  Returns (seconds, "bytes")."""
    return (4 * k * n + 8 * g * n + n * g * r) / card.hbm_bandwidth, "bytes"


def plain_stream_chunked(torch, ref, wpk, ms, pid, canon, reorder, cols=16):
    """The plain version over column chunks: its [M, G, N] gather would not
    fit the card at N = 512."""
    return torch.cat([
        ref.lut_stream_gemm_ref(wpk, ms[:, c0 : c0 + cols], pid[:, c0 : c0 + cols], canon, reorder)
        for c0 in range(0, ms.shape[1], cols)], dim=1)


def check_canonicalize(torch, dev, pack, codes, what):
    """The canonicalize kernel on ``codes`` (a CPU [K, N] tensor, moved to the
    card with its strides) against the plain chain on the CPU and on the card
    and the sorting network's plain form; on the tensor-core and lookup routes
    also its composed operand against the plain compose step of that route."""
    from repro_torch.core import engine
    from repro_torch.core.quantize import zero_code
    from repro_torch.kernels import lut_stream_gemm as ss
    from repro_torch.kernels import ref

    cd = codes.to(dev)
    before = ss.launches_canon
    got = engine.canonicalize_activations(cd, pack)
    check(ss.launches_canon == before + 1, f"canonicalize {what}: not one kernel launch")
    want = engine.canonicalize_activations(codes, pack)
    on_card = engine.canonicalize_activations_plain(cd, pack)
    net = ref.lut_canon_ref(cd, engine.device_binom(pack, dev), p=pack.p,
                            pad_code=zero_code(pack.agrid))
    for name, (ms, pid) in (("CPU plain", (want.msrank, want.permid)),
                            ("card plain", (on_card.msrank.cpu(), on_card.permid.cpu())),
                            ("sorting network", (net[0].cpu(), net[1].cpu()))):
        check(torch.equal(got.msrank.cpu(), ms) and torch.equal(got.permid.cpu(), pid),
              f"canonicalize kernel != {name} ({what})")
    which = ss.route(pack)
    wants = which in ("tc", "lookup")
    check((got.composed is not None) == wants,
          f"canonicalize {what}: composed operand {'missing' if wants else 'built'} on the "
          f"{which} route")
    if which == "tc":
        canon, reorder = engine.device_tables(pack, dev)
        g = got.msrank.shape[0]
        check(torch.equal(got.composed[:, : g * pack.n_rows],
                          ref.lut_compose_ref(got.msrank, got.permid, canon, reorder)),
              f"composed operand != plain compose step ({what})")
    elif which == "lookup":
        ct, rt = engine.device_byte_tables(pack, dev)
        n = got.msrank.shape[1]
        want_s = ref.lut_compose_lookup_ref(got.msrank, got.permid, ct, rt, nt=ss.lookup_tile(n))
        check(torch.equal(got.composed, want_s),
              f"lookup slices (lut_canon mode 3) != plain tiled compose ({what})")
        check(torch.equal(ss.compose_lookup(got.msrank, got.permid, ct, rt, p=pack.p), want_s),
              f"lookup slices (lut_canon mode 4) != plain tiled compose ({what})")


def phase_stream_kernel(torch, dev):
    """The CPU tests' sweep on the card through the three routes of
    lut_stream_gemm (the pack's route: the tensor cores or the lookup kernel;
    the CUDA cores for every pack, by calling without the pack), each call's
    route counters checked, kernel == plain version on the card == plain
    version on the CPU, bit for bit; and the canonicalize kernel against the
    plain chain on all 8^4 groups of A3 p=4 (both code layouts) and on every
    case, with both compose modes of each route against the plain compose."""
    import itertools

    import numpy as np
    from repro_torch.core import engine, luts
    from repro_torch.kernels import lut_stream_gemm as ss
    from repro_torch.kernels import ops, ref

    n_cases = {"tc": 0, "lookup": 0, "cuda_core": 0, "canonicalize": 0}

    def counters():
        return (ss.launches, ss.launches_tc, ss.launches_lookup, ss.launches_canon)

    a3p4 = luts.build_lut_pack(1, 3, 4)
    allg = np.array(list(itertools.product(range(8), repeat=4)), dtype=np.int32)   # [4096, 4]
    for codes, layout in ((torch.from_numpy(allg.T.copy()), "[K, N]"),
                          (torch.from_numpy(allg).T, "[N, K] in memory")):
        check_canonicalize(torch, dev, a3p4, codes, f"all 4096 groups of A3 p=4, {layout}")
        n_cases["canonicalize"] += 1
    for bw, ba, p in STREAM_PACKS:
        pack = luts.build_lut_pack(bw, ba, p)
        which = ss.route(pack)
        canon, reorder = engine.device_tables(pack, dev)
        for m, k, n in [(16, 3 * p + 1, 6), (8, 13, 6), (300, 101, 4), (1000, 250, 37),
                        (4096, 1030, 129)]:
            rng = np.random.default_rng(m * 1000 + k + n + p)
            wc = torch.from_numpy(rng.integers(0, 2**bw, (m, k)).astype(np.int32))
            ac = torch.from_numpy(rng.integers(0, 2**ba, (k, n)).astype(np.int32))
            want = ops.lut_stream_gemm_full(wc, ac, pack)                 # CPU, plain
            wd, ad = wc.to(dev), ac.to(dev)
            for nt in (1, 3, 4, 6, 16):
                before = counters()
                got = ops.lut_stream_gemm_full(wd, ad, pack, nt=nt)
                check(counters() == (before[0] + 1, before[1] + (which == "tc"),
                                     before[2] + (which == "lookup"), before[3] + 1),
                      f"route counters: ({bw},{ba},{p}) ({which}) M={m} K={k} N={n} nt={nt}")
                check(torch.equal(got.cpu(), want),
                      f"lut_stream_gemm_full (bw,ba,p)=({bw},{ba},{p}) ({which}) M={m} K={k} "
                      f"N={n} nt={nt}: card != CPU plain version")
                n_cases[which] += 1
            for layout, codes in (("[K, N]", ac), ("[N, K] in memory",
                                                   torch.from_numpy(ac.numpy().T.copy()).T)):
                check_canonicalize(torch, dev, pack, codes, f"({bw},{ba},{p}) K={k} N={n}, {layout}")
                n_cases["canonicalize"] += 1
            wpk = engine.prepare_stream_weights(wd, pack).wpk
            idx = engine.canonicalize_activations(ad, pack)
            plain = ref.lut_stream_gemm_ref(wpk, idx.msrank, idx.permid, canon, reorder)
            calls = [("cuda_core", {}, 0)]
            if which != "cuda_core":
                calls += [(which, {"pack": pack}, 1),
                          (which, {"pack": pack, "composed": idx.composed}, 0)]
            for route, kw, composes in calls:
                before = counters()
                out = ss.lut_stream_gemm(wpk, idx.msrank, idx.permid, canon, reorder, **kw)
                check(counters() == (before[0] + 1, before[1] + (route == "tc"),
                                     before[2] + (route == "lookup"), before[3] + composes),
                      f"route counters: lut_stream_gemm ({bw},{ba},{p}) {route} M={m} N={n}")
                check(torch.equal(out, plain), f"lut_stream_gemm ({route}) != plain version on "
                                               f"the card: ({bw},{ba},{p}) M={m} K={k} N={n}")
                n_cases[route] += 1
            if which == "tc":
                check(torch.equal(ref.lut_onehot_gemm_ref(wpk, idx.composed, r=pack.n_rows),
                                  plain), f"plain one-hot product != plain version: "
                                          f"({bw},{ba},{p}) M={m} N={n}")
            if which == "lookup":
                check(torch.equal(ref.lut_lookup_gemm_ref(wpk, idx.composed, n=n), plain),
                      f"plain lookup sum != plain version: ({bw},{ba},{p}) M={m} N={n}")
    torch.cuda.synchronize()
    log(f"phase 6: {n_cases['tc'] + n_cases['lookup'] + n_cases['cuda_core']} "
        f"lut_stream_gemm-vs-plain cases ({n_cases['tc']} on the int8 tensor cores, "
        f"{n_cases['lookup']} on the lookup kernel, {n_cases['cuda_core']} on the CUDA cores; "
        f"{len(STREAM_PACKS)} packs, R = 2 .. 256, ragged K, nt 1/3/4/6/16; card vs card plain "
        f"and vs CPU plain; each call's route counters checked) and {n_cases['canonicalize']} "
        f"canonicalize-kernel cases (the 4096 groups of A3 p=4 in both layouts, every sweep "
        f"case; msrank / permid and the composed operand of the tc and lookup routes, both "
        f"compose modes) equal bit for bit")


def phase_stream_times(torch, dev, cfg, card, smi, *, shapes=None, label="phase 6",
                       bs=(4, 4 * 128)):
    """Times at the lut serve path's shapes (``shapes``, ``{name: (K, F)}``;
    default: one layer's seven projections of ``cfg``) at W1A3 p=4, decode
    (N = 4) and prefill (N = 4 x 128; ``bs`` sets both).  The
    canonicalize kernel on the quantizer's codes (a transposed view, as on the
    path) beside the plain chain; lut_stream_gemm on its route (the int8
    tensor cores, the composed operand as given) and on the CUDA cores, both
    held against the plain version (over column chunks at N = 512) and the
    library yardstick (the reference's one-hot BLAS form, f32 torch.matmul)
    bit for bit.  Kernels and the yardstick in device time (:func:`device_ms`),
    the plain versions on CUDA events around their calls."""
    from repro_torch.core import engine
    from repro_torch.core.api import LutLinearSpec, _lut_pack_cache, quantize_linear
    from repro_torch.core.prepared import prepare_linear
    from repro_torch.core.quantize import quantize
    from repro_torch.kernels import lut_stream_gemm as ss
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(5)
    spec = LutLinearSpec(mode="lut", **LUT_SPEC)
    pack = _lut_pack_cache(spec.bw, spec.ba, spec.p, spec.w_kind, spec.a_kind)
    check(ss.route(pack) == "tc", "the serve pack W1A3 p=4 must take the tensor cores")
    canon, reorder = engine.device_tables(pack, dev)
    r, c, pf = canon.shape[0], canon.shape[1], reorder.shape[1]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    worst = 0
    shapes = layer_shapes(cfg) if shapes is None else shapes
    for name, (k, f) in shapes.items():
        w = torch.randn((k, f), generator=gen, device=dev)
        wpk = prepare_linear(quantize_linear(w, spec), n_hint=4).wpk          # [F, G]
        del w
        m, g = wpk.shape
        # Rotate over enough copies that they overflow the 50 MB L2: the serve
        # path reads each layer's wpk cold.
        n_copies = max(1, math.ceil(200e6 / (4 * wpk.numel())))
        wpks = [wpk.clone() for _ in range(n_copies)]
        onehot = torch.zeros((m, g, r), dtype=torch.float32, device=dev)
        onehot.scatter_(2, wpk[:, :, None].long(), 1.0)
        onehot = onehot.reshape(m, g * r)                                    # [M, G*R]
        for b in bs:
            x = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
            acodes, _ = quantize(x.float().T, spec.aspec())                 # [K, N] view
            idx = engine.canonicalize_activations(acodes, pack)
            ms, pid, bop = idx.msrank, idx.permid, idx.composed
            plain_idx = engine.canonicalize_activations_plain(acodes, pack)
            check(torch.equal(ms, plain_idx.msrank) and torch.equal(pid, plain_idx.permid),
                  f"canonicalize kernel != plain chain at {name} N={b}")
            check(torch.equal(bop[:, : g * r], ref.lut_compose_ref(ms, pid, canon, reorder)),
                  f"composed operand != plain compose at {name} N={b}")
            before = ss.launches_tc
            y = ss.lut_stream_gemm(wpk, ms, pid, canon, reorder, pack=pack, composed=bop)
            check(ss.launches_tc == before + 1, f"{name} N={b} did not take the tensor cores")
            y_cc = ss.lut_stream_gemm(wpk, ms, pid, canon, reorder)
            y_plain = (ref.lut_stream_gemm_ref(wpk, ms, pid, canon, reorder) if b == 4 else
                       plain_stream_chunked(torch, ref, wpk, ms, pid, canon, reorder))
            worst = max(worst, (y - y_plain).abs().max().item())
            check(torch.equal(y, y_plain), f"lut_stream_gemm (tc) != plain at {name} N={b}")
            check(torch.equal(y_cc, y_plain), f"lut_stream_gemm (cuda_core) != plain at {name} "
                                              f"N={b}")
            composed = bop[:, : g * r].T.float()                             # [G*R, N]
            y_lib = torch.matmul(onehot, composed)
            check(torch.equal(y_lib.to(torch.int32), y),
                  f"one-hot BLAS yardstick != kernel at {name} N={b}")
            kern = device_ms(torch, lambda i: ss.lut_stream_gemm(
                wpks[i % n_copies], ms, pid, canon, reorder, pack=pack, composed=bop), 20)
            cuda_core = device_ms(torch, lambda i: ss.lut_stream_gemm(
                wpks[i % n_copies], ms, pid, canon, reorder), 10)
            if b == 4:
                plain = time_ms(torch, lambda i: ref.lut_stream_gemm_ref(
                    wpks[i % n_copies], ms, pid, canon, reorder), 3)
            else:
                plain = time_ms(torch, lambda i: plain_stream_chunked(
                    torch, ref, wpks[i % n_copies], ms, pid, canon, reorder), 1)
            lib = device_ms(torch, lambda i: torch.matmul(onehot, composed), 5)
            canon_ms = device_ms(torch, lambda i: engine.canonicalize_activations(acodes, pack), 20)
            canon_plain = time_ms(
                torch, lambda i: engine.canonicalize_activations_plain(acodes, pack), 5)
            bnd, by = stream_tc_bound_s(m, g, b, r, card)
            lbnd, lby = stream_bound_s(m, g, b, r, c, pf, card)
            cbnd, _ = canon_bound_s(k, b, g, r, card)
            row = dict(proj=name, B=b, K=k, F=f, ms=kern, cuda_core_ms=cuda_core, plain_ms=plain,
                       library_ms=lib, bound_ms=bnd * 1e3, bound_by=by,
                       lookup_bound_ms=lbnd * 1e3, lookup_bound_by=lby,
                       plan=ss.tc_split(m, g, r, b, n_sm), canon_ms=canon_ms,
                       canon_plain_ms=canon_plain, canon_bound_ms=cbnd * 1e3)
            line = (f"  {name:6s} N={b:4d} M={m:5d} G={g:4d} (n_tile, S) {row['plan']}: kernel "
                    f"(tc) {kern:.4f} ms ({bnd * 1e3 / kern:.3f} of its bound {bnd*1e3:.4f} ms, "
                    f"{by}; {2.0 * m * g * r * b / kern / 1e9:.1f} TOP/s), CUDA-core kernel "
                    f"{cuda_core:.4f} ms, plain {plain:.4f} ms, one-hot torch.matmul {lib:.4f} "
                    f"ms, lookup bound {lbnd*1e3:.4f} ms ({lby}); canonicalize kernel "
                    f"{canon_ms:.4f} ms ({cbnd * 1e3 / canon_ms:.3f} of its bytes bound "
                    f"{cbnd*1e3:.4f} ms), plain chain {canon_plain:.4f} ms")
            if b <= 8:
                def pair(i):
                    ix = engine.canonicalize_activations(acodes, pack)
                    ss.lut_stream_gemm(wpks[i % n_copies], ix.msrank, ix.permid, canon, reorder,
                                       pack=pack, composed=ix.composed)
                row["host_us"] = host_us(torch, pair)
                line += f"; host per canonicalize + GEMM {row['host_us']:.1f} us"
            rows.append(row)
            log(line + f" [{smi}]")
            del composed, y_lib, idx, plain_idx
        del wpks, onehot
    torch.cuda.empty_cache()
    for b in bs:
        picked = [row for row in rows if row["B"] == b]
        t = {key: sum(row[key] for row in picked)
             for key in ("ms", "cuda_core_ms", "plain_ms", "library_ms", "bound_ms",
                         "lookup_bound_ms", "canon_ms", "canon_plain_ms", "canon_bound_ms")}
        log(f"{label}: {cfg.name}, {len(shapes)} projection shapes at N={b}: lut_stream_gemm "
            f"(tc) "
            f"{t['ms']:.4f} ms ({t['bound_ms'] / t['ms']:.3f} of its bound {t['bound_ms']:.4f} "
            f"ms; lookup bound {t['lookup_bound_ms']:.4f} ms), CUDA-core kernel "
            f"{t['cuda_core_ms']:.4f} ms ({t['cuda_core_ms'] / t['ms']:.2f}x), plain "
            f"{t['plain_ms']:.4f} ms, one-hot torch.matmul {t['library_ms']:.4f} ms "
            f"({t['library_ms'] / t['ms']:.2f}x); canonicalize {t['canon_ms']:.4f} ms "
            f"(bound {t['canon_bound_ms']:.4f} ms), plain chain {t['canon_plain_ms']:.4f} ms "
            f"[{smi}]")
    log(f"{label}: the lut serve path's shapes (N={' and '.join(map(str, bs))}) equal the "
        f"plain version and the one-hot yardstick bit for bit on both routes")
    return rows, worst


def phase_tc_cp_async(torch, dev, cfg, card, smi):
    """The tensor-core route where TMA cannot address ``wpacked`` (row pitch
    4G not a multiple of 16 bytes), so its stages come by ``cp.async``:
    stablelm-12b's w_down at W1A3 p = 5 (K = 13824, G = 2765; the 16 GiB
    plan's), N = 4 and 4 x 128.  The kernel against the plain version, then
    called ``LOOKUP_REPEATS`` times more back to back, each result held to
    the first bit for bit (a race in the stages' release shows as a
    change); device times beside the bound and the CUDA-core kernel."""
    from repro_torch.core import engine
    from repro_torch.core.api import LutLinearSpec, _lut_pack_cache, quantize_linear
    from repro_torch.core.prepared import prepare_linear
    from repro_torch.core.quantize import quantize
    from repro_torch.kernels import lut_stream_gemm as ss
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(19)
    spec = LutLinearSpec(mode="lut", bw=1, ba=3, p=5)
    pack = _lut_pack_cache(spec.bw, spec.ba, spec.p, spec.w_kind, spec.a_kind)
    check(ss.route(pack) == "tc", "W1A3 p=5 must take the tensor cores")
    canon, reorder = engine.device_tables(pack, dev)
    k, f = layer_shapes(cfg)["w_down"]
    w = torch.randn((k, f), generator=gen, device=dev)
    wpk = prepare_linear(quantize_linear(w, spec), n_hint=4).wpk                # [F, G]
    del w
    m, g = wpk.shape
    check((4 * g) % 16 != 0, f"w_down at p=5: G={g} must be a cp.async shape (4G % 16 != 0)")
    n_copies = max(1, math.ceil(200e6 / (4 * wpk.numel())))                  # cold in L2
    wpks = [wpk.clone() for _ in range(n_copies)]
    rows = []
    for b in (4, 4 * 128):
        x = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
        acodes, _ = quantize(x.float().T, spec.aspec())                         # [K, N] view
        idx = engine.canonicalize_activations(acodes, pack)
        ms, pid, bop = idx.msrank, idx.permid, idx.composed
        before = ss.launches_tc
        y = ss.lut_stream_gemm(wpk, ms, pid, canon, reorder, pack=pack, composed=bop)
        check(ss.launches_tc == before + 1, f"w_down p=5 N={b} did not take the tensor cores")
        for rep in range(LOOKUP_REPEATS):        # back to back: a race shows as a change
            again = ss.lut_stream_gemm(wpk, ms, pid, canon, reorder, pack=pack, composed=bop)
            check(torch.equal(again, y), f"lut_stream_gemm (tc, cp.async) at w_down p=5 N={b}: "
                                         f"call {rep + 2} differs from the first")
        y_plain = (ref.lut_stream_gemm_ref(wpk, ms, pid, canon, reorder) if b == 4 else
                   plain_stream_chunked(torch, ref, wpk, ms, pid, canon, reorder))
        check(torch.equal(y, y_plain), f"lut_stream_gemm (tc, cp.async) != plain at w_down p=5 "
                                       f"N={b}")
        kern = device_ms(torch, lambda i: ss.lut_stream_gemm(
            wpks[i % n_copies], ms, pid, canon, reorder, pack=pack, composed=bop), 20)
        cuda_core = device_ms(torch, lambda i: ss.lut_stream_gemm(
            wpks[i % n_copies], ms, pid, canon, reorder), 5 if b == 4 else 2)
        bnd, by = stream_tc_bound_s(m, g, b, pack.n_rows, card)
        rows.append(dict(proj="w_down", p=5, B=b, K=k, F=f, G=g, ms=kern, cuda_core_ms=cuda_core,
                         bound_ms=bnd * 1e3, bound_by=by))
        log(f"  w_down p=5 N={b:4d} M={m} G={g} (cp.async stages): kernel (tc) {kern:.4f} ms "
            f"({bnd * 1e3 / kern:.3f} of its bound {bnd * 1e3:.4f} ms, {by}), CUDA-core kernel "
            f"{cuda_core:.4f} ms [{smi}]")
        del idx, y, y_plain
    del wpks
    torch.cuda.empty_cache()
    log(f"phase 6: the tensor-core route's cp.async stages (w_down at p=5, G={g}): "
        f"{LOOKUP_REPEATS} repeated calls equal to the first and to the plain version at N=4 "
        f"and 512")
    return rows


def stream_lookup_bound_s(m, g, n, r, card):
    """Least time of the lookup route's product: wpacked (int32) and the
    composed slices (G*R*N bytes) read once and the int32 output written
    once, over the memory rate; or its M*G*N lookup-adds over the CUDA cores'
    peak operation rate (the f32 non-tensor rate of the table).  Returns
    (seconds, bound_by)."""
    nbytes = 4 * m * g + g * r * n + 4 * m * n
    t_bytes, t_ops = nbytes / card.hbm_bandwidth, m * g * n / card.peak_flops_f32
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_lookup_times(torch, dev, cfg, card, smi):
    """The lookup route at a capacity plan's packing degrees: one stablelm-12b
    layer's seven projections at W1A3 p = 6 / 7 / 8 (R = 64 / 128 / 256),
    decode (N = 4) and prefill (N = 4 x 128).  The lookup kernel on the
    slices the canonicalize kernel composed (mode 3, held to the plain tiled
    compose) beside the CUDA-core kernel (lut_stream_gemm.cu) on the same inputs, both held
    to the plain version bit for bit (the lookup kernel also called
    LOOKUP_REPEATS times more back to back, each result held to the first:
    a race between its producer and consumers shows as a change), and the
    library yardstick (the one-hot [M, G*R] f32 torch.matmul) where its
    operand fits in memory.  Kernels and the yardstick in device time, the
    plain version on CUDA events."""
    from repro_torch.core import engine
    from repro_torch.core.api import LutLinearSpec, _lut_pack_cache, quantize_linear
    from repro_torch.core.prepared import prepare_linear
    from repro_torch.core.quantize import quantize
    from repro_torch.kernels import lut_stream_gemm as ss
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(18)
    onehot_cap = 16e9                       # bytes of the yardstick's one-hot operand, at most
    rows = []
    worst = 0
    for p in LOOKUP_PS:
        spec = LutLinearSpec(mode="lut", bw=1, ba=3, p=p)
        pack = _lut_pack_cache(spec.bw, spec.ba, spec.p, spec.w_kind, spec.a_kind)
        check(ss.route(pack) == "lookup", f"W1A3 p={p} must take the lookup route")
        canon, reorder = engine.device_tables(pack, dev)
        ct, rt = engine.device_byte_tables(pack, dev)
        r = pack.n_rows
        for name, (k, f) in layer_shapes(cfg).items():
            w = torch.randn((k, f), generator=gen, device=dev)
            wpk = prepare_linear(quantize_linear(w, spec), n_hint=4).wpk      # [F, G]
            del w
            m, g = wpk.shape
            n_copies = max(1, math.ceil(200e6 / (4 * wpk.numel())))      # cold in L2
            wpks = [wpk.clone() for _ in range(n_copies)]
            fits = 4.0 * m * g * r <= onehot_cap
            onehot = None
            if fits:
                onehot = torch.zeros((m, g, r), dtype=torch.float32, device=dev)
                onehot.scatter_(2, wpk[:, :, None].long(), 1.0)
                onehot = onehot.reshape(m, g * r)                            # [M, G*R]
            for b in (4, 4 * 128):
                x = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
                acodes, _ = quantize(x.float().T, spec.aspec())             # [K, N] view
                idx = engine.canonicalize_activations(acodes, pack)
                ms, pid, sl = idx.msrank, idx.permid, idx.composed
                nt = ss.lookup_tile(b)
                check(torch.equal(sl, ref.lut_compose_lookup_ref(ms, pid, ct, rt, nt=nt)),
                      f"lookup slices != plain tiled compose at p={p} {name} N={b}")
                before = ss.launches_lookup
                y = ss.lut_stream_gemm(wpk, ms, pid, canon, reorder, pack=pack, composed=sl)
                check(ss.launches_lookup == before + 1, f"p={p} {name} N={b} did not take the "
                                                        f"lookup route")
                for rep in range(LOOKUP_REPEATS):     # back to back: a race shows as a change
                    again = ss.lut_stream_gemm(wpk, ms, pid, canon, reorder, pack=pack,
                                               composed=sl)
                    check(torch.equal(again, y), f"lut_stream_gemm (lookup) at p={p} {name} "
                                                 f"N={b}: call {rep + 2} differs from the first")
                y_cc = ss.lut_stream_gemm(wpk, ms, pid, canon, reorder)
                if b == 4:
                    y_plain = ref.lut_stream_gemm_ref(wpk, ms, pid, canon, reorder)
                    plain = time_ms(torch, lambda i: ref.lut_stream_gemm_ref(
                        wpks[i % n_copies], ms, pid, canon, reorder), 2)
                else:   # one call, on CUDA events: it takes about a second
                    y_plain, plain = once_ms(torch, lambda: plain_stream_chunked(
                        torch, ref, wpk, ms, pid, canon, reorder))
                worst = max(worst, (y - y_plain).abs().max().item())
                if not torch.equal(y, y_plain):
                    again = ss.lut_stream_gemm(wpk, ms, pid, canon, reorder, pack=pack,
                                               composed=sl)
                    raise SmokeFailure(
                        f"lut_stream_gemm (lookup) != plain at p={p} {name} N={b}: "
                        f"{int((y != y_plain).sum())} of {y.numel()} entries differ; the kernel "
                        f"again {'==' if torch.equal(again, y_plain) else '!='} plain, "
                        f"{'==' if torch.equal(again, y) else '!='} its first result")
                check(torch.equal(y_cc, y_plain), f"lut_stream_gemm (cuda_core) != plain at "
                                                  f"p={p} {name} N={b}")
                kern = device_ms(torch, lambda i: ss.lut_stream_gemm(
                    wpks[i % n_copies], ms, pid, canon, reorder, pack=pack, composed=sl), 20)
                cuda_core = device_ms(torch, lambda i: ss.lut_stream_gemm(
                    wpks[i % n_copies], ms, pid, canon, reorder), 5 if b == 4 else 2)
                lib = None
                if fits:
                    # B [G*R, N]: the slices without their bias, in the one-hot's order.
                    bmat = (sl.to(torch.int16) - 128).permute(1, 2, 0, 3).reshape(g * r, -1)
                    bmat = bmat[:, :b].float().contiguous()
                    y_lib = torch.matmul(onehot, bmat)
                    check(torch.equal(y_lib.to(torch.int32), y),
                          f"one-hot BLAS yardstick != kernel at p={p} {name} N={b}")
                    lib = device_ms(torch, lambda i: torch.matmul(onehot, bmat), 3)
                    del bmat, y_lib
                canon_ms = device_ms(torch, lambda i: engine.canonicalize_activations(acodes, pack),
                                     10)
                bnd, by = stream_lookup_bound_s(m, g, b, r, card)
                cbnd, _ = canon_bound_s(k, b, g, r, card)
                row = dict(p=p, proj=name, B=b, K=k, F=f, G=g, ms=kern, cuda_core_ms=cuda_core,
                           plain_ms=plain, library_ms=lib, bound_ms=bnd * 1e3, bound_by=by,
                           split=ss.lookup_split(m, g, b, torch.cuda.get_device_properties(
                               dev).multi_processor_count), canon_ms=canon_ms,
                           canon_bound_ms=cbnd * 1e3)
                rows.append(row)
                log(f"  p={p} {name:6s} N={b:4d} M={m:5d} G={g:4d} S={row['split']}: lookup "
                    f"kernel {kern:.4f} ms ({bnd * 1e3 / kern:.3f} of its bound "
                    f"{bnd * 1e3:.4f} ms, {by}; {m * g * b / kern / 1e9:.2f} T lookup-adds/s), "
                    f"CUDA-core kernel {cuda_core:.4f} ms ({cuda_core / kern:.1f}x), plain "
                    f"{plain:.4f} ms, one-hot torch.matmul "
                    + (f"{lib:.4f} ms" if lib is not None else
                       f"not run ({4.0 * m * g * r / 1e9:.1f} GB operand > "
                       f"{onehot_cap / 1e9:.0f} GB)")
                    + f"; canonicalize + compose {canon_ms:.4f} ms (bytes bound "
                    f"{cbnd * 1e3:.4f} ms) [{smi}]")
                del idx, y, y_cc, y_plain
            del wpks, onehot
            torch.cuda.empty_cache()
    for p in LOOKUP_PS:
        for b in (4, 512):
            picked = [row for row in rows if row["B"] == b and row["p"] == p]
            t = {key: sum(row[key] for row in picked)
                 for key in ("ms", "cuda_core_ms", "plain_ms", "bound_ms", "canon_ms")}
            libs = [row["library_ms"] for row in picked if row["library_ms"] is not None]
            log(f"phase 6: {cfg.name} layer (7 projections) at W1A3 p={p} N={b}: lookup kernel "
                f"{t['ms']:.4f} ms ({t['bound_ms'] / t['ms']:.3f} of its bound "
                f"{t['bound_ms']:.4f} ms), CUDA-core kernel {t['cuda_core_ms']:.4f} ms "
                f"({t['cuda_core_ms'] / t['ms']:.1f}x), plain {t['plain_ms']:.4f} ms, one-hot "
                f"torch.matmul {sum(libs):.4f} ms over {len(libs)} of 7 projections; "
                f"canonicalize + compose {t['canon_ms']:.4f} ms [{smi}]")
    return rows, worst


def phase_lut_layer(torch, dev, cfg):
    """One full-width stablelm-12b layer at W1A3 p=4, bf16 x [4, K], on the
    card: lut raw == lut prepared == stream raw == stream prepared, bit for
    bit, every one through the kernel; and the card == the CPU's plain
    version on wk."""
    import dataclasses as dc

    from repro_torch.core.api import LutLinearSpec, apply_linear, quantize_linear
    from repro_torch.core.prepared import prepare_linear
    from repro_torch.kernels import lut_stream_gemm as ss

    gen = torch.Generator(device=dev).manual_seed(6)
    for name, (k, f) in layer_shapes(cfg).items():
        w = torch.randn((k, f), generator=gen, device=dev)
        x = torch.randn((4, k), generator=gen, device=dev).to(torch.bfloat16)
        q_lut = quantize_linear(w, LutLinearSpec(mode="lut", **LUT_SPEC))
        q_str = dc.replace(q_lut, spec=LutLinearSpec(mode="stream", **LUT_SPEC))
        del w
        before = (ss.launches, ss.launches_tc, ss.launches_canon)
        ys = [apply_linear(q, x) for q in (q_lut, prepare_linear(q_lut, n_hint=4),
                                           q_str, prepare_linear(q_str, n_hint=4))]
        got = (ss.launches - before[0], ss.launches_tc - before[1],
               ss.launches_canon - before[2])
        check(got == (4, 4, 4), f"{name}: (GEMM, on the tensor cores, canonicalize) launches "
                                f"{got}, want (4, 4, 4)")
        check(all(torch.equal(y, ys[0]) for y in ys[1:]),
              f"{name}: lut raw / lut prepared / stream raw / stream prepared differ")
        check(ys[0].dtype == torch.bfloat16 and bool(torch.isfinite(ys[0]).all()),
              f"{name}: output not finite bf16")
        if name == "wk":
            q_cpu = dc.replace(q_lut, codes=q_lut.codes.cpu(), scale=q_lut.scale.cpu())
            y_cpu = apply_linear(q_cpu, x.cpu())
            check(torch.equal(y_cpu, ys[0].cpu()), "wk: card != CPU plain version")
    torch.cuda.synchronize()
    log("phase 7: one full-width layer, W1A3 p=4, bf16 x [4, K]: lut raw == lut prepared == "
        "stream raw == stream prepared bit for bit on the card for all 7 projections "
        "(4 canonicalize and 4 tensor-core GEMM launches each); wk on the card == the CPU's "
        "plain version")


# ---------------------------------------------------------------------------
# Phases 3 and 8: full-width serve (pallas W4A4; the paper's int-LUT mode)
# ---------------------------------------------------------------------------


def earlier_lut_path(fn):
    """``fn()`` with the int-LUT path as it was before the tensor-core
    redesign: every pack routed to the CUDA-core lut_stream_gemm and the
    canonicalization as the plain torch chain (a check of this script; the
    port has no such switch)."""
    from repro_torch.core import engine
    from repro_torch.kernels import lut_stream_gemm as ss

    route, canonicalize = ss.route, engine.canonicalize_activations
    ss.route = lambda pack: "cuda_core"
    engine.canonicalize_activations = engine.canonicalize_activations_plain
    try:
        return fn()
    finally:
        ss.route, engine.canonicalize_activations = route, canonicalize


def counted_generate(torch, eng, reqs):
    """``eng.generate(reqs)`` with every launch count set to 0 just before and
    read just after, each wave recorded (``on_wave``) and every synchronizing
    call caught (``set_sync_debug_mode``); returns ``(outs, wall seconds,
    wave records, launch counts, sync warnings)``."""
    records = []
    eng.on_wave = records.append
    eng.host_syncs = 0
    reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            outs = eng.generate(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counts = read_launches()
    sync_warnings = [str(w.message) for w in caught
                     if "called a synchronizing CUDA operation" in str(w.message)]
    return outs, wall, records, counts, sync_warnings


def check_served(cfg, eng, outs, max_new, records, counts, sync_warnings, *, kernel, what):
    """The checks every continuous-batching serve phase makes: ``max_new``
    tokens a request, within the vocabulary; one host sync per wave and no
    other synchronizing call; ``kernel`` launched (the applied projections
    per forward, counted from the engine's tree by
    :func:`applied_projections`) x (prefills + decode steps) times, on the
    tensor cores where it is lut_dequant_gemm, and no other kernel.  Returns
    (prefills, decode steps, launches)."""
    check(all(len(o) == max_new for o in outs),
          f"{what}: token counts {[len(o) for o in outs]} != {max_new} each")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
          f"{what}: token outside [0, vocab)")
    check(eng.host_syncs == len(records),
          f"{what}: host_syncs {eng.host_syncs} != waves {len(records)}")
    check(len(sync_warnings) == eng.host_syncs,
          f"{what}: {len(sync_warnings)} synchronizing calls in the serve loop, expected only "
          f"the {eng.host_syncs} token fetches: {sorted(set(sync_warnings))[:3]}")
    prefills = sum(1 for r in records if r.admitted)
    steps = sum(r.steps for r in records)
    launches = counts[kernel]
    per, _ = applied_projections(eng.params)
    want = per * (prefills + steps)
    check(launches == want, f"{what}: {kernel} launches {launches} != {per} x "
                            f"({prefills} prefills + {steps} decode steps) = {want}")
    check(all(n == 0 for name, n in counts.items() if not name.startswith(kernel)),
          f"{what}: the path launched another kernel: {counts}")
    if kernel == "lut_dequant_gemm":
        check(counts["lut_dequant_gemm_tc"] == launches,
              f"{what}: lut_dequant_gemm launches on the tensor cores "
              f"{counts['lut_dequant_gemm_tc']} != {launches}: the bf16 serve path must take "
              f"the tensor-core route")
    return prefills, steps, launches


def serve_requests(cfg, max_prompt, max_new, min_prompt=16):
    """The 8 requests a serve phase sends: prompt lengths in [min_prompt,
    max_prompt] and tokens from ``default_rng(0)``, ``max_new`` new tokens
    each."""
    from repro_torch.serve.serving import Request
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(min_prompt, max_prompt + 1, 8)
    return lens, [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                          max_new_tokens=max_new) for n in lens]


def phase_serve(torch, dev, cfg, smi, *, phase, spec, kernel, max_prompt, max_new, min_prompt=16,
                n_layers=N_LAYERS, max_seq=256, timing=(128, 128), chunked=False,
                calibrate=False, iters=(3, 10)):
    """Serve 8 requests (:func:`serve_requests`) through
    ``ServeEngine(batch=4, max_seq=max_seq, decode="scan")`` with every
    launch count set to 0 just before and read just after
    (:func:`check_served`); the KV cache's bytes against the count from the
    shapes; with ``chunked`` the same tokens under ``decode="chunked"``; then
    the steady-state times of a prefill of 4 x ``timing[0]`` tokens (at least
    every prefill the serve made) and of a decode step at position
    ``timing[1]``, and the profiler's breakdown.  ``n_layers`` cuts the depth
    (None: the model's own).  ``calibrate`` freezes the activation scales on
    a 2 x 16 token batch from ``default_rng(0)`` before preparing (the
    int-LUT path)."""
    from repro_torch import tree
    from repro_torch.models.model import build_model
    from repro_torch.serve.serving import Request, ServeEngine
    from repro_torch.tune.plan import quantized_leaf_items
    import numpy as np

    if n_layers is not None and cfg.n_layers != n_layers:
        log(f"phase {phase}: depth cut from {cfg.n_layers} to {n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_quantized(spec, seed=0, device=dev)
    what = f"W{spec.bw}A{spec.ba}{f' p={spec.p}' if spec.p else ''} {spec.mode}"
    if calibrate:
        cal = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        params = model.prepare(params, calibrate=cal, n_hint=4)
        leaves = quantized_leaf_items(params)
        check(len(leaves) == 7 and all(lf.ascale is not None
                                       and lf.ascale.shape == (cfg.n_layers,)
                                       and lf.wpk is not None for _p, lf in leaves),
              f"lut tree: every projection needs a frozen [{cfg.n_layers}] ascale and wpk")
        scales = torch.stack([lf.ascale for _p, lf in leaves])
        check(bool(torch.isfinite(scales).all() and (scales > 0).all()), "calibrated scales")
        what += (f", calibrated on {cal.size} tokens (frozen scales "
                 f"{scales.min().item():.4g}..{scales.max().item():.4g}; "
                 f"{sum(lf.wcanon is not None for _p, lf in leaves)} of 7 projections carry "
                 f"a wcanon table)")
    else:
        params = model.prepare(params, n_hint=4)
    torch.cuda.synchronize()
    log(f"phase {phase}: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"hd={cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab_size} layers={cfg.n_layers}, "
        f"{what}, prepared in {time.perf_counter()-t0:.1f}s; "
        f"{torch.cuda.memory_allocated(dev)/1e9:.2f} GB on the card; ring_window_cache "
        f"{cfg.ring_window_cache}, kv_cache_int8 {cfg.kv_cache_int8}, attend_bf16 "
        f"{cfg.attend_bf16}")
    eng = ServeEngine(model, params, batch=4, max_seq=max_seq, decode="scan", device=dev)
    held = torch.cuda.memory_allocated(dev)
    caches = eng._new_cache()
    cache_alloc = torch.cuda.memory_allocated(dev) - held
    sizes = []
    tree.tree_map(lambda t: sizes.append(t.numel() * t.element_size()), caches)
    cache_bytes = kv_cache_bytes(cfg, 4, max_seq)
    check(sum(sizes) == cache_bytes == cache_alloc,
          f"phase {phase}: KV cache {sum(sizes)} B in its tensors, {cache_alloc} B allocated, "
          f"{cache_bytes} B from the shapes")
    del caches
    lens, reqs = serve_requests(cfg, max_prompt, max_new, min_prompt)
    eng.generate([Request(prompt=reqs[0].prompt[:16], max_new_tokens=2)])   # warmup
    torch.cuda.synchronize()

    outs, wall, records, counts, sync_warnings = counted_generate(torch, eng, reqs)
    prefills, steps, launches = check_served(cfg, eng, outs, max_new, records, counts,
                                             sync_warnings, kernel=kernel, what=f"phase {phase}")
    buckets = sorted({r.prefill_bucket for r in records if r.prefill_bucket is not None})
    check(max(buckets) <= timing[0],
          f"phase {phase}: prefill buckets {buckets}, the timed prefill {timing[0]}")
    if kernel == "lut_stream_gemm":
        check(counts["lut_stream_gemm_tc"] == launches,
              f"lut_stream_gemm launches on the tensor cores {counts['lut_stream_gemm_tc']} != "
              f"{launches}: the W1A3 p=4 pack must take the tensor-core route")
        check(counts["lut_stream_gemm_canon"] == launches,
              f"canonicalize launches {counts['lut_stream_gemm_canon']} != 7 x {cfg.n_layers} x "
              f"({prefills} prefills + {steps} decode steps) = {launches}: one per projection, "
              f"the composed operand not built twice")
    digest = zlib.crc32(json.dumps([list(map(int, o)) for o in outs]).encode())
    n_tok = sum(len(o) for o in outs)
    out = dict(launches=launches, launches_tc=counts.get(f"{kernel}_tc"),
               launches_canon=counts.get(f"{kernel}_canon"), prefills=prefills,
               decode_steps=steps, host_syncs=eng.host_syncs, waves=len(records), wall_s=wall,
               tokens=n_tok, tok_s=n_tok / wall, tokens_crc32=digest, cache_bytes=cache_bytes,
               prefill_wall_s=sum(r.t_decode - r.t_start for r in records),
               decode_wall_s=sum(r.t_sync - r.t_decode for r in records), outs=outs)
    log(f"phase {phase} [{smi}]: served {len(reqs)} requests (prompt lengths {lens.tolist()}, "
        f"prefill buckets {buckets}), {n_tok} tokens in {wall:.3f} s ({out['tok_s']:.1f} tok/s "
        f"end to end; prefill {out['prefill_wall_s']:.3f} s + decode {out['decode_wall_s']:.3f} "
        f"s wall); {len(records)} waves, {prefills} prefills, {steps} decode steps, "
        f"{eng.host_syncs} host syncs, {launches} {kernel} launches "
        f"(= 7 x {cfg.n_layers} x {prefills + steps}; counts {counts}); sync-debug warnings "
        f"{len(sync_warnings)} (all token fetches); admissions {eng.admissions}; KV cache "
        f"{cache_bytes:,} B (= the count from the shapes, allocated); tokens crc32 {digest:08x}")
    if chunked:
        eng_c = ServeEngine(model, params, batch=4, max_seq=max_seq, decode="chunked", device=dev)
        t0 = time.perf_counter()
        check(eng_c.generate(reqs) == outs,
              f"phase {phase}: decode='chunked' tokens differ from decode='scan'")
        check(eng_c.host_syncs == -(-len(reqs) // 4),
              f"phase {phase}: chunked host syncs {eng_c.host_syncs}, want one per chunk")
        log(f"phase {phase}: decode='chunked' gives the same tokens ({eng_c.host_syncs} host "
            f"syncs, {time.perf_counter() - t0:.2f} s)")
        del eng_c
    if kernel == "lut_stream_gemm":
        # The same requests on the path as it was before the redesign (the torch
        # chain's canonicalization, the CUDA-core kernel): the same tokens.
        t0 = time.perf_counter()
        earlier = earlier_lut_path(lambda: eng.generate(reqs))
        check(earlier == outs, "lut tokens differ from the earlier path's (torch-chain "
                               "canonicalization + CUDA-core lut_stream_gemm)")
        log(f"phase {phase}: tokens (crc32 {digest:08x}) equal the earlier path's (torch-chain "
            f"canonicalization, CUDA-core lut_stream_gemm; {time.perf_counter() - t0:.1f} s)")

    # Steady-state times, outside the counted run.
    caches = eng._new_cache()
    toks = torch.randint(0, cfg.vocab_size, (4, timing[0]), device=dev, dtype=torch.int32)
    pad = torch.zeros((4,), dtype=torch.int32, device=dev)
    tok, pos = toks[:, -1:], torch.full((4,), timing[1], dtype=torch.int32, device=dev)
    prefill = lambda: model.prefill(params, toks, caches, pad_len=pad)
    step = lambda: model.decode_step(params, tok, caches, pos, pad_len=pad)
    out["prefill_ms"] = time_ms(torch, lambda i: prefill(), iters[0])
    out["step_ms"] = time_ms(torch, lambda i: step(), iters[1])
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"phase {phase} [{smi}]: prefill B=4 x {timing[0]} tokens {out['prefill_ms']:.2f} ms; "
        f"decode step B=4 at {timing[1]} {out['step_ms']:.2f} ms "
        f"({4e3 / out['step_ms']:.1f} tok/s); peak memory {out['peak_gb']:.2f} GB")
    log(f"phase {phase}: where the device time goes (torch.profiler; wall time from the "
        "unprofiled runs above):")
    out["prefill_profile"] = log_breakdown(
        f"prefill B=4 x {timing[0]}", device_time_by_kernel(torch, prefill, max(1, iters[0] - 1)),
        out["prefill_ms"], kernel=kernel, card=smi)
    out["decode_profile"] = dec = log_breakdown(
        f"decode step B=4 at {timing[1]}", device_time_by_kernel(torch, step, iters[1] // 2),
        out["step_ms"], kernel=kernel, card=smi)
    if dec is not None:
        log(f"phase {phase} [{smi}]: decode step: {dec['launches']:.0f} kernel launches "
            f"({dec['launches'] / (7 * cfg.n_layers):.1f} per projection), idle share "
            f"{dec['idle_share']:.3f}")
    del eng, params, caches
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 13: planned serving (the capacity-budgeted autotuner, repro_torch.tune)
# ---------------------------------------------------------------------------

# The analytic plans of stablelm-12b's seven stacked W1A3 lut projections at
# n_hint 4 over LIVE_LAYERS = 10 units (the reference planner's; at 40 units the
# same choices come at 16 and 4 GiB, tests/test_torch_tune.py): budget GiB ->
# ({projection: (p, prepared)}, total_bytes, table_bytes).  At p <= 5 a pack
# takes lut_stream_gemm's tensor-core route (R <= 32), at p = 6-8 its lookup
# route (R = 64-256); w_down at 1 GiB is served raw at p = 1 (R = 2, the
# tensor cores).  Phase 13 plans LIVE_LAYERS units, not 40: planning, preparing
# and serving scale with the depth, and each check holds at any depth.
PLANS_WANT = {
    16: ({"wq": (5, True), "wk": (5, True), "wv": (5, True), "wo": (5, True),
          "w_down": (5, True), "w_up": (7, True), "w_gate": (7, True)}, 1_901_207_040, 1_113_600),
    1: ({"wq": (8, True), "wk": (5, True), "wv": (7, True), "wo": (8, True),
         "w_up": (8, True), "w_gate": (8, True), "w_down": (1, False)}, 1_072_922_898, 13_082_898),
}


# Projections a unit puts on lut_stream_gemm's (tensor-core, lookup, CUDA-core)
# routes under each plan: the launches of a serve are these x units x calls.
ROUTES_WANT = {16: (5, 2, 0), 1: (2, 5, 0)}


def check_plan_choices(plan, what):
    """A 16 GiB analytic plan over stablelm-12b at a cut depth: each
    projection's (p, prepared) is phase 13's (the same at 10 and 40 layers;
    the bytes scale with the depth, and ``verify_capacity`` checks them on
    the prepared tree)."""
    check({p.rsplit("/", 1)[-1]: (lp.p, lp.prepared) for p, lp in plan.layers.items()}
          == PLANS_WANT[16][0], f"{what}: the 16 GiB analytic plan's choices differ from "
                                f"phase 13's")


def check_route_counts(what, out, per_unit, n_units):
    """lut_stream_gemm's launches by route in one planned serve: ``per_unit``
    (a unit's projections on each route) x units x (prefills + decode steps)."""
    calls = n_units * (out["prefills"] + out["decode_steps"])
    want = tuple(n * calls for n in per_unit)
    got = (out["launches_tc"], out["launches_lookup"], out["launches_cuda_core"])
    check(got == want, f"{what}: lut_stream_gemm launches (tensor cores, lookup, CUDA cores) "
                       f"{got} != {want}")


def plan_routes(plan):
    """``{path: route}``: the lut_stream_gemm route of each leaf's LUT pack
    at the plan's p (``kernels/lut_stream_gemm.py::route``)."""
    from repro_torch.core.api import _lut_pack_cache
    from repro_torch.kernels import lut_stream_gemm as ss

    return {path: ss.route(_lut_pack_cache(LUT_SPEC["bw"], LUT_SPEC["ba"], lp.p, "int", "int"))
            for path, lp in plan.layers.items()}


def applied_routes(params, plan):
    """``{route: applied projections a forward}``: each projection a
    ``ServeEngine`` forward applies (:func:`applied_projections`: the shared
    block per application; no expert stack, no ``W_kup`` / ``W_vup``, no
    encoder leaf and no cross ``wk`` / ``wv``) on its leaf's
    ``lut_stream_gemm`` route at the plan's p."""
    routes = plan_routes(plan)
    out = {"tc": 0, "lookup": 0, "cuda_core": 0}
    for path, (n, _k, _f) in applied_projections(params)[1].items():
        out[routes[path]] += n
    return out


def log_plan(what, plan, routes):
    log(f"phase 13: {what}: {plan.total_bytes:,} B of a {plan.budget_bytes:,} B budget "
        f"({plan.table_bytes:,} B shared tables), meta {plan.meta}")
    for path, lp in sorted(plan.layers.items()):
        t = f"measured {lp.measured_us:.1f} us, " if lp.measured_us is not None else ""
        log(f"    {path.rsplit('/', 1)[-1]:<7} p={lp.p} prepared={int(lp.prepared)} "
            f"route={routes[path]:<9} x{lp.stack} {lp.capacity_bytes:>13,} B  {t}"
            f"est {lp.est_us:.1f} us (UPMEM)")


def chunk_calls(reqs, batch, max_seq):
    """(prefills, decode steps) of the chunked driver on ``reqs``."""
    from repro_torch.serve.serving import bucket_to

    prefills = steps = 0
    for start in range(0, len(reqs), batch):
        chunk = reqs[start : start + batch]
        plen = max(len(r.prompt) for r in chunk)
        max_new = max(r.max_new_tokens for r in chunk)
        length = bucket_to(max_new, 2)
        if plen + length > max_seq:
            length = max_new
        prefills, steps = prefills + 1, steps + length - 1
    return prefills, steps


def counted_plan_serve(torch, eng, plan, reqs, want, *, what):
    """``reqs`` served by ``eng`` (a ``ServeEngine`` built with ``plan=plan``),
    every launch count set to 0 just before the counted run and read just
    after: the tokens must equal ``want``, the applied tree the plan's bytes
    (``verify_capacity``), one host sync per wave (or chunk) and no other
    synchronizing call, and every lut_stream_gemm launch the route of its
    leaf's pack: each projection a forward applies (:func:`applied_routes`)
    x (prefills + decode steps), counted per route (tensor cores, lookup,
    CUDA cores), with one ``lut_canon`` launch a projection and no other
    kernel.  Returns the counts, the records and the wall time."""
    from repro_torch.serve.serving import Request
    from repro_torch.tune import verify_capacity

    actual = verify_capacity(eng.params, plan)
    eng.generate([Request(prompt=reqs[0].prompt[:16], max_new_tokens=2)])   # warmup
    torch.cuda.synchronize()
    outs, wall, records, counts, sync_warnings = counted_generate(torch, eng, reqs)
    digest = zlib.crc32(json.dumps([list(map(int, o)) for o in outs]).encode())
    check(outs == want, f"{what}: tokens (crc32 {digest:08x}) differ from the unplanned serve's")
    if eng.decode == "scan":
        check(eng.host_syncs == len(records), f"{what}: host_syncs {eng.host_syncs} != "
                                              f"waves {len(records)}")
        prefills = sum(1 for r in records if r.admitted)
        steps = sum(r.steps for r in records)
    else:
        prefills, steps = chunk_calls(reqs, eng.batch, eng.max_seq)
        check(eng.host_syncs == prefills, f"{what}: host_syncs {eng.host_syncs} != "
                                          f"chunks {prefills}")
    check(len(sync_warnings) == eng.host_syncs,
          f"{what}: {len(sync_warnings)} synchronizing calls in the serve loop, expected only "
          f"the {eng.host_syncs} token fetches: {sorted(set(sync_warnings))[:3]}")
    per = applied_routes(eng.params, plan)
    n_proj = sum(per.values())
    calls = prefills + steps
    want_counts = {"lut_stream_gemm": n_proj * calls, "lut_stream_gemm_tc": per["tc"] * calls,
                   "lut_stream_gemm_lookup": per["lookup"] * calls,
                   "lut_stream_gemm_canon": n_proj * calls}
    got_counts = {k: counts[k] for k in want_counts}
    check(got_counts == want_counts,
          f"{what}: launches {got_counts} != {want_counts} (applied projections a forward by "
          f"route {per} x ({prefills} prefills + {steps} decode steps))")
    check(all(n == 0 for name, n in counts.items() if not name.startswith("lut_stream_gemm")),
          f"{what}: the lut path launched another kernel: {counts}")
    n_tok = sum(len(o) for o in outs)
    out = dict(tokens=n_tok, wall_s=wall, tok_s=n_tok / wall, tokens_crc32=digest,
               prefills=prefills,
               decode_steps=steps, host_syncs=eng.host_syncs, per_forward=per,
               launches=counts["lut_stream_gemm"], launches_tc=counts["lut_stream_gemm_tc"],
               launches_lookup=counts["lut_stream_gemm_lookup"],
               launches_cuda_core=counts["lut_stream_gemm"] - counts["lut_stream_gemm_tc"]
               - counts["lut_stream_gemm_lookup"],
               launches_canon=counts["lut_stream_gemm_canon"],
               prepared_bytes=sum(actual.values()))
    return out, records


def serve_plan(torch, dev, model, tree, plan, reqs, want, smi, *, what, decode="scan"):
    """Serve ``reqs`` through ``ServeEngine(tree, plan=plan, decode=decode)``
    (batch 4, max_seq 256), counted and checked by
    :func:`counted_plan_serve`.  Under ``decode="scan"`` also a 4 x 128
    prefill's and a decode step's times (CUDA events) and the profiler's
    device time by kernel, lut_stream_gemm's routes apart."""
    from repro_torch.serve.serving import ServeEngine

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    eng = ServeEngine(model, tree, batch=4, max_seq=256, decode=decode, plan=plan, device=dev)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    out, records = counted_plan_serve(torch, eng, plan, reqs, want, what=what)
    peak = torch.cuda.max_memory_allocated(dev)
    out.update(prepare_s=prepare_s, peak_gb=peak / 1e9, held_before_gb=held / 1e9,
               p={path.rsplit("/", 1)[-1]: lp.p for path, lp in plan.layers.items()})
    if decode == "scan":
        out["prefill_wall_s"] = sum(r.t_decode - r.t_start for r in records)
        out["decode_wall_s"] = sum(r.t_sync - r.t_decode for r in records)
        # Steady-state times and the device's share, outside the counted run.
        params = eng.params
        caches = eng._new_cache()
        toks = torch.randint(0, model.cfg.vocab_size, (4, 128), device=dev, dtype=torch.int32)
        pad = torch.zeros((4,), dtype=torch.int32, device=dev)
        tok, pos = toks[:, -1:], torch.full((4,), 128, dtype=torch.int32, device=dev)
        prefill = lambda: model.prefill(params, toks, caches, pad_len=pad)
        step = lambda: model.decode_step(params, tok, caches, pos, pad_len=pad)
        out["prefill_ms"] = time_ms(torch, lambda i: prefill(), 2)
        out["step_ms"] = time_ms(torch, lambda i: step(), 5)
        out["prefill_profile"] = log_breakdown(
            f"{what}: prefill B=4 x 128", device_time_by_kernel(torch, prefill, 1),
            out["prefill_ms"], kernel="lut_stream_gemm", card=smi)
        out["decode_profile"] = log_breakdown(
            f"{what}: decode step B=4", device_time_by_kernel(torch, step, 2),
            out["step_ms"], kernel="lut_stream_gemm", card=smi)
        del caches
    log(f"phase 13: {what}: tokens (crc32 {out['tokens_crc32']:08x}) equal the unplanned serve's; "
        f"{out['tokens']} tokens in {out['wall_s']:.3f} s ({out['tok_s']:.1f} tok/s end to end, "
        f"prefill included"
        + (f"; prefill {out['prefill_wall_s']:.3f} s + decode {out['decode_wall_s']:.3f} s "
           f"wall over {len(records)} waves" if decode == "scan" else "")
        + f"); {eng.host_syncs} host syncs; lut_stream_gemm {out['launches']} launches "
        f"({out['launches_tc']} tensor cores, {out['launches_lookup']} lookup, "
        f"{out['launches_cuda_core']} CUDA cores), "
        f"lut_canon {out['launches_canon']}; prepared in {prepare_s:.1f} s, "
        f"{out['prepared_bytes']:,} B checked by verify_capacity; peak memory "
        f"{out['peak_gb']:.2f} GB ({held / 1e9:.2f} GB held before the engine was built)")
    del eng
    torch.cuda.empty_cache()
    return out


def phase_planned_serve(torch, dev, cfg, smi):
    """Phase 13: stablelm-12b at full width (LIVE_LAYERS = 10 of its 40
    layers: planning, preparing and serving scale with the depth, and the
    script must stay in its time limit; seed 0, bf16, W1A3 lut), calibrated
    on phase 8's 2 x 16 batch, served through ``ServeEngine(plan=)`` on phase
    8's 8 requests: the analytic plans at 16 and 1 GiB (1 GiB at 10 layers
    is 4 GiB at 40: both plans put projections on two routes), a plan
    measured on the card at 16 GiB, and the 16 GiB plan under
    ``decode="chunked"``; every serve's tokens equal those of the same tree
    served without a plan (each leaf prepared at p = 4)."""
    import numpy as np

    from repro_torch.core import LutLinearSpec
    from repro_torch.core.calibrate import calibrate_tree
    from repro_torch.models.model import build_model, prepare_params
    from repro_torch.serve.serving import ServeEngine
    from repro_torch.tune import Measurer, plan_model, space
    from repro_torch.tune.measure import measure_key
    from repro_torch.tune.plan import quantized_leaf_items

    cfg = dataclasses.replace(cfg, n_layers=LIVE_LAYERS)
    model = build_model(cfg)
    spec = LutLinearSpec(mode="lut", **LUT_SPEC)
    t0 = time.perf_counter()
    raw = model.init_quantized(spec, seed=0, device=dev)
    cal = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    tokens = torch.as_tensor(cal, device=dev)
    calibrated = calibrate_tree(lambda probed: model.forward(probed, tokens)[0], raw)
    torch.cuda.synchronize()
    log(f"phase 13 [{smi}]: {cfg.name} {cfg.n_layers} layers, W1A3 lut raw tree built and "
        f"calibrated on {cal.size} tokens in {time.perf_counter() - t0:.1f} s")
    _lens, reqs = serve_requests(cfg, 64, 16)
    t0 = time.perf_counter()
    eng = ServeEngine(model, prepare_params(calibrated, n_hint=4), batch=4, max_seq=256,
                      decode="scan", device=dev)
    want = eng.generate(reqs)
    del eng
    log(f"phase 13: the unplanned serve (every leaf prepared at p = 4) in "
        f"{time.perf_counter() - t0:.1f} s: tokens crc32 "
        f"{zlib.crc32(json.dumps([list(map(int, o)) for o in want]).encode()):08x}")
    results = {}
    plans = {}
    for gib, (layers_want, total_want, tables_want) in PLANS_WANT.items():
        t0 = time.perf_counter()
        plan = plan_model(raw, lut_budget_bytes=gib << 30, n_hint=4, measure=False)
        plan_s = time.perf_counter() - t0
        got = {path.rsplit("/", 1)[-1]: (lp.p, lp.prepared) for path, lp in plan.layers.items()}
        check(got == layers_want and (plan.total_bytes, plan.table_bytes) == (total_want, tables_want),
              f"{gib} GiB analytic plan {got}, {plan.total_bytes} / {plan.table_bytes} B, want "
              f"{layers_want}, {total_want} / {tables_want} B")
        routes = plan_routes(plan)
        log_plan(f"analytic plan at {gib} GiB (planned in {plan_s:.2f} s)", plan, routes)
        check(set(routes.values()) == {"tc", "lookup"},
              f"the {gib} GiB plan must put lut_stream_gemm on the tensor-core and lookup "
              f"routes and on no other: {routes}")
        results[f"analytic_{gib}GiB"] = dict(planning_s=plan_s, total_bytes=plan.total_bytes,
                                             table_bytes=plan.table_bytes,
                                             **serve_plan(torch, dev, model, calibrated, plan, reqs,
                                                          want, smi, what=f"{gib} GiB analytic plan"))
        check_route_counts(f"{gib} GiB analytic plan", results[f"analytic_{gib}GiB"],
                           ROUTES_WANT[gib], cfg.n_layers)
        plans[gib] = plan

    # A plan measured on the card: each candidate's eager apply_linear on
    # the stack's first unit, x [128, K] f32 (measure.py: CUDA events).
    meas = Measurer(cache={})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mplan = plan_model(raw, lut_budget_bytes=16 << 30, n_hint=4, measure=True, measurer=meas)
    torch.cuda.synchronize()
    mplan_s = time.perf_counter() - t0
    mroutes = plan_routes(mplan)
    log_plan(f"measured plan at 16 GiB (planned in {mplan_s:.1f} s, {meas.misses} candidates "
             f"measured)", mplan, mroutes)
    agree = {path.rsplit("/", 1)[-1]: (plans[16].layers[path].p, lp.p)
             for path, lp in mplan.layers.items()}
    log(f"phase 13: (analytic p, measured p) per projection at 16 GiB: {agree}")
    table_leaf = next(path for path, _ in quantized_leaf_items(raw) if path.endswith("w_up"))
    q = dict(quantized_leaf_items(raw))[table_leaf]
    f, k = int(q.codes.shape[-2]), q.k
    log(f"phase 13: candidates of {table_leaf} (F={f}, K={k}, x{cfg.n_layers}), measured at N=128 "
        f"[{smi}]:")
    table = []
    for c in space.layer_candidates(f, k, n_hint=4, base_spec=q.spec, stack=cfg.n_layers,
                                    servable_only=True):
        us = meas.cache[measure_key(f, k, 128, q.spec, c)]
        table.append(dict(p=c.p, prepared=c.prepared, wcanon=c.wcanon,
                          capacity_bytes=c.capacity_bytes, table_bytes=c.table_bytes,
                          est_us=c.est_us, measured_us=us))
        log(f"    p={c.p} prepared={int(c.prepared)} wcanon={int(c.wcanon)} "
            f"{c.capacity_bytes:>13,} B + {c.table_bytes:>10,} B tables: measured {us:9.1f} us, "
            f"est {c.est_us:10.1f} us (UPMEM)")
    results["measured_16GiB"] = dict(planning_s=mplan_s, candidates_measured=meas.misses,
                                     total_bytes=mplan.total_bytes,
                                     table_bytes=mplan.table_bytes,
                                     analytic_vs_measured_p=agree,
                                     measured_us={path.rsplit("/", 1)[-1]: lp.measured_us
                                                  for path, lp in mplan.layers.items()},
                                     est_us={path.rsplit("/", 1)[-1]: lp.est_us
                                             for path, lp in mplan.layers.items()},
                                     candidates=dict(leaf=table_leaf, rows=table),
                                     **serve_plan(torch, dev, model, calibrated, mplan, reqs, want,
                                                  smi, what="16 GiB measured plan"))
    results["chunked_16GiB"] = serve_plan(torch, dev, model, calibrated, plans[16], reqs, want,
                                          smi, what="16 GiB analytic plan, decode=chunked",
                                          decode="chunked")
    check_route_counts("16 GiB analytic plan, decode=chunked", results["chunked_16GiB"],
                       ROUTES_WANT[16], cfg.n_layers)
    log(f"phase 13 [{smi}]: 16 GiB plan end to end: chunked "
        f"{results['chunked_16GiB']['tok_s']:.1f} tok/s, scan "
        f"{results['analytic_16GiB']['tok_s']:.1f} tok/s (tokens equal)")
    del raw, calibrated
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phases 4-5: card vs CPU, scan vs loop on a 2-layer f32 full-width model
# ---------------------------------------------------------------------------


def phase_cpu_and_loop(torch, dev, cfg):
    from repro_torch import tree
    from repro_torch.core import LutLinearSpec
    from repro_torch.models.model import build_model
    from repro_torch.serve.serving import Request, ServeEngine
    import numpy as np

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    model = build_model(cfg2)
    params = model.prepare(
        model.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"), seed=3, device=dev),
        n_hint=4)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg2.vocab_size, (2, 16)).astype(np.int32)
    lg_gpu, _ = model.prefill(params, torch.from_numpy(toks).to(dev),
                              model.init_cache(2, 32, torch.float32, device=dev))
    lg_gpu = lg_gpu.cpu()
    params_cpu = tree.tree_map(lambda t: t.cpu(), params)
    lg_cpu, _ = model.prefill(params_cpu, torch.from_numpy(toks),
                              model.init_cache(2, 32, torch.float32, device="cpu"))
    del params_cpu
    scale = lg_cpu.abs().max().item()
    err = (lg_gpu - lg_cpu).abs().max().item()
    check(err <= TOL_CPU * scale, f"card vs CPU logits: max err {err:.3e} > "
                                  f"{TOL_CPU} x max|logit| {scale:.3e}")
    check(torch.equal(lg_gpu.argmax(-1), lg_cpu.argmax(-1)), "card vs CPU argmax differs")
    log(f"phase 4: 2-layer f32 full-width prefill, card (kernel) vs CPU (plain version): "
        f"max err {err:.3e} = {err/scale:.3e} x max|logit|, argmax equal")

    # The same for the int-LUT path: calibrated on the card, the prepared
    # tree copied to the CPU, one short prefill on both (the CPU's plain
    # gather materialises [M, G, N], so N stays small).
    lut = build_model(cfg2)
    lrng = np.random.default_rng(8)
    cal = lrng.integers(0, cfg2.vocab_size, (2, 8)).astype(np.int32)
    lp = lut.prepare(lut.init_quantized(LutLinearSpec(mode="lut", **LUT_SPEC), seed=3,
                                        device=dev), calibrate=cal, n_hint=4)
    ltoks = lrng.integers(0, cfg2.vocab_size, (1, 4)).astype(np.int32)
    ll_gpu, _ = lut.prefill(lp, torch.from_numpy(ltoks).to(dev),
                            lut.init_cache(1, 8, torch.float32, device=dev))
    ll_gpu = ll_gpu.cpu()
    lp_cpu = tree.tree_map(lambda t: t.cpu(), lp)
    del lp
    ll_cpu, _ = lut.prefill(lp_cpu, torch.from_numpy(ltoks),
                            lut.init_cache(1, 8, torch.float32, device="cpu"))
    del lp_cpu
    lscale = ll_cpu.abs().max().item()
    lerr = (ll_gpu - ll_cpu).abs().max().item()
    check(bool(torch.isfinite(ll_gpu).all()) and ll_gpu.shape == (1, 1, cfg2.vocab_size),
          f"lut logits: shape {tuple(ll_gpu.shape)} or not finite")
    check(lerr <= TOL_CPU_LUT * lscale, f"lut card vs CPU logits: max err {lerr:.3e} > "
                                        f"{TOL_CPU_LUT} x max|logit| {lscale:.3e}")
    log(f"phase 4: 2-layer f32 full-width W1A3 lut (calibrated) prefill of 4 tokens, card "
        f"(lut_stream_gemm) vs CPU (plain gathers): max err {lerr:.3e} = {lerr/lscale:.3e} x "
        f"max|logit|, argmax {'equal' if torch.equal(ll_gpu.argmax(-1), ll_cpu.argmax(-1)) else 'differs'}")

    budgets = (5, 8, 3, 6, 4, 7)
    reqs = [Request(prompt=rng.integers(0, cfg2.vocab_size, 16).astype(np.int32),
                    max_new_tokens=m) for m in budgets]
    scan = ServeEngine(model, params, batch=4, max_seq=64, decode="scan", device=dev)
    loop = ServeEngine(model, params, batch=4, max_seq=64, decode="loop", device=dev)
    waves = []
    scan.on_wave = waves.append
    o_scan, o_loop = scan.generate(reqs), loop.generate(reqs)
    check(o_scan == o_loop, f"scan != loop tokens:\n{o_scan}\n{o_loop}")
    check([len(o) for o in o_scan] == list(budgets), "per-request budgets not honored")
    check(scan.host_syncs == len(waves), "scan driver synced more than once per wave")
    want_loop = max(budgets[:4]) + max(budgets[4:])
    check(loop.host_syncs == want_loop, f"loop syncs {loop.host_syncs} != {want_loop}")
    log(f"phase 5: scan == loop token for token on {len(reqs)} requests; scan "
        f"{scan.host_syncs} syncs over {len(waves)} waves, loop {loop.host_syncs} "
        f"(one per token)")
    return err / scale, lerr / lscale


# ---------------------------------------------------------------------------
# Phases 9-11: flash_attention vs its plain version; gemma2-2b's forward
# ---------------------------------------------------------------------------

# (name, B, S, T, H, Hkv, hd, kwargs): the CPU tests' sweep, then the
# full-width shapes: gemma2-2b's local ("L") and global ("G") layers at
# S = 8192, stablelm-12b's at the serve prefill's longest S = 2048.
FLASH_CASES = [
    ("sweep", 2, 256, 256, 4, 2, 64, {}),
    ("sweep", 1, 384, 384, 8, 8, 32, dict(window=128)),
    ("sweep", 2, 128, 128, 4, 1, 64, dict(softcap=30.0)),
    ("sweep", 1, 200, 200, 2, 2, 64, {}),
    ("sweep", 1, 256, 256, 4, 4, 64, dict(causal=False)),
    ("sweep", 1, 130, 130, 2, 2, 64, dict(window=32)),
    ("sweep", 1, 96, 160, 4, 2, 64, dict(window=48, softcap=50.0)),   # T > S, ragged T
    ("gemma2-2b L", 1, FLASH_SEQ, FLASH_SEQ, 8, 4, 256, dict(window=4096, softcap=50.0)),
    ("gemma2-2b G", 1, FLASH_SEQ, FLASH_SEQ, 8, 4, 256, dict(softcap=50.0)),
    ("stablelm-12b", 1, 2048, 2048, 32, 8, 160, {}),
]


def flash_kw(kw):
    return dict(causal=kw.get("causal", True), window=kw.get("window"),
                softcap=kw.get("softcap"))


def flash_visible_pairs(s, t, causal, window):
    """(query, key) pairs the masks leave: the work this run's inputs need."""
    total = 0
    for qpos in range(s):
        hi = min(t, qpos + 1) if causal else t
        lo = max(0, qpos - window + 1) if window is not None else 0
        total += max(0, hi - lo)
    return total


def flash_ops(b, s, t, h, hd, kw):
    """2 x 2 x hd operations per visible (query, key) pair and head."""
    kw = flash_kw(kw)
    return 4.0 * hd * h * b * flash_visible_pairs(s, t, kw["causal"], kw["window"])


def flash_bound_s(b, s, t, h, hkv, hd, kw, elem_bytes, card):
    """Least time of one flash_attention call: q, k, v read once and the
    output written once over the memory rate; or its 2 x 2 x hd operations
    per visible (query, key) pair and head (the two products) over the peak
    for the inputs' type (bf16: the tensor cores; f32: the CUDA cores).
    Returns (seconds, bound_by)."""
    ops = flash_ops(b, s, t, h, hd, kw)
    nbytes = elem_bytes * (2 * b * s * h * hd + 2 * b * t * hkv * hd)
    peak = card.peak_flops_bf16 if elem_bytes == 2 else card.peak_flops_f32
    t_bytes, t_ops = nbytes / card.hbm_bandwidth, ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_inputs(torch, dev, gen, b, s, t, h, hkv, hd, dtype):
    q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, hkv, hd), generator=gen, device=dev).to(dtype)
    return q, k, v


def flash_err(torch, got, want):
    """(max abs error, the scale its tolerance is relative to)."""
    return (got.float() - want.float()).abs().max().item(), want.float().abs().max().item()


def flash_row_err(got, want32):
    """Worst over rows (b, s, h) of max |got - want32| / max |want32|, each
    row against its own largest value."""
    g, w = got.float(), want32.float()
    return ((g - w).abs().amax(-1) / w.abs().amax(-1)).max().item()


def flash_planted_faults(kw, q_scale):
    """Faults a kernel could make at a case's options, each as the options
    it would in effect compute with: the softcap left out (only where q is
    scaled: unscaled scores hardly reach the cap, so the two functions
    hardly differ), or the window one key block (64) too wide or too
    narrow."""
    faults = []
    if kw.get("softcap") is not None and q_scale > 1.0:
        faults.append(("softcap left out", dict(kw, softcap=None)))
    if kw.get("window") is not None:
        faults += [("window one block wider", dict(kw, window=kw["window"] + 64)),
                   ("window one block narrower", dict(kw, window=kw["window"] - 64))]
    return faults


def phase_flash_kernel(torch, dev):
    """flash_attention against its plain version on the card, f32 and bf16,
    at the CPU tests' sweep and the full-width shapes, and again with q
    scaled by FLASH_Q_SCALE at every softcapped case.  bf16 is held to two
    checks: the whole output against the plain version's bf16 output
    (TOL_FLASH_BF16 x max |out|), and each row against the plain version in
    f32 (TOL_FLASH_BF16_ROW x the row's max |out|), which a dropped softcap
    or a window off by one key block fails; at gemma2-2b's shapes both
    faults are planted (the kernel called with those options, held against
    the plain version with the right ones) and the row check must reject
    them."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(9)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_row = 0.0
    repeats, planted = [], []
    cases = [(c, 1.0) for c in FLASH_CASES]
    cases += [(c, FLASH_Q_SCALE) for c in FLASH_CASES if c[7].get("softcap") is not None]
    for (name, b, s, t, h, hkv, hd, kw), q_scale in cases:
        label = name if q_scale == 1.0 else f"{name} q x{q_scale:g}"
        for dtype, tol in ((torch.float32, TOL_FLASH_F32), (torch.bfloat16, TOL_FLASH_BF16)):
            q, k, v = flash_inputs(torch, dev, gen, b, s, t, h, hkv, hd, dtype)
            q = q * q_scale
            got = fa.flash_attention(q, k, v, **flash_kw(kw))
            if name.startswith("gemma2-2b") and dtype == torch.bfloat16:
                # Deterministic: one CTA per output tile, no atomics.
                check(fa.route(dtype, hd) == "tc", f"flash {label} bf16 not on the tensor cores")
                again = fa.flash_attention(q, k, v, **flash_kw(kw))
                check(torch.equal(got, again), f"flash {label} bf16: a repeated launch on the "
                                               f"same inputs gave other bits")
                repeats.append(label)
                del again
            want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), **flash_kw(kw))
            want = want32.to(dtype)       # the plain version on the dtype's inputs, exactly
            err, scale = flash_err(torch, got, want)
            bound = tol * (max(scale, 1.0) if dtype == torch.float32 else scale)
            check(got.dtype == dtype and got.shape == q.shape, f"flash {label}: dtype/shape")
            check(err <= bound, f"flash {label} {tuple(q.shape)} {kw} {dtype}: max err "
                                f"{err:.3e} > {bound:.3e}")
            worst[dtype] = max(worst[dtype], err)
            if dtype == torch.bfloat16:
                row = flash_row_err(got, want32)
                check(row <= TOL_FLASH_BF16_ROW, f"flash {label} {tuple(q.shape)} {kw} bf16: "
                      f"row error {row:.3e} x the row's max |out| > {TOL_FLASH_BF16_ROW}")
                worst_row = max(worst_row, row)
                if name.startswith("gemma2-2b"):
                    for fault, bad_kw in flash_planted_faults(kw, q_scale):
                        bad = fa.flash_attention(q, k, v, **flash_kw(bad_kw))
                        bad_row = flash_row_err(bad, want32)
                        bad_err = flash_err(torch, bad, want)[0]
                        check(bad_row > TOL_FLASH_BF16_ROW,
                              f"flash {label}: planted fault ({fault}) passed the row check: "
                              f"{bad_row:.3e} x the row's max |out|")
                        planted.append(f"{label}, {fault}: row err {bad_row:.3e} (rejected); "
                                       f"max err {bad_err:.3e} against the whole-output "
                                       f"tolerance {bound:.3e} ("
                                       f"{'passes' if bad_err <= bound else 'rejected'})")
                        del bad
            del q, k, v, got, want, want32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 9: flash_attention == plain version on {2 * len(cases)} cases (the CPU "
        f"sweep, gemma2-2b L and G at S={FLASH_SEQ}, stablelm-12b at S=2048, and the softcapped "
        f"ones again with q x{FLASH_Q_SCALE:g}; f32 and bf16): worst abs err f32 "
        f"{worst[torch.float32]:.3e} (tol {TOL_FLASH_F32} x max(1, max|out|)), bf16 "
        f"{worst[torch.bfloat16]:.3e} (tol 2^-7 x max|out|); worst bf16 row err against f32 "
        f"{worst_row:.3e} x the row's max |out| (tol 2^-7); routes: bf16 hd 64/256 tensor "
        f"cores, hd 32/160 and f32 CUDA cores; repeated bf16 launches bit-equal at "
        f"{', '.join(repeats)}")
    log("phase 9: planted faults, bf16 (the kernel called with the faulty options):")
    for line in planted:
        log(f"  {line}")
    return max(worst.values())


def library_fn(torch, q, k, v, kw):
    """One PyTorch call computing the same function, timed as a yardstick
    and used nowhere in the port: ``scaled_dot_product_attention`` for a
    causal or full mask without softcap; otherwise ``flex_attention``,
    compiled with ``torch.compile`` as it is meant to run, with the softcap
    in its ``score_mod`` (applied after the 1/sqrt(hd) scale, as the
    reference does) and the causal and window masks in a block mask (so it
    skips the masked blocks too).  The [B, S, H, hd] views go in as its
    [B, H, S, hd].  Returns (name, fn)."""
    import torch.nn.functional as F

    kw = flash_kw(kw)
    causal, window, cap = kw["causal"], kw["window"], kw["softcap"]
    if cap is None and window is None:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return "scaled_dot_product_attention", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True).transpose(1, 2)

    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, q_idx, kv_idx):
        keep = q_idx >= kv_idx if causal else q_idx >= 0
        if window is not None:
            keep = keep & (kv_idx > q_idx - window)
        return keep

    block_mask = create_block_mask(mask_mod, B=None, H=None, Q_LEN=q.shape[1],
                                   KV_LEN=k.shape[1], device=q.device)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    compiled = torch.compile(flex_attention, dynamic=False)
    return "flex_attention (torch.compile)", lambda: compiled(
        qt, kt, vt, score_mod=score_mod if cap is not None else None,
        block_mask=block_mask, enable_gqa=True).transpose(1, 2)


def phase_flash_times(torch, dev, card, smi):
    """Kernel, plain-version and library times of flash_attention at the
    full-width shapes, bf16 (the forward's activations), beside the bound;
    the library call is held against the plain version first."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(10)
    rows = []
    for name, b, s, t, h, hkv, hd, kw in FLASH_CASES:
        if name == "sweep":
            continue
        q, k, v = flash_inputs(torch, dev, gen, b, s, t, h, hkv, hd, torch.bfloat16)
        route = fa.route(q.dtype, hd)
        kern = time_ms(torch, lambda i: fa.flash_attention(q, k, v, **flash_kw(kw)), 5)
        # The CUDA-core kernel at the same bf16 inputs, which the
        # tensor-core route now takes: the redesign's "before".
        earlier = None if route != "tc" else time_ms(
            torch, lambda i: fa.cuda_core_yardstick(q, k, v, **flash_kw(kw)), 2)
        plain = time_ms(torch, lambda i: ref.flash_attention_ref(q, k, v, **flash_kw(kw)), 2)
        lib_name, lib_fn = library_fn(torch, q, k, v, kw)
        want = ref.flash_attention_ref(q, k, v, **flash_kw(kw))
        err, scale = flash_err(torch, lib_fn(), want)
        check(err <= TOL_FLASH_BF16 * scale, f"{lib_name} != plain at {name}: {err:.3e}")
        del want
        lib = time_ms(torch, lambda i: lib_fn(), 10)
        bnd, by = flash_bound_s(b, s, t, h, hkv, hd, kw, 2, card)
        tflops = flash_ops(b, s, t, h, hd, kw) / (kern * 1e-3) / 1e12
        rows.append(dict(shape=name, B=b, S=s, T=t, H=h, Hkv=hkv, hd=hd, **flash_kw(kw),
                         route=route, ms=kern, tflops=tflops, bound_fraction=bnd * 1e3 / kern,
                         plain_ms=plain, bound_ms=bnd * 1e3, bound_by=by,
                         library_ms=lib, library=lib_name, library_max_abs_err=err,
                         cuda_core_ms=earlier))
        log(f"  {name:13s} B={b} S={s} H={h}/{hkv} hd={hd} {kw}: kernel ({route}) {kern:.3f} ms "
            f"= {tflops:.1f} TFLOP/s, {bnd * 1e3 / kern:.3f} of its bound {bnd * 1e3:.3f} ms "
            f"({by}); plain {plain:.3f} ms, {lib_name} {lib:.3f} ms (max err vs plain "
            f"{err:.3e})" + ("" if earlier is None else
                             f", the CUDA-core kernel {earlier:.3f} ms") + f" [{smi}]")
        del q, k, v, lib_fn
        torch.cuda.empty_cache()
    log("phase 10: flash_attention times at the full-width shapes (bf16)")
    return rows


def flash_forward_times(rows, cfg_layers, fwd):
    """The kernel's work in one gemma2-2b forward: its "L" and "G" shapes,
    each once per unit (13 units of "LG").  ``ms``, ``plain_ms``,
    ``library_ms`` and ``bound_ms`` are derived: 13 x (L + G) of phase 10's
    standalone times; ``ms_in_forward`` is the kernel's own device time
    inside phase 11's forward (torch.profiler)."""
    units = cfg_layers.n_layers // len(cfg_layers.layer_pattern)
    picked = [r for r in rows if r["shape"] in ("gemma2-2b L", "gemma2-2b G")]
    check(all(r["route"] == "tc" for r in picked), "gemma2-2b shapes not on the tensor cores")
    return {"at": f"one gemma2-2b forward, B=1 x S={FLASH_SEQ}, bf16: {units} local "
                  f"(window {cfg_layers.window}) + {units} global layers, softcap "
                  f"{cfg_layers.attn_logit_softcap:g}",
            **{key: units * sum(r[key] for r in picked)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in picked)
            else "bytes",
            "library": picked[0]["library"],
            "derived": f"ms, plain_ms, library_ms, bound_ms: {units} x (L + G) of the "
                       f"standalone times (phase 10)",
            "ms_in_forward": fwd["flash_attention_profiled_ms"],
            "routes": {r["shape"]: r["route"] for r in rows},
            "earlier": {"route": "cuda_core",
                        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "at": "the same bf16 inputs as phase 10, this run",
                        "ms": units * sum(r["cuda_core_ms"] for r in picked),
                        **{r["shape"]: r["cuda_core_ms"] for r in picked}}}


def phase_gemma2_forward(torch, dev, smi):
    """gemma2-2b at its published widths (26 layers), random weights from
    seed 0, W4A4 pallas prepared, bf16: ``Model.forward`` over B=1 x S=8192
    tokens with ``attn_impl="flash"``, launch counts set to 0 just before and
    read just after, held against ``attn_impl="xla"`` on the same tree."""
    from repro_torch.configs import get_config
    from repro_torch.core import LutLinearSpec
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    import numpy as np

    cfg = dataclasses.replace(get_config("gemma2-2b"), attn_impl="flash")
    flash, xla = build_model(cfg), build_model(dataclasses.replace(cfg, attn_impl="xla"))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = flash.prepare(flash.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"),
                                                seed=0, device=dev), n_hint=FLASH_SEQ)
    torch.cuda.synchronize()
    log(f"phase 11: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"hd={cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab_size} layers={cfg.n_layers} "
        f"(segments {transformer.segments(cfg)}), window {cfg.window}, softcaps {cfg.attn_logit_softcap}/"
        f"{cfg.final_logit_softcap}, W4A4 pallas prepared in {time.perf_counter() - t0:.1f}s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on the card")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, FLASH_SEQ)).astype(np.int32)).to(dev)
    flash.forward(params, toks[:, :512], return_hidden=True)     # warmup
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    h_flash, caches = flash.forward(params, toks, return_hidden=True)
    torch.cuda.synchronize()
    wall_flash = time.perf_counter() - t0
    counts = read_launches()
    check(caches is None, "the cache-free forward returned caches")
    check(counts["flash_attention"] == cfg.n_layers,
          f"flash_attention launches {counts['flash_attention']} != {cfg.n_layers} layers")
    check(counts["flash_attention_tc"] == cfg.n_layers,
          f"flash_attention launches on the tensor cores {counts['flash_attention_tc']} != "
          f"{cfg.n_layers} layers (bf16, hd {cfg.hd})")
    check(counts["lut_dequant_gemm"] == 7 * cfg.n_layers,
          f"lut_dequant_gemm launches {counts['lut_dequant_gemm']} != 7 x {cfg.n_layers}")
    check(counts["lut_dequant_gemm_tc"] == 7 * cfg.n_layers,
          f"lut_dequant_gemm launches on the tensor cores {counts['lut_dequant_gemm_tc']} != "
          f"7 x {cfg.n_layers} (bf16 x, int grid)")
    check(counts["lut_stream_gemm"] == 0, f"the pallas forward launched lut_stream_gemm: {counts}")

    reset_launches()
    t0 = time.perf_counter()
    h_xla, _ = xla.forward(params, toks, return_hidden=True)
    torch.cuda.synchronize()
    wall_xla = time.perf_counter() - t0
    check(read_launches()["flash_attention"] == 0, "the xla forward launched flash_attention")

    check(h_flash.shape == (1, FLASH_SEQ, cfg.d_model) and h_flash.dtype == torch.bfloat16,
          f"hidden states {tuple(h_flash.shape)} {h_flash.dtype}")
    check(bool(torch.isfinite(h_flash).all()), "flash hidden states not finite")

    def compare(a, b):
        """(max abs difference / max |b|, relative Frobenius norm)."""
        a, b = a.float(), b.float()
        return ((a - b).abs().max().item() / b.abs().max().item(),
                ((a - b).norm() / b.norm()).item())

    n_last = min(512, FLASH_SEQ)
    lg_flash = transformer.lm_head(params, cfg, h_flash[:, -n_last:])
    lg_xla = transformer.lm_head(params, cfg, h_xla[:, -n_last:])
    check(bool(torch.isfinite(lg_flash).all()) and lg_flash.shape == (1, n_last, cfg.vocab_size),
          f"flash logits {tuple(lg_flash.shape)} or not finite")
    agree = (lg_flash.argmax(-1) == lg_xla.argmax(-1)).float().mean().item()
    bf16 = {"hidden states": compare(h_flash, h_xla), "logits": compare(lg_flash, lg_xla)}

    # The same tree in f32 activations: flash against xla (the kernel's own
    # agreement through 26 layers), and the bf16 xla forward against it (the
    # bf16 rounding that the two bf16 forwards may differ by).
    f32 = {}
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    h32 = {impl: build_model(dataclasses.replace(f32_cfg, attn_impl=impl)).forward(
        params, toks, return_hidden=True)[0] for impl in ("flash", "xla")}
    lg32 = {impl: transformer.lm_head(params, f32_cfg, h[:, -n_last:]) for impl, h in h32.items()}
    f32["hidden states"] = compare(h32["flash"], h32["xla"])
    f32["logits"] = compare(lg32["flash"], lg32["xla"])
    floor = {"hidden states": compare(h_xla, h32["xla"]), "logits": compare(lg_xla, lg32["xla"])}
    del h32, lg32
    log(f"phase 11 [{smi}]: Model.forward B=1 x S={FLASH_SEQ}: flash {wall_flash:.3f} s, xla "
        f"{wall_xla:.3f} s (host clock, synchronized); launches {counts}; last-{n_last} argmax "
        f"agreement flash vs xla (bf16) {agree:.4f}")
    for what in ("hidden states", "logits"):
        log(f"  {what}: flash vs xla, bf16: max err {bf16[what][0]:.3e} x max|value|, rel norm "
            f"{bf16[what][1]:.3e}; f32: max err {f32[what][0]:.3e}, rel norm "
            f"{f32[what][1]:.3e}; bf16 xla vs f32 xla (bf16 rounding): max err "
            f"{floor[what][0]:.3e}, rel norm {floor[what][1]:.3e}")
    for what in ("hidden states", "logits"):
        check(f32[what][0] <= TOL_FORWARD_F32,
              f"flash vs xla {what}, f32: max err {f32[what][0]:.3e} x max|value| > "
              f"{TOL_FORWARD_F32}")
        check(bf16[what][1] <= TOL_FORWARD_BF16 * floor[what][1],
              f"flash vs xla {what}, bf16: rel norm {bf16[what][1]:.3e} > {TOL_FORWARD_BF16} x "
              f"the bf16 forward's own rounding {floor[what][1]:.3e}")

    fwd_flash = time_ms(torch, lambda i: flash.forward(params, toks, return_hidden=True), 2)
    fwd_xla = time_ms(torch, lambda i: xla.forward(params, toks, return_hidden=True), 2)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"phase 11 [{smi}]: forward (CUDA events, mean of 2): flash {fwd_flash:.2f} ms, xla "
        f"{fwd_xla:.2f} ms; peak memory {peak / 1e9:.2f} GB")
    log("phase 11: where the device time goes (torch.profiler, one forward each):")
    prof = device_time_by_kernel(torch, lambda: flash.forward(params, toks, return_hidden=True), 1)
    log_breakdown("flash forward", prof, fwd_flash, kernel="flash_attention", card=smi)

    def profiled(kernel):
        return None if prof is None else sum(ms for name, (ms, _n) in prof.items()
                                             if kernel in name)
    if prof is not None:
        busy = sum(ms for ms, _n in prof.values())
        log(f"  flash forward: lut_dequant_gemm {profiled('lut_dequant_gemm'):.2f} ms of "
            f"{busy:.2f} ms busy ({profiled('lut_dequant_gemm') / busy:.3f}), by kernel name:")
        for name, (ms, n) in sorted(prof.items(), key=lambda kv: -kv[1][0]):
            if "lut_dequant_gemm" in name:
                log(f"    {ms:8.3f} ms {n:5.0f} x  {name[:110]}")
    log_breakdown("xla forward", device_time_by_kernel(
        torch, lambda: xla.forward(params, toks, return_hidden=True), 1),
        fwd_xla, kernel="lut_dequant_gemm", card=smi)
    del params, h_flash, h_xla, lg_flash, lg_xla
    torch.cuda.empty_cache()
    return dict(launches=counts["flash_attention"],
                launches_tc=counts["flash_attention_tc"], wall_flash_s=wall_flash,
                wall_xla_s=wall_xla, forward_flash_ms=fwd_flash, forward_xla_ms=fwd_xla,
                flash_vs_xla_bf16=bf16, flash_vs_xla_f32=f32, bf16_vs_f32=floor,
                argmax_agreement=agree, peak_gb=peak / 1e9,
                flash_attention_profiled_ms=profiled("flash_attention"),
                lut_dequant_gemm_profiled_ms=profiled("lut_dequant_gemm"),
                lut_dequant_gemm_launches=counts["lut_dequant_gemm"],
                lut_dequant_gemm_launches_tc=counts["lut_dequant_gemm_tc"])


# ---------------------------------------------------------------------------
# Phase 14: gemma2-2b served at its 8192-token context (the ring-window, int8
# and bf16-operand attention of the serve profile)
# ---------------------------------------------------------------------------


def kv_cache_bytes(cfg, batch, max_seq):
    """KV-cache bytes of ``cfg`` from the shapes alone (the reference's
    ``_sublayer_cache``): f32 K and V per sublayer; an "L" sublayer holds
    ``min(max_seq, window)`` slots under ``ring_window_cache``; a sublayer
    holding all ``max_seq`` positions stores int8 codes + f32 row scales
    under ``kv_cache_int8``."""
    from repro_torch.models import transformer

    total = 0
    for pattern, n_units in transformer.segments(cfg):
        for ch in pattern:
            seq = min(max_seq, cfg.window) if ch == "L" and cfg.ring_window_cache else max_seq
            rows = n_units * batch * seq * cfg.n_kv_heads
            per_kv = rows * (cfg.hd + 4) if cfg.kv_cache_int8 and seq == max_seq else rows * cfg.hd * 4
            total += 2 * per_kv
    return total


def teacher_forced_logits(torch, dev, cfg, params, toks, prefix):
    """The reference's ``_decode_logits`` (tests/test_perf_features.py): a
    ``prefix``-token prefill of ``toks`` into f32 caches of GEMMA_SERVE_SEQ
    positions, then one teacher-forced ``decode_step`` for each later token;
    the logits ``[B, 1 + steps, V]`` in f32."""
    from repro_torch.models.model import build_model

    m = build_model(cfg)
    caches = m.init_cache(toks.shape[0], GEMMA_SERVE_SEQ, torch.float32, device=dev)
    lg, caches = m.prefill(params, toks[:, :prefix], caches)
    outs = [lg[:, 0].float()]
    for t in range(prefix, toks.shape[1]):
        lg, caches = m.decode_step(params, toks[:, t : t + 1], caches, t)
        outs.append(lg[:, 0].float())
    del caches
    return torch.stack(outs, dim=1)


def forward_logits(cfg, params, toks, prefix):
    """The cache-free ``Model.forward`` (``attn_impl="xla"``) over ``toks``:
    the logits at the positions :func:`teacher_forced_logits` gives, in f32."""
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model

    hidden, _ = build_model(dataclasses.replace(cfg, attn_impl="xla")).forward(
        params, toks, return_hidden=True)
    return transformer.lm_head(params, cfg, hidden[:, prefix - 1 :]).float()


def rel_norm(torch, a, b):
    """Relative Frobenius distance of ``a`` from ``b``."""
    return ((a - b).norm() / b.norm()).item()


def phase_gemma2_semantics(torch, dev, cfg_full):
    """14a: one "LG" unit of gemma2-2b at its published widths, f32 (the
    CUDA-core route of lut_dequant_gemm), W4A4 pallas prepared, B = 2,
    max_seq 8192: a GEMMA_PREFIX-token prefill and GEMMA_DECODE teacher-forced
    decode steps (the local ring of 4096 slots wraps at step 4096 -
    GEMMA_PREFIX), the reference's ``_decode_logits`` at full width.  Ring vs
    the baseline's full cache, the baseline vs the cache-free forward over the
    same tokens, the serve profile vs the baseline; the profile's defective
    combination (an int8 "L" cache no longer than the window) refused."""
    from repro_torch.core import LutLinearSpec
    from repro_torch.models.model import build_model
    from repro_torch.models.profiles import apply_perf_profile
    import numpy as np

    base = dataclasses.replace(cfg_full, n_layers=2, dtype="float32")
    cfgs = {"baseline": base, "ring": dataclasses.replace(base, ring_window_cache=True),
            "serve profile": apply_perf_profile(base, "serve")}
    model = build_model(base)
    params = model.prepare(model.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"), seed=0,
                                                device=dev), n_hint=2)
    total = GEMMA_PREFIX + GEMMA_DECODE
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, base.vocab_size, (2, total)).astype(np.int32)).to(dev)

    t0 = time.perf_counter()
    reset_launches()
    out = {name: teacher_forced_logits(torch, dev, cfg, params, toks, GEMMA_PREFIX)
           for name, cfg in cfgs.items()}
    counts = read_launches()
    calls = 3 * 7 * base.n_layers * (1 + GEMMA_DECODE)
    check(counts["lut_dequant_gemm"] == calls and counts["lut_dequant_gemm_tc"] == 0,
          f"14a: lut_dequant_gemm launches {counts['lut_dequant_gemm']} (tensor cores "
          f"{counts['lut_dequant_gemm_tc']}) != {calls} on the CUDA cores (f32 x)")
    fwd = forward_logits(base, params, toks, GEMMA_PREFIX)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name, lg in {**out, "forward": fwd}.items():
        check(bool(torch.isfinite(lg).all()) and lg.shape == (2, 1 + GEMMA_DECODE, base.vocab_size),
              f"14a: {name} logits {tuple(lg.shape)} or not finite")
    b, r = out["baseline"], out["ring"]
    ring_abs = (r - b).abs().max().item()
    ring_excess = ((r - b).abs() - TOL_RING * b.abs()).max().item()      # <= TOL_RING
    fwd_err = (b - fwd).abs().max().item() / fwd.abs().max().item()
    prof_rel = rel_norm(torch, out["serve profile"], b)
    wrap = base.window - GEMMA_PREFIX
    log(f"phase 14a: {base.name} 1 x 'LG' at full width (d_model {base.d_model}, heads "
        f"{base.n_heads}/{base.n_kv_heads}, hd {base.hd}, window {base.window}), f32, W4A4 pallas "
        f"(the CUDA-core route), B=2, max_seq {GEMMA_SERVE_SEQ}: prefill {GEMMA_PREFIX} + "
        f"{GEMMA_DECODE} decode steps (the ring wraps at step {wrap}) under each config, and the "
        f"cache-free forward over the {total} tokens, in {wall:.1f} s")
    log(f"  (i) ring == baseline: max |diff| {ring_abs:.3e}, |diff| - {TOL_RING} x |baseline| at "
        f"most {ring_excess:.3e} (allclose rtol = atol = {TOL_RING} needs <= {TOL_RING})")
    log(f"  (ii) baseline decode == cache-free forward: max |diff| {fwd_err:.3e} x max |logit| "
        f"(<= {TOL_DECODE_FWD})")
    log(f"  (iii) serve profile vs baseline: relative Frobenius {prof_rel:.4f} (< {TOL_PROFILE})")
    check(ring_excess <= TOL_RING, f"14a: ring vs baseline beyond rtol = atol = {TOL_RING}")
    check(fwd_err <= TOL_DECODE_FWD, f"14a: baseline decode vs forward {fwd_err:.3e} x max |logit|")
    check(prof_rel < TOL_PROFILE, f"14a: serve profile vs baseline {prof_rel:.4f}")
    try:
        build_model(cfgs["serve profile"]).init_cache(2, base.window, torch.float32, device=dev)
    except NotImplementedError as e:
        log(f"  (iv) serve profile at max_seq = window ({base.window}) refused: {str(e)[:90]}...")
    else:
        raise SmokeFailure("14a: an int8 'L' cache no longer than the window was not refused")
    del out, fwd, params
    torch.cuda.empty_cache()
    return dict(ring_max_abs=ring_abs, decode_vs_forward=fwd_err, profile_rel=prof_rel,
                wall_s=wall)


def phase_gemma2_decode_vs_forward(torch, dev, cfg):
    """14b's answers: gemma2-2b (``cfg``'s depth) in bf16 under the serve
    profile (ring, int8 and bf16-operand attention), W4A4 pallas prepared,
    B = 2: a GEMMA_TF_PREFIX-token prefill and GEMMA_TF_DECODE teacher-forced
    decode steps (the local rings wrap at step 4096 - GEMMA_TF_PREFIX), held
    against the cache-free f32 forward over the same tokens.  The limit comes
    from the run itself: TOL_FORWARD_BF16 x the bf16 forward's own distance
    from the f32 forward (the bf16 rounding), plus the ring + int8 decode's
    distance in f32 (the cache's quantization), which is held to TOL_INT8.
    Both are checked over all steps and over the steps after the wrap."""
    from repro_torch.core import LutLinearSpec
    from repro_torch.models.model import build_model
    from repro_torch.models.profiles import apply_perf_profile
    import numpy as np

    prof = apply_perf_profile(cfg, "serve")
    f32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    model = build_model(prof)
    params = model.prepare(model.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"), seed=0,
                                                device=dev), n_hint=2)
    total = GEMMA_TF_PREFIX + GEMMA_TF_DECODE
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, total)).astype(np.int32)).to(dev)
    lg = {"decode, serve profile, bf16": teacher_forced_logits(
              torch, dev, prof, params, toks, GEMMA_TF_PREFIX),
          "decode, ring + int8, f32": teacher_forced_logits(
              torch, dev, dataclasses.replace(f32, ring_window_cache=True, kv_cache_int8=True),
              params, toks, GEMMA_TF_PREFIX),
          "forward, serve profile, bf16": forward_logits(prof, params, toks, GEMMA_TF_PREFIX),
          "forward, f32": forward_logits(f32, params, toks, GEMMA_TF_PREFIX)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name, x in lg.items():
        check(bool(torch.isfinite(x).all()) and x.shape == (2, 1 + GEMMA_TF_DECODE, cfg.vocab_size),
              f"14b: {name} logits {tuple(x.shape)} or not finite")
    wrap = 1 + cfg.window - GEMMA_TF_PREFIX            # the first logits row after the wrap
    ref = lg["forward, f32"]
    dist = {part: {name: rel_norm(torch, x[:, rows], ref[:, rows]) for name, x in lg.items()
                   if name != "forward, f32"}
            for part, rows in (("all steps", slice(None)), ("after the wrap", slice(wrap, None)))}
    log(f"phase 14b: {cfg.name} {cfg.n_layers} layers, W4A4 pallas, B=2: prefill "
        f"{GEMMA_TF_PREFIX} + {GEMMA_TF_DECODE} teacher-forced decode steps (the rings wrap at "
        f"step {wrap - 1}) against the cache-free f32 forward over the {total} tokens, in "
        f"{wall:.1f} s; relative Frobenius distance from it:")
    for part, d in dist.items():
        floor, int8 = d["forward, serve profile, bf16"], d["decode, ring + int8, f32"]
        limit = TOL_FORWARD_BF16 * floor + int8
        err = d["decode, serve profile, bf16"]
        log(f"  {part}: {', '.join(f'{name} {v:.4e}' for name, v in d.items())}; the bf16 "
            f"decode's limit {TOL_FORWARD_BF16} x {floor:.4e} + {int8:.4e} = {limit:.4e}")
        check(int8 < TOL_INT8, f"14b ({part}): ring + int8 decode in f32 {int8:.4e} from the f32 "
                               f"forward (>= {TOL_INT8})")
        check(err <= limit, f"14b ({part}): the bf16 serve profile's decode {err:.4e} from the "
                            f"f32 forward, beyond {limit:.4e}")
    del lg, ref, params
    torch.cuda.empty_cache()
    return dict(wall_s=wall, limit_factor=TOL_FORWARD_BF16, **{
        part: {name: v for name, v in d.items()} for part, d in dist.items()})


def phase_gemma2_serve(torch, dev, smi):
    """Phase 14: gemma2-2b serving.  14a (:func:`phase_gemma2_semantics`),
    then 14b: :data:`GEMMA_SERVE_LAYERS` of its 26 layers at published widths,
    seed-0 weights, W4A4 pallas
    prepared, bf16, under ``apply_perf_profile(cfg, "serve")`` through
    ``ServeEngine(batch=4, max_seq=8192)``: GEMMA_REQUESTS requests of
    3072-4096 prompt tokens, GEMMA_NEW new tokens each (the longest wrap the
    local rings while decoding), the same tokens under ``decode="chunked"``;
    the same requests under the baseline profile (plain 8192 caches); and
    the profile's answers against the cache-free forward
    (:func:`phase_gemma2_decode_vs_forward`)."""
    from repro_torch.configs import get_config
    from repro_torch.core import LutLinearSpec
    from repro_torch.models.profiles import apply_perf_profile

    cfg = get_config("gemma2-2b")
    sem = phase_gemma2_semantics(torch, dev, cfg)
    served = {}
    for name, c in (("serve profile", apply_perf_profile(cfg, "serve")), ("baseline", cfg)):
        served[name] = phase_serve(
            torch, dev, c, smi, phase=f"14b {name}", spec=LutLinearSpec(bw=4, ba=4, mode="pallas"),
            kernel="lut_dequant_gemm", max_prompt=GEMMA_BUCKET, max_new=GEMMA_NEW,
            min_prompt=3072, n_layers=GEMMA_SERVE_LAYERS, max_seq=GEMMA_SERVE_SEQ,
            timing=(GEMMA_BUCKET, GEMMA_BUCKET + GEMMA_NEW // 2),
            chunked=name == "serve profile", iters=(2, 10))
    prof, base = served["serve profile"], served["baseline"]
    agree = sum(a == b for o1, o2 in zip(prof["outs"], base["outs"])
                for a, b in zip(o1, o2)) / sum(len(o) for o in prof["outs"])
    log(f"phase 14b [{smi}]: the serve profile against the baseline: KV cache "
        f"{prof['cache_bytes'] / 1e9:.3f} / {base['cache_bytes'] / 1e9:.3f} GB, decode step "
        f"{prof['step_ms']:.2f} / {base['step_ms']:.2f} ms, prefill 4 x {GEMMA_BUCKET} "
        f"{prof['prefill_ms']:.2f} / {base['prefill_ms']:.2f} ms, {prof['tok_s']:.1f} / "
        f"{base['tok_s']:.1f} tok/s, peak {prof['peak_gb']:.2f} / {base['peak_gb']:.2f} "
        f"GB; tokens equal at {agree:.3f} of positions")
    for r in (prof, base):
        r.pop("outs")
    answers = phase_gemma2_decode_vs_forward(
        torch, dev, dataclasses.replace(cfg, n_layers=GEMMA_SERVE_LAYERS))
    return dict(semantics=sem, serve_profile=prof, baseline=base, token_agreement=agree,
                answers=answers)


# ---------------------------------------------------------------------------
# Phase 15: live operations at full width (prepared checkpoints, kill +
# replay from the durable request log, hot-swap under a plan, the chaos sweep)
# ---------------------------------------------------------------------------

LIVE_DIR = ROOT / "build" / "live_ops"   # git-ignored; removed at the end of the phase
LIVE_LAYERS = 10              # phases 15 and 16: stablelm-12b's depth cut from 40 to keep the
                              # script in its time limit (each check holds at any depth)
LIVE_BUDGET_SEED = 15         # phase 15: new-token budgets in [4, 16] from default_rng(15) on
                              # phase 8's prompts: 5 admission waves undisturbed
LIVE_KILL_WAVES = (0, 1, 2)   # 15b: each attempt dies at the next of these waves (per-attempt
                              # numbering, after the wave's tokens are durable): 3 restarts
LIVE_FLIP_AFTER = 1           # 15c: the flip is requested once wave 1 has synced: it lands at 2
LIVE_CHAOS_LAYERS = 4         # 15d: the chaos sweep's depth (width not cut): 10 points, each a
                              # supervised serve, two of them saving a prepared checkpoint
LIVE_CHAOS_POINTS = 2         # 15d: points per seam
LIVE_STAGES_TIMED = 4         # 15c: stages run back to back while decode steps are timed
LIVE_HELD_SLACK = 1 << 30     # 15b: what the card may hold above the raw tree when a restart
                              # builds its engine (a second 17 GB serving tree fails it)


def live_requests(cfg):
    """Phase 8's 8 prompts with budgets in [4, 16] from
    ``default_rng(LIVE_BUDGET_SEED)``: slots free at different waves, so a
    serve has 5 admission waves (phase 8's has 2)."""
    import numpy as np

    _lens, reqs = serve_requests(cfg, 64, 16)
    budgets = np.random.default_rng(LIVE_BUDGET_SEED).integers(4, 17, len(reqs))
    return [dataclasses.replace(r, max_new_tokens=int(b)) for r, b in zip(reqs, budgets)]


class ThreadSyncs:
    """Synchronizing calls caught by ``torch.cuda.set_sync_debug_mode``,
    counted by the thread that made them (the mode is process-wide: a stage
    thread's syncs are not the serving thread's)."""

    def __init__(self, torch):
        self.torch = torch
        self.seen = []

    def __enter__(self):
        import threading

        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("always")

        def show(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing CUDA operation" in str(message):
                self.seen.append(threading.get_ident())

        warnings.showwarning = show
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self._cm.__exit__(*exc)

    def on(self, ident):
        return sum(1 for t in self.seen if t == ident)


def npy_payload_bytes(path):
    """The bytes of a .npy file after its header."""
    import numpy as np

    with open(path, "rb") as f:
        major, _minor = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if major == 1
                else np.lib.format.read_array_header_2_0)
        read(f)
        header = f.tell()
    return os.path.getsize(path) - header


def check_grad_refusal(torch, dev):
    """15e: each kernel entry refuses a CUDA input that requires grad with
    grad enabled (the kernels have no backward), and launches under
    ``torch.no_grad()``."""
    import numpy as np

    from repro_torch.core import api
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32)).to(dev)
    q = api.quantize_linear(torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
                            .to(dev), api.LutLinearSpec(bw=4))
    qkv = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
           for s in ((1, 8, 2, 16), (1, 8, 1, 16), (1, 8, 1, 16))]
    codes = [torch.from_numpy(rng.integers(0, 2, s).astype(np.float32)).to(dev)
             for s in ((4, 12), (12, 3))]
    calls = {
        "lut_dequant_gemm": lambda g: ops.lut_dequant_gemm(
            x.requires_grad_(g), q.codes, q.scale, bw=4, k=q.k),
        "flash_attention": lambda g: ops.flash_attention(*(t.requires_grad_(g) for t in qkv)),
        "lut_stream_gemm": lambda g: ops.lut_stream_gemm_full(
            *(t.requires_grad_(g) for t in codes), api._lut_pack_cache(1, 1, 3, "int", "int")),
    }
    refused = {}
    for name, call in calls.items():
        try:
            call(True)
            refused[name] = False
        except RuntimeError as e:
            refused[name] = "no backward" in str(e)
        check(refused[name], f"15e: {name} did not refuse a CUDA input that requires grad")
    with torch.no_grad():
        check(calls["lut_dequant_gemm"](True).grad_fn is None
              and calls["flash_attention"](True).grad_fn is None,
              "15e: under no_grad the kernels must launch")
    log(f"phase 15e: the three kernel entries refuse CUDA inputs that require grad: {refused}")
    return refused


def check_cached_attention(torch, n_layers, run):
    """15b at full width: the full-cache branch's attention
    (``_attend_cache_invariant``) against the reference's function,
    ``_attend`` over the cache with ``_key_mask``, on the inputs the served
    forwards of ``run()`` give their first and last layers: the served output
    is the f32 result in its dtype, and that f32 result is within
    TOL_FLASH_F32 x max |out| of the plain one.  Returns (calls checked, the
    largest relative error)."""
    from repro_torch.models import attention as A

    inner, seen, count = A._attend_cache_invariant, [], [0]

    def recording(q, kc, vc, positions, **kw):
        out = inner(q, kc, vc, positions, **kw)
        if count[0] % n_layers in (0, n_layers - 1):   # the cache is written in place
            seen.append((q.clone(), kc.clone(), vc.clone(), positions.clone(), kw, out.clone()))
        count[0] += 1
        return out

    A._attend_cache_invariant = recording
    try:
        run()
    finally:
        A._attend_cache_invariant = inner
    worst = 0.0
    for q, kc, vc, positions, kw, out in seen:
        q32 = q.to(torch.float32)
        got = inner(q32, kc, vc, positions, **kw)
        check(bool(torch.equal(got.to(out.dtype), out)),
              "15b: the served cached attention is not its f32 result in the served dtype")
        m = A._key_mask(torch.arange(kc.shape[1], device=q.device)[None], positions[:, :, None],
                        kw["pad_len"], kw["window"])
        want = A._attend(q32, kc, vc, mask=m[:, None], softcap_val=kw["softcap_val"],
                         bf16_operands=kw["bf16_operands"])
        worst = max(worst, ((got - want).abs().max() / want.abs().max()).item())
    check(len(seen) > 0 and worst <= TOL_FLASH_F32,
          f"15b: the cached attention {worst:.3e} x max |out| from _attend with _key_mask "
          f"over {len(seen)} calls (tolerance {TOL_FLASH_F32})")
    return len(seen), worst


def check_replay_identity(torch, dev, model, tree):
    """15b: the identity a teacher-forced replay rests on, bit for bit: 30
    tokens prefilled behind a pad of 5 and 18 more decoded one at a time,
    against one prefill of all 48 behind a pad of 16 (what a restart does
    with a partly decoded request).  Returns the last logits' max |diff|."""
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(1, model.cfg.vocab_size, (4, 48), generator=gen, device=dev,
                         dtype=torch.int32)

    def left(t, pad):
        x = torch.zeros((4, pad + t.shape[1]), dtype=torch.int32, device=dev)
        x[:, pad:] = t
        return x, torch.full((4,), pad, dtype=torch.int32, device=dev)

    x, pad = left(toks[:, :30], 5)
    caches = model.init_cache(4, 256, dtype=torch.float32, device=dev)
    lg, caches = model.prefill(tree, x, caches, pad_len=pad)
    pos = torch.full((4,), x.shape[1], dtype=torch.int32, device=dev)
    for t in range(30, 48):
        lg, caches = model.decode_step(tree, toks[:, t : t + 1], caches, pos, pad_len=pad)
        pos = pos + 1
    x, pad = left(toks, 16)
    lg2, _ = model.prefill(tree, x, model.init_cache(4, 256, dtype=torch.float32, device=dev),
                           pad_len=pad)
    diff = (lg[:, -1] - lg2[:, -1]).abs().max().item()
    check(bool(torch.equal(lg[:, -1], lg2[:, -1])),
          f"15b: prefill + decode steps and one prefill behind another pad give other logits "
          f"(max |diff| {diff}): a replay would not continue the stream")
    return diff


def phase_live_ops(torch, dev, cfg, smi):
    """Phase 15: stablelm-12b at full width (LIVE_LAYERS of its 40 layers,
    seed 0, bf16, W1A3 p=4 lut, calibrated as in phase 8) under live
    operations: (a) a prepared checkpoint saved and restored onto the card
    serves phase 8's requests with the tokens and launches of the in-memory
    tree's serve (the reference serve, ``out["ref"]``); (b) a ``LiveServer`` whose factory
    restores that checkpoint, killed at 3 waves, gives the undisturbed
    tokens, one host sync per wave on every attempt, and its request log
    replays them in a fresh server with 0 new waves; (c) a plan swap staged
    on a side stream while waves decode lands at a wave boundary with the
    same tokens, the launches split by route, and a drifting tree refused;
    (d) the chaos sweep over its five seams at a cut depth; (e) the grad
    refusal."""
    import shutil
    import threading

    import numpy as np

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core import LutLinearSpec
    from repro_torch.core.calibrate import calibrate_tree
    from repro_torch.ft.chaos import SEAMS, chaos_sweep
    from repro_torch.ft.supervisor import FailureInjector
    from repro_torch.models.model import build_model
    from repro_torch.serve.ops import LiveServer, SwapController
    from repro_torch.serve.serving import ServeEngine
    from repro_torch.tune import plan_model, verify_capacity
    from repro_torch.tune.plan import (map_quantized_leaves, param_fingerprint,
                                       quantized_leaf_items)

    out = {"grad_refusal": check_grad_refusal(torch, dev)}
    cfg = dataclasses.replace(cfg, n_layers=LIVE_LAYERS)
    model = build_model(cfg)
    spec = LutLinearSpec(mode="lut", **LUT_SPEC)
    shutil.rmtree(LIVE_DIR, ignore_errors=True)
    LIVE_DIR.mkdir(parents=True)
    ckdir = str(LIVE_DIR / "prepared")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    try:
        # --- (a) cold start from a prepared checkpoint ----------------------
        t0 = time.perf_counter()
        raw = model.init_quantized(spec, seed=0, device=dev)
        cal = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        tokens = torch.as_tensor(cal, device=dev)
        calibrated = calibrate_tree(lambda probed: model.forward(probed, tokens)[0], raw)
        del raw
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        prepared = model.prepare(calibrated, n_hint=4)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        leaves = ckpt._flatten(prepared, [])
        tree_bytes = sum(t.numel() * t.element_size() for t in leaves)
        t0 = time.perf_counter()
        step_dir = ckpt.save_prepared(ckdir, 0, prepared)
        save_s = time.perf_counter() - t0
        files = sorted(n for n in os.listdir(step_dir) if n.endswith(".npy"))
        disk = sum(npy_payload_bytes(os.path.join(step_dir, n)) for n in files)
        check(len(files) == len(leaves) and disk == tree_bytes,
              f"15a: {len(files)} leaf files holding {disk} B, the tree {len(leaves)} leaves of "
              f"{tree_bytes} B")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = ckpt.restore_prepared(ckdir, 0, device=dev,
                                         expect_fingerprint=param_fingerprint(prepared))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        back = ckpt._flatten(restored, [])
        check(len(back) == len(leaves) and all(
            a.dtype == b.dtype and a.device == b.device and a.shape == b.shape
            and bool(torch.equal(a, b)) for a, b in zip(leaves, back)),
            "15a: a restored tensor differs from the in-memory one (bits, dtype or device)")
        check([(p, l.spec, l.k, l.p) for p, l in quantized_leaf_items(prepared)]
              == [(p, l.spec, l.k, l.p) for p, l in quantized_leaf_items(restored)]
              and param_fingerprint(restored) == param_fingerprint(prepared),
              "15a: restored static fields or fingerprint differ")
        log(f"phase 15a [{smi}]: {cfg.name} {cfg.n_layers} layers W1A3 p=4 lut: initialized + "
            f"calibrated in {init_s:.1f} s, Model.prepare {prepare_s:.2f} s; prepared checkpoint "
            f"of {len(leaves)} leaves, {tree_bytes:,} B (= the bytes on disk after the .npy "
            f"headers): save {save_s:.2f} s ({tree_bytes / save_s / 1e9:.2f} GB/s), restore "
            f"onto the card {restore_s:.2f} s ({tree_bytes / restore_s / 1e9:.2f} GB/s, the "
            f"files just written: read from the page cache); every tensor bit-equal, same "
            f"dtype and device, fingerprint {param_fingerprint(restored)}")
        _lens, reqs8 = serve_requests(cfg, 64, 16)
        eng = ServeEngine(model, prepared, batch=4, max_seq=256, device=dev)
        eng.generate([dataclasses.replace(reqs8[0], prompt=reqs8[0].prompt[:16],
                                          max_new_tokens=2)])
        outs, _w, records, counts, _s = counted_generate(torch, eng, reqs8)
        out["ref"] = ref = dict(outs=outs, host_syncs=eng.host_syncs,
                                launches=counts["lut_stream_gemm"],
                                launches_tc=counts["lut_stream_gemm_tc"],
                                launches_canon=counts["lut_stream_gemm_canon"])
        del eng
        del prepared, leaves, back
        torch.cuda.empty_cache()
        eng = ServeEngine(model, restored, batch=4, max_seq=256, device=dev)
        eng.generate([dataclasses.replace(reqs8[0], prompt=reqs8[0].prompt[:16],
                                          max_new_tokens=2)])        # warmup
        outs, wall, records, counts, sync_warnings = counted_generate(torch, eng, reqs8)
        check_served(cfg, eng, outs, 16, records, counts, sync_warnings,
                     kernel="lut_stream_gemm", what="15a")
        digest = zlib.crc32(json.dumps([list(map(int, o)) for o in outs]).encode())
        check(outs == ref["outs"], f"15a: tokens (crc32 {digest:08x}) differ from the "
                                   f"reference serve's")
        want_counts = (ref["launches"], ref["launches_tc"], ref["launches_canon"])
        got_counts = (counts["lut_stream_gemm"], counts["lut_stream_gemm_tc"],
                      counts["lut_stream_gemm_canon"])
        check(got_counts == want_counts and counts["lut_stream_gemm_lookup"] == 0,
              f"15a: launches (all, tensor cores, canon) {got_counts} != the reference serve's "
              f"{want_counts}")
        out["a"] = dict(init_s=init_s, prepare_s=prepare_s, save_s=save_s, restore_s=restore_s,
                        tree_bytes=tree_bytes, restore_gb_s=tree_bytes / restore_s / 1e9,
                        leaves=len(files), tokens_crc32=digest, wall_s=wall,
                        launches=counts["lut_stream_gemm"],
                        launches_tc=counts["lut_stream_gemm_tc"],
                        launches_canon=counts["lut_stream_gemm_canon"])
        log(f"phase 15a: the restored tree served phase 8's requests with the in-memory tree's "
            f"tokens "
            f"(crc32 {digest:08x}) and launches {got_counts}, all on the tensor cores")

        # --- (b) kill + replay from the durable request log -----------------
        n_att, att_err = check_cached_attention(
            torch, cfg.n_layers, lambda: check_replay_identity(torch, dev, model, restored))
        log("phase 15b: 30 tokens prefilled behind a pad of 5 + 18 decoded one by one give the "
            "logits of one 48-token prefill behind a pad of 16, bit for bit (40 layers)")
        log(f"phase 15b: the cached attention of the first and last layers ({n_att} calls: "
            f"35- and 64-row prefills, 1-row decodes) is {att_err:.3e} x max |out| from "
            f"_attend with _key_mask in f32 (tolerance {TOL_FLASH_F32})")
        reqs = live_requests(cfg)
        want_eng = ServeEngine(model, restored, batch=4, max_seq=256, device=dev)
        want = want_eng.generate(reqs)
        check(want_eng.host_syncs == 5, f"15b: the undisturbed serve took {want_eng.host_syncs} "
                                        f"waves, the design 5")
        del eng, want_eng, restored
        torch.cuda.empty_cache()
        base_held = torch.cuda.memory_allocated(dev)      # the calibrated raw tree alone
        attempts, restores, restarts_at = [], [], []

        class CountedEngine(ServeEngine):
            """Each attempt's waves, host syncs and the serving thread's
            synchronizing calls (the LiveServer sets ``on_wave`` before
            calling generate)."""

            def generate(self, requests):
                recs, inner = [], self.on_wave
                self.on_wave = lambda r: (recs.append(r), inner(r))
                self.host_syncs = 0
                with ThreadSyncs(torch) as syncs:
                    try:
                        return super().generate(requests)
                    finally:
                        attempts.append(dict(
                            waves=len(recs), host_syncs=self.host_syncs,
                            syncs=syncs.on(threading.get_ident()),
                            prefills=sum(1 for r in recs if r.admitted),
                            steps=sum(r.steps for r in recs),
                            first_sync=recs[0].t_sync if recs else None))

        def factory():
            held = torch.cuda.memory_allocated(dev)
            check(held <= base_held + LIVE_HELD_SLACK,
                  f"15b: {held / 1e9:.2f} GB held when the factory runs, {base_held / 1e9:.2f} "
                  f"GB without a serving tree: the previous engine was not freed")
            t0 = time.perf_counter()
            tree = ckpt.restore_prepared(ckdir, 0, device=dev)
            torch.cuda.synchronize()
            restores.append(dict(seconds=time.perf_counter() - t0, held_before_gb=held / 1e9))
            return CountedEngine(model, tree, batch=4, max_seq=256, device=dev)

        log_path = str(LIVE_DIR / "serve.jsonl")
        inj = FailureInjector(fail_at_waves=LIVE_KILL_WAVES)
        srv = LiveServer(factory, log_path=log_path, injector=inj,
                         on_restart=lambda n, e: restarts_at.append(time.perf_counter()))
        reset_launches()
        t0 = time.perf_counter()
        got = srv.serve(reqs)
        live_wall = time.perf_counter() - t0
        live_counts = read_launches()
        check(sorted(w for _k, w in inj.fired) == list(LIVE_KILL_WAVES)
              and srv.restarts == len(LIVE_KILL_WAVES) and srv.rebuilds == len(LIVE_KILL_WAVES) + 1,
              f"15b: fired {sorted(inj.fired)}, restarts {srv.restarts}, rebuilds {srv.rebuilds}")
        check(got == want and not srv.quarantined and not srv.shed
              and all(len(o) == r.max_new_tokens for o, r in zip(got, reqs)),
              "15b: the killed serve's tokens differ from the undisturbed serve's, or a "
              "request was dropped")
        check(all(a["syncs"] == a["host_syncs"] == a["waves"] for a in attempts),
              f"15b: host syncs per attempt (serving thread, counted, waves): "
              f"{[(a['syncs'], a['host_syncs'], a['waves']) for a in attempts]}")
        calls = cfg.n_layers * sum(a["prefills"] + a["steps"] for a in attempts)
        check(live_counts["lut_stream_gemm"] == live_counts["lut_stream_gemm_tc"]
              == live_counts["lut_stream_gemm_canon"] == 7 * calls,
              f"15b: launches {live_counts} != 7 x {calls} calls, all on the tensor cores")
        to_first = [a["first_sync"] - t for a, t in zip(attempts[1:], restarts_at)]
        restore_list = ", ".join("%.2f" % r["seconds"] for r in restores)
        held_list = ", ".join("%.2f" % r["held_before_gb"] for r in restores)
        log(f"phase 15b [{smi}]: LiveServer killed at waves {list(LIVE_KILL_WAVES)} of its "
            f"attempts: {srv.restarts} restarts, {srv.rebuilds} engines restored from the "
            f"checkpoint ({restore_list} s; {held_list} GB held before each), 0 dropped, "
            f"tokens equal to the undisturbed serve's; waves per attempt "
            f"{[a['waves'] for a in attempts]}, one host sync a wave on the serving thread; "
            f"restart to first token {', '.join('%.2f' % x for x in to_first)} s; "
            f"{live_wall:.2f} s in all; lut_stream_gemm {live_counts['lut_stream_gemm']} "
            f"launches (tensor cores)")
        out["b"] = dict(restarts=srv.restarts, rebuilds=srv.rebuilds, kill_waves=LIVE_KILL_WAVES,
                        waves=[a["waves"] for a in attempts],
                        restore_s=[r["seconds"] for r in restores],
                        restart_to_first_token_s=to_first, wall_s=live_wall,
                        launches=live_counts["lut_stream_gemm"],
                        launches_tc=live_counts["lut_stream_gemm_tc"],
                        launches_canon=live_counts["lut_stream_gemm_canon"])
        srv.engine = None                 # its tree goes before the fresh server restores one
        replay_attempts = len(attempts)
        fresh = LiveServer(factory, log_path=log_path)
        check(fresh.serve(reqs) == want and fresh.engine.host_syncs == 0
              and fresh.rebuilds == 1 and len(attempts) == replay_attempts,
              "15b: the request log did not replay to the same tokens with 0 new waves")
        log("phase 15b: a fresh LiveServer over the same log replays every token, 0 new waves")
        tree_a = fresh.engine.params
        del srv, fresh
        torch.cuda.empty_cache()

        # --- (c) hot-swap under phase 13's 16 GiB plan -----------------------
        plan = plan_model(calibrated, lut_budget_bytes=16 << 30, n_hint=4, measure=False)
        check_plan_choices(plan, "15c")
        routes = plan_routes(plan)
        n_tc, n_lookup = (sum(r == w for r in routes.values()) for w in ("tc", "lookup"))
        drift = map_quantized_leaves(tree_a, lambda _p, leaf: dataclasses.replace(
            leaf, spec=dataclasses.replace(leaf.spec, bw=2)))
        eng = ServeEngine(model, tree_a, batch=4, max_seq=256, device=dev)
        ctl = SwapController(eng)
        wave_counts, flip = {}, {}
        waved, go = threading.Event(), threading.Event()

        def on_wave(rec):
            wave_counts[rec.wave] = read_launches()
            waved.set()
            if rec.wave == LIVE_FLIP_AFTER:
                # Hold this boundary until the operator's flip is parked at
                # the engine: it lands at the next one (a thread join and a
                # lock, no CUDA sync on this thread).
                go.set()
                while "error" not in flip and not ctl.status()["flip_pending"] \
                        and eng.swaps == 0:
                    time.sleep(0.001)

        def operator():
            try:
                staged = flip["staged"] = ctl.stage(qparams=calibrated, plan=plan)
                waved.wait()
                bad = ctl.stage(params=drift)
                try:
                    ctl.flip(bad, timeout=60)
                    flip["drift"] = "accepted"
                except ValueError as e:
                    flip["drift"] = str(e)[:160]
                flip["after_drift"] = (eng.params is tree_a, eng.swaps)
                go.wait()
                flip["report"] = ctl.flip(staged, timeout=900)
            except Exception as e:          # reported by the check after the serve
                flip["error"] = repr(e)

        eng.generate([dataclasses.replace(reqs[0], prompt=reqs[0].prompt[:16],
                                          max_new_tokens=2)])        # warmup
        op = threading.Thread(target=operator, daemon=True)
        records = []
        eng.on_wave = lambda r: (records.append(r), on_wave(r))
        eng.host_syncs = 0
        reset_launches()
        with ThreadSyncs(torch) as syncs:
            op.start()
            t0 = time.perf_counter()
            got = eng.generate(reqs)
            swap_wall = time.perf_counter() - t0
            op.join(900)
        final = read_launches()
        eng.on_wave = None          # its hook closes over eng: a reference cycle
        check("error" not in flip and not op.is_alive(), f"15c: the operator failed: {flip}")
        rep = flip["report"]
        check(flip["drift"].startswith("incompatible hot-swap refused")
              and "bw 1 -> 2" in flip["drift"] and flip["after_drift"] == (True, 0),
              f"15c: the drifting tree was not refused with the active tree untouched: {flip}")
        check(got == want, "15c: tokens across the swap differ from the undisturbed serve's")
        verify_capacity(eng.params, plan)
        check(eng.swaps == 1 and eng.last_swap_wave == LIVE_FLIP_AFTER + 1 == rep.wave
              and eng.params is flip["staged"].tree and flip["staged"].ready is not None,
              f"15c: swaps {eng.swaps}, landed at wave {eng.last_swap_wave}, want "
              f"{LIVE_FLIP_AFTER + 1}")
        serving = threading.get_ident()
        check(syncs.on(serving) == eng.host_syncs == len(records),
              f"15c: {syncs.on(serving)} synchronizing calls on the serving thread, "
              f"{len(records)} waves")
        before = [r for r in records if r.wave <= LIVE_FLIP_AFTER]
        after = [r for r in records if r.wave > LIVE_FLIP_AFTER]
        calls_before = cfg.n_layers * sum((1 if r.admitted else 0) + r.steps for r in before)
        calls_after = cfg.n_layers * sum((1 if r.admitted else 0) + r.steps for r in after)
        mid = wave_counts[LIVE_FLIP_AFTER]
        split = {"before": {k: mid[k] for k in ("lut_stream_gemm_tc", "lut_stream_gemm_lookup",
                                                "lut_stream_gemm_canon")},
                 "after": {k: final[k] - mid[k] for k in ("lut_stream_gemm_tc",
                                                          "lut_stream_gemm_lookup",
                                                          "lut_stream_gemm_canon")}}
        want_split = {"before": {"lut_stream_gemm_tc": 7 * calls_before,
                                 "lut_stream_gemm_lookup": 0,
                                 "lut_stream_gemm_canon": 7 * calls_before},
                      "after": {"lut_stream_gemm_tc": n_tc * calls_after,
                                "lut_stream_gemm_lookup": n_lookup * calls_after,
                                "lut_stream_gemm_canon": 7 * calls_after}}
        check(split == want_split and final["lut_stream_gemm"] ==
              final["lut_stream_gemm_tc"] + final["lut_stream_gemm_lookup"],
              f"15c: launches by route {split} != {want_split} (p = 4 before the flip; after "
              f"it {n_tc} projections on the tensor cores, {n_lookup} on the lookup route)")
        others = len(syncs.seen) - syncs.on(serving)
        log(f"phase 15c [{smi}]: plan swap staged on a side stream (stage {rep.stage_seconds:.2f} "
            f"s) while waves decoded, flip requested after wave {LIVE_FLIP_AFTER} landed at "
            f"wave {rep.wave} ({rep.flip_wait_seconds:.3f} s from the request); tokens equal; "
            f"launches by route {split}; {syncs.on(serving)} syncs on the serving thread "
            f"(one a wave), {others} on the stage / operator threads; the bw-drifting tree "
            f"refused, active tree untouched; {swap_wall:.2f} s in all")

        # Decode steps with a stage running on the side stream, and without.
        caches = eng._new_cache()
        tok = torch.randint(0, cfg.vocab_size, (4, 1), device=dev, dtype=torch.int32)
        pad = torch.zeros((4,), dtype=torch.int32, device=dev)
        pos = torch.full((4,), 128, dtype=torch.int32, device=dev)
        step = lambda: model.decode_step(eng.params, tok, caches, pos, pad_len=pad)
        step()

        def timed_step():
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            w0 = time.perf_counter()
            e0.record()
            step()
            e1.record()
            e1.synchronize()
            return time.perf_counter() - w0, e0.elapsed_time(e1)

        during = []
        for _ in range(LIVE_STAGES_TIMED):
            side = ctl.stage(qparams=calibrated, plan=plan)
            while side.running:
                during.append(timed_step())
            side.wait(900)
            del side
        quiet = [timed_step() for _ in range(max(5, len(during)))]
        mean = lambda xs, i: sum(x[i] for x in xs) / max(1, len(xs))
        out["c"] = dict(stage_s=rep.stage_seconds, flip_wave=rep.wave,
                        flip_wait_s=rep.flip_wait_seconds, wall_s=swap_wall, split=split,
                        drift_refused=flip["drift"][:80], serving_syncs=syncs.on(serving),
                        other_thread_syncs=others,
                        step_with_stage_ms=mean(during, 1), step_with_stage_wall_ms=1e3 * mean(during, 0),
                        step_quiet_ms=mean(quiet, 1), step_quiet_wall_ms=1e3 * mean(quiet, 0),
                        steps_during_stage=len(during),
                        launches=final["lut_stream_gemm"], launches_tc=final["lut_stream_gemm_tc"],
                        launches_lookup=final["lut_stream_gemm_lookup"],
                        launches_canon=final["lut_stream_gemm_canon"])
        log(f"phase 15c [{smi}]: decode step B=4 at 128 under the plan tree: "
            f"{out['c']['step_with_stage_ms']:.2f} ms on CUDA events "
            f"({out['c']['step_with_stage_wall_ms']:.2f} ms wall) over {len(during)} steps "
            f"while {LIVE_STAGES_TIMED} stages ran on the side stream one after another, "
            f"{out['c']['step_quiet_ms']:.2f} ms "
            f"({out['c']['step_quiet_wall_ms']:.2f} ms wall) without")
        del eng, ctl, caches, tree_a, drift, calibrated
        torch.cuda.empty_cache()

        # --- (d) the chaos sweep, depth cut --------------------------------
        cfg_d = dataclasses.replace(cfg, n_layers=LIVE_CHAOS_LAYERS)
        model_d = build_model(cfg_d)
        tree_d = model_d.prepare(model_d.init_quantized(spec, seed=0, device=dev), calibrate=cal,
                                 n_hint=4)
        t0 = time.perf_counter()
        rep_d = chaos_sweep(model=model_d, prepared=tree_d, requests=reqs,
                            workdir=str(LIVE_DIR / "chaos"), batch=4, max_seq=256,
                            points_per_seam=LIVE_CHAOS_POINTS, seed=0, device=dev)
        chaos_s = time.perf_counter() - t0
        check(rep_d["points"] == len(SEAMS) * LIVE_CHAOS_POINTS and rep_d["dropped"] == 0
              and rep_d["token_mismatches"] == 0 and rep_d["restarts"] > 0
              and all(r["fired"] for r in rep_d["results"])
              and rep_d["cold_fallbacks"] >= LIVE_CHAOS_POINTS,
              f"15d: chaos sweep {({k: v for k, v in rep_d.items() if k != 'results'})}, "
              f"points {[(r['seam'], r['point'], r['fired'], r['dropped'], r['token_mismatches']) for r in rep_d['results']]}")
        out["d"] = dict(layers=LIVE_CHAOS_LAYERS, seconds=chaos_s,
                        **{k: v for k, v in rep_d.items() if k != "results"},
                        rebuilds=sum(r["rebuilds"] for r in rep_d["results"]))
        log(f"phase 15d [{smi}]: chaos sweep at full width, {LIVE_CHAOS_LAYERS} layers (depth "
            f"cut), seams {list(SEAMS)} x {LIVE_CHAOS_POINTS} points: every fault fired, 0 "
            f"dropped, 0 token mismatches, {rep_d['restarts']} restarts, "
            f"{out['d']['rebuilds']} engines built, {rep_d['cold_fallbacks']} torn-checkpoint "
            f"fallbacks to the cold tree, {chaos_s:.1f} s")
        del tree_d
    finally:
        shutil.rmtree(LIVE_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 16: observability (repro_torch.obs) threaded through the serve path,
# the tuner and live ops, on phase 8's model
# ---------------------------------------------------------------------------

OBS_DIR = ROOT / "build" / "obs"   # git-ignored: the phase's Perfetto and metrics files
OBS_LIVE_LAYERS = LIVE_CHAOS_LAYERS   # 16c: depth of the traced LiveServer and swap (width
                                      # not cut), as phase 15d
OBS_MEASURED = ("wq", "w_up")   # 16b: the layers whose candidates a traced Measurer times
OBS_ROUNDS = 2                # 16a: rounds of (off, on, on, off) serves: the decode step's
                              # spread with the observer on and off, drift cancelled


def timed_observer():
    """A ``repro_torch.obs.Observer`` whose serve hooks' host time is summed
    here (a check of this script, not of the package), and whose ops spans
    note the thread that recorded them."""
    import threading

    from repro_torch.obs import Observer

    class TimedObserver(Observer):
        def __init__(self):
            super().__init__()
            self.hook_s = {"serve_begin": 0.0, "wave": 0.0, "serve_end": 0.0}
            self.hook_calls = dict.fromkeys(self.hook_s, 0)
            self.span_threads: dict = {}

        def _timed(self, name, fn, *args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.hook_s[name] += time.perf_counter() - t0
                self.hook_calls[name] += 1

        def serve_begin(self, *args, **kw):
            return self._timed("serve_begin", super().serve_begin, *args, **kw)

        def wave(self, *args, **kw):
            return self._timed("wave", super().wave, *args, **kw)

        def serve_end(self, *args, **kw):
            return self._timed("serve_end", super().serve_end, *args, **kw)

        def ops_span(self, name, *args, **kw):
            self.span_threads.setdefault(name, []).append(threading.get_ident())
            return super().ops_span(name, *args, **kw)

    return TimedObserver()


def decode_events(torch, eng):
    """Wrap ``eng._decode_wave`` (in this script) so that each wave's decode
    steps are bracketed by two CUDA events recorded on the serving stream;
    returns the list ``[(start, end, steps)]`` it fills.  The end event is
    recorded when the host has enqueued the wave's last step, so the span is
    the decode's wall time whichever of host and card is the slower."""
    spans, inner = [], eng._decode_wave

    def timed(token, caches, pos, pad, active, steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = inner(token, caches, pos, pad, active, steps)
        e1.record()
        spans.append((e0, e1, steps))
        return out

    eng._decode_wave = timed
    return spans


def step_ms(spans):
    """Decode wall per step (ms) over the recorded waves; read after a sync."""
    steps = sum(s for _a, _b, s in spans)
    return sum(a.elapsed_time(b) for a, b, _s in spans) / max(1, steps)


def trace_counts(obs, name_prefix):
    return sum(1 for e in obs.tracer.events() if e.name.startswith(name_prefix))


def check_coarse_trace(obs, reqs, what, *, waves):
    """The trace a serve leaves: ``waves`` wave spans and host_sync spans,
    one lifecycle span per request with its budget of tokens, nothing
    dropped, every request completed."""
    evs = obs.tracer.events()
    life = sorted((e for e in evs if e.name.endswith(" lifecycle")),
                  key=lambda e: e.args["request"])
    check(trace_counts(obs, "wave ") == waves and trace_counts(obs, "host_sync") == waves,
          f"{what}: {trace_counts(obs, 'wave ')} wave and {trace_counts(obs, 'host_sync')} "
          f"host_sync spans, want {waves} each")
    check([e.args["request"] for e in life] == list(range(len(reqs)))
          and all(e.args["tokens"] == r.max_new_tokens for e, r in zip(life, reqs)),
          f"{what}: lifecycle spans {[(e.args['request'], e.args['tokens']) for e in life]}")
    slo = obs.slo()
    check(obs.tracer.dropped == 0 and slo["completed"] == len(reqs),
          f"{what}: {obs.tracer.dropped} events dropped, {slo['completed']} of {len(reqs)} "
          f"completed")
    return slo


def slo_summary(slo):
    return {"ttft_p50_s": slo["ttft"]["p50_s"], "ttft_p99_s": slo["ttft"]["p99_s"],
            "tpot_p50_s": slo["tpot"]["p50_s"], "tpot_p99_s": slo["tpot"]["p99_s"],
            "queue_wait_p99_s": slo["queue_wait"]["p99_s"],
            "goodput_tok_s": slo["goodput"]["tokens_per_s"],
            "goodput_wall_s": slo["goodput"]["wall_s"]}


def phase_obs(torch, dev, cfg, smi, lserve=None):
    """Phase 16: ``repro_torch.obs`` on phase 15's model (stablelm-12b at full
    width, LIVE_LAYERS layers, seed 0, bf16, W1A3 p=4 lut, calibrated and
    prepared).
    (a) ``ServeEngine(obs=)`` serves phase 8's requests with the tokens, host
    syncs, admissions, buckets, launches and synchronizing calls of the
    untraced serve, and its trace holds every wave, sync and request; the
    Perfetto and metrics files load; the hooks' host time, the export time and
    the decode step with the observer on and off are logged.  (b) The chunked
    and loop drivers under phase 13's 16 GiB plan, traced: (a)'s tokens,
    one coarse record a chunk, the plan gauges; a traced ``Measurer`` over
    two full-width layers' candidates.  (c) At 4 layers: a traced
    ``LiveServer`` killed at wave 1 and its trace file, and a traced swap to
    the 16 GiB plan staged on a side stream.  (d) ``launch/serve.py --trace
    --metrics`` in-process.  ``lserve`` is phase 15's reference serve (None
    when the phase runs alone: the untraced serve here is the reference)."""
    import shutil
    import threading

    import numpy as np

    from repro_torch.core import LutLinearSpec
    from repro_torch.core.calibrate import calibrate_tree
    from repro_torch.ft.supervisor import FailureInjector
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import build_model
    from repro_torch.obs import Observer, scrape_engine, write_metrics_jsonl, write_perfetto
    from repro_torch.serve.ops import LiveServer, SwapController
    from repro_torch.serve.serving import ServeEngine
    from repro_torch.tune import Measurer, plan_model, space, verify_capacity
    from repro_torch.tune.measure import sample_activations
    from repro_torch.tune.plan import quantized_leaf_items
    from repro_torch.tune.planner import _unit_slice

    cfg = dataclasses.replace(cfg, n_layers=LIVE_LAYERS)
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    OBS_DIR.mkdir(parents=True)
    out = {}
    model = build_model(cfg)
    spec = LutLinearSpec(mode="lut", **LUT_SPEC)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cal = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    tokens = torch.as_tensor(cal, device=dev)
    calibrated = calibrate_tree(lambda probed: model.forward(probed, tokens)[0],
                                model.init_quantized(spec, seed=0, device=dev))
    prepared = model.prepare(calibrated, n_hint=4)
    torch.cuda.synchronize()
    log(f"phase 16 [{smi}]: {cfg.name} {cfg.n_layers} layers W1A3 p=4 lut, calibrated and "
        f"prepared in {time.perf_counter() - t0:.1f} s")

    # --- (a) tracing is invisible ----------------------------------------------
    _lens, reqs = serve_requests(cfg, 64, 16)
    eng_off = ServeEngine(model, prepared, batch=4, max_seq=256, device=dev)
    eng_on = ServeEngine(model, prepared, batch=4, max_seq=256, obs=timed_observer(),
                         device=dev)
    eng_off.generate([dataclasses.replace(reqs[0], prompt=reqs[0].prompt[:16],
                                          max_new_tokens=2)])          # warmup
    torch.cuda.synchronize()
    runs = []
    for eng in (eng_off, eng_on, eng_on, eng_off) * OBS_ROUNDS:
        if eng is eng_on:
            eng.obs = timed_observer()                # a fresh observer a run
        eng.bucket_counts = {}
        spans = decode_events(torch, eng)
        outs, wall, records, counts, sync_warnings = counted_generate(torch, eng, reqs)
        del eng._decode_wave
        check_served(cfg, eng, outs, 16, records, counts, sync_warnings,
                     kernel="lut_stream_gemm", what="16a")
        runs.append(dict(obs=eng.obs, outs=outs, wall_s=wall, waves=len(records),
                         host_syncs=eng.host_syncs, admissions=list(eng.admissions),
                         bucket_counts=dict(eng.bucket_counts), sync_warnings=sync_warnings,
                         counts={k: counts[k] for k in ("lut_stream_gemm", "lut_stream_gemm_tc",
                                                        "lut_stream_gemm_canon")},
                         step_ms=step_ms(spans), steps=sum(s for _a, _b, s in spans)))
    off = runs[0]
    fields = ("outs", "host_syncs", "admissions", "bucket_counts", "counts", "sync_warnings")
    for i, r in enumerate(runs[1:], 1):
        diff = [f for f in fields if r[f] != off[f]]
        check(not diff, f"16a: run {i} ({'on' if r['obs'] else 'off'}) differs from the "
                        f"untraced serve in {diff}")
    if lserve is not None:
        check(off["outs"] == lserve["outs"] and off["host_syncs"] == lserve["host_syncs"]
              and off["counts"]["lut_stream_gemm"] == lserve["launches"]
              and off["counts"]["lut_stream_gemm_canon"] == lserve["launches_canon"],
              "16a: the untraced serve differs from phase 15's reference serve (tokens, syncs "
              "or launches)")
    want = off["outs"]
    obs = runs[1]["obs"]
    slo = check_coarse_trace(obs, reqs, "16a", waves=off["host_syncs"])
    t0 = time.perf_counter()
    tpath = write_perfetto(obs, str(OBS_DIR / "serve_trace.json"))
    mpath = write_metrics_jsonl(obs, str(OBS_DIR / "serve_metrics.jsonl"))
    export_s = time.perf_counter() - t0
    with open(tpath) as f:
        n_json = len(json.load(f)["traceEvents"])
    with open(mpath) as f:
        recs = [json.loads(ln) for ln in f]
    check(n_json > len(obs.tracer) and [r["t"] for r in recs[:2]] == ["snapshot", "slo"]
          and sum(r["t"] == "request" for r in recs) == len(reqs),
          f"16a: reloaded files: {n_json} trace events for {len(obs.tracer)} recorded, "
          f"metrics records {[r['t'] for r in recs]}")
    on_runs = [r for r in runs if r["obs"] is not None]
    off_runs = [r for r in runs if r["obs"] is None]
    hooks = [r["obs"].hook_s for r in on_runs]
    median = lambda xs: sorted(xs)[len(xs) // 2]
    out["a"] = dict(
        tokens_crc32=zlib.crc32(json.dumps([list(map(int, o)) for o in want]).encode()),
        host_syncs=off["host_syncs"], waves=off["waves"], launches=off["counts"],
        events=len(obs.tracer), trace_bytes=os.path.getsize(tpath),
        metrics_bytes=os.path.getsize(mpath), export_s=export_s,
        hook_wave_ms=[1e3 * h["wave"] / r["waves"] for h, r in zip(hooks, on_runs)],
        hook_serve_begin_ms=[1e3 * h["serve_begin"] for h in hooks],
        hook_serve_end_ms=[1e3 * h["serve_end"] for h in hooks],
        step_ms={"off": [r["step_ms"] for r in off_runs], "on": [r["step_ms"] for r in on_runs]},
        wall_s={"off": [r["wall_s"] for r in off_runs], "on": [r["wall_s"] for r in on_runs]},
        decode_steps=off["steps"], slo=slo_summary(slo))
    fmt = lambda xs, f: " / ".join(f % x for x in xs)
    a = out["a"]
    log(f"phase 16a [{smi}]: tracing is invisible: tokens (crc32 {a['tokens_crc32']:08x}), "
        f"{off['host_syncs']} host syncs, admissions, buckets {off['bucket_counts']}, launches "
        f"{off['counts']} and {len(off['sync_warnings'])} sync-debug warnings equal with the "
        f"observer on ({len(on_runs)} serves) and off ({len(off_runs)}); trace: {a['events']} "
        f"events (0 dropped), "
        f"{a['trace_bytes']:,} B Perfetto + {a['metrics_bytes']:,} B metrics JSONL, written in "
        f"{1e3 * export_s:.2f} ms and reloaded")
    log(f"phase 16a [{smi}]: host time in the Observer's hooks: wave "
        f"{fmt(a['hook_wave_ms'], '%.3f')} ms a wave, serve_begin "
        f"{fmt(a['hook_serve_begin_ms'], '%.3f')} ms, serve_end "
        f"{fmt(a['hook_serve_end_ms'], '%.3f')} ms")
    log(f"phase 16a [{smi}]: decode step wall (CUDA events, {off['steps']} steps a serve, "
        f"serves in the order (off, on, on, off) x {OBS_ROUNDS}): off "
        f"{fmt(a['step_ms']['off'], '%.2f')} ms (median {median(a['step_ms']['off']):.2f}), on "
        f"{fmt(a['step_ms']['on'], '%.2f')} ms (median {median(a['step_ms']['on']):.2f}); serve "
        f"wall off {fmt(a['wall_s']['off'], '%.3f')} s, on {fmt(a['wall_s']['on'], '%.3f')} s")
    log(f"phase 16a [{smi}]: the observer's SLOs: TTFT p50 {slo['ttft']['p50_s']:.4f} s p99 "
        f"{slo['ttft']['p99_s']:.4f} s, TPOT p50 {slo['tpot']['p50_s']:.6f} s p99 "
        f"{slo['tpot']['p99_s']:.6f} s, queue wait p99 {slo['queue_wait']['p99_s']:.4f} s, "
        f"goodput {slo['goodput']['tokens_per_s']:.2f} tok/s over "
        f"{slo['goodput']['wall_s']:.3f} s")
    del eng_off, eng_on, runs, prepared
    torch.cuda.empty_cache()

    # --- (b) the chunked and loop drivers under the 16 GiB plan; the tuner ------
    plan = plan_model(calibrated, lut_budget_bytes=16 << 30, n_hint=4, measure=False)
    check_plan_choices(plan, "16b")
    routes = plan_routes(plan)
    n_tc, n_lookup = (sum(r == w for r in routes.values()) for w in ("tc", "lookup"))
    out["b"] = {}
    for decode in ("chunked", "loop"):
        what = f"16b ({decode}, 16 GiB plan)"
        eng = ServeEngine(model, calibrated, batch=4, max_seq=256, decode=decode, plan=plan,
                          obs=Observer(), device=dev)
        eng.generate([dataclasses.replace(reqs[0], prompt=reqs[0].prompt[:16],
                                          max_new_tokens=2)])          # warmup
        eng.obs = Observer()                          # the counted serve's own
        outs, wall, _records, counts, sync_warnings = counted_generate(torch, eng, reqs)
        chunks, steps = chunk_calls(reqs, eng.batch, eng.max_seq)
        syncs = chunks if decode == "chunked" else sum(
            max(r.max_new_tokens for r in reqs[s : s + 4]) for s in range(0, len(reqs), 4))
        check(outs == want, f"{what}: tokens differ from the untraced serve's")
        verify_capacity(eng.params, plan)
        check(eng.host_syncs == syncs == len(sync_warnings),
              f"{what}: {eng.host_syncs} host syncs, {len(sync_warnings)} synchronizing calls, "
              f"want {syncs}")
        calls = cfg.n_layers * (chunks + steps)
        got = {k: counts[k] for k in ("lut_stream_gemm_tc", "lut_stream_gemm_lookup",
                                      "lut_stream_gemm_canon")}
        check(got == {"lut_stream_gemm_tc": n_tc * calls, "lut_stream_gemm_lookup":
                      n_lookup * calls, "lut_stream_gemm_canon": 7 * calls},
              f"{what}: launches {got}, want {n_tc} / {n_lookup} / 7 x {calls}")
        bslo = check_coarse_trace(eng.obs, reqs, what, waves=chunks)
        scraped = scrape_engine(eng)["plan"]
        modes, ps = {}, {}
        for lp in plan.layers.values():
            modes[lp.mode] = modes.get(lp.mode, 0) + 1
            ps[str(lp.p)] = ps.get(str(lp.p), 0) + 1
        gauges = eng.obs.metrics.snapshot()["gauges"]
        check(scraped == dict(layers=len(plan.layers), budget_bytes=plan.budget_bytes,
                              total_bytes=plan.total_bytes, modes=modes, p=ps)
              and gauges["plan_layers"] == len(plan.layers)
              and gauges["plan_total_bytes"] == plan.total_bytes,
              f"{what}: plan gauges {scraped}, {gauges} against the plan's layers")
        out["b"][decode] = dict(host_syncs=eng.host_syncs, wall_s=wall, launches=got,
                                plan=scraped, slo=slo_summary(bslo))
        log(f"phase 16b [{smi}]: {what}: (a)'s tokens, {eng.host_syncs} host syncs (= "
            f"synchronizing calls), {chunks} coarse wave records, launches {got}; plan gauges "
            f"{scraped}; {wall:.2f} s; TTFT p50 {bslo['ttft']['p50_s']:.3f} s, goodput "
            f"{bslo['goodput']['tokens_per_s']:.2f} tok/s")
        del eng
        torch.cuda.empty_cache()
    tobs = Observer()
    meas = Measurer(cache={}, obs=tobs)
    leaves = dict(quantized_leaf_items(calibrated))
    n_cands = 0
    t0 = time.perf_counter()
    for name in OBS_MEASURED:
        q = next(lf for path, lf in leaves.items() if path.endswith("/" + name))
        unit = _unit_slice(q)
        f, k = int(unit.codes.shape[-2]), unit.k
        cands = space.layer_candidates(f, k, n_hint=4, base_spec=q.spec, stack=cfg.n_layers,
                                       servable_only=True)
        x = sample_activations(k, 128, device=dev)
        for _repeat in range(2):                      # the second pass hits the cache
            for c in cands:
                meas.measure(unit, x, c)
        n_cands += len(cands)
    meas_s = time.perf_counter() - t0
    counters = tobs.metrics.snapshot()["counters"]
    spans = [e for e in tobs.tracer.events() if e.cat == "tune"]
    check(counters["tune_measure_misses"] == meas.misses == n_cands
          and counters["tune_measure_hits"] == meas.hits == n_cands
          and len(spans) == n_cands and all(e.track == "tune.measure" and e.ph == "X"
                                            for e in spans),
          f"16b: Measurer counters {counters}, misses {meas.misses}, hits {meas.hits}, "
          f"{len(spans)} tune spans, {n_cands} candidates")
    out["b"]["measurer"] = dict(candidates=n_cands, seconds=meas_s,
                                span_us={e.name: e.args["us"] for e in spans})
    log(f"phase 16b [{smi}]: a traced Measurer over {n_cands} candidates of {OBS_MEASURED} "
        f"(full width, N=128): {meas.misses} misses, {meas.hits} hits (the repeats), "
        f"{len(spans)} tune spans on tune.measure; {meas_s:.1f} s")
    del calibrated, leaves, unit, x
    torch.cuda.empty_cache()

    # --- (c) live ops traced, depth cut ------------------------------------------
    cfg_d = dataclasses.replace(cfg, n_layers=OBS_LIVE_LAYERS)
    model_d = build_model(cfg_d)
    cal_d = calibrate_tree(lambda probed: model_d.forward(probed, tokens)[0],
                           model_d.init_quantized(spec, seed=0, device=dev))
    tree_d = model_d.prepare(cal_d, n_hint=4)
    lreqs = live_requests(cfg)
    want_d = ServeEngine(model_d, tree_d, batch=4, max_seq=256, device=dev).generate(lreqs)
    attempts = []

    class CountedEngine(ServeEngine):
        """Each attempt's waves, host syncs and the serving thread's
        synchronizing calls."""

        def generate(self, requests):
            recs, inner = [], self.on_wave
            self.on_wave = lambda r: (recs.append(r), inner(r))
            self.host_syncs = 0
            with ThreadSyncs(torch) as syncs:
                try:
                    return super().generate(requests)
                finally:
                    attempts.append((len(recs), self.host_syncs,
                                     syncs.on(threading.get_ident())))

    lobs = timed_observer()
    live_path = OBS_DIR / "live.json"
    srv = LiveServer(lambda: CountedEngine(model_d, tree_d, batch=4, max_seq=256, device=dev),
                     log_path=str(OBS_DIR / "serve.jsonl"), obs=lobs, trace_path=str(live_path),
                     injector=FailureInjector(fail_at_waves=(1,)))
    got = srv.serve(lreqs)
    check(got == want_d and srv.restarts == 1 and not srv.quarantined and not srv.shed,
          f"16c: the traced, killed LiveServer gave other tokens or {srv.restarts} restarts")
    check(all(w == h == s for w, h, s in attempts),
          f"16c: (waves, host syncs, serving-thread syncs) per attempt {attempts}")
    with open(live_path) as f:
        levs = json.load(f)["traceEvents"]
    tid = next(e["tid"] for e in levs if e["ph"] == "M" and e["args"]["name"] == "supervisor")
    sup_names = {e["name"] for e in levs if e.get("tid") == tid and e["ph"] != "M"}
    tmp_left = [p.name for p in OBS_DIR.iterdir() if ".tmp." in p.name]
    check({"restart", "replay"} <= sup_names and not tmp_left,
          f"16c: supervisor events in the trace file {sorted(sup_names)}, tmp files {tmp_left}")
    plan_d = plan_model(cal_d, lut_budget_bytes=16 << 30, n_hint=4, measure=False)
    check_plan_choices(plan_d, "16c")
    sobs = timed_observer()
    eng = ServeEngine(model_d, tree_d, batch=4, max_seq=256, obs=sobs, device=dev)
    ctl = SwapController(eng, obs=sobs)
    flip, waved = {}, threading.Event()

    def on_wave(rec):
        if rec.wave == 0:
            # Hold the boundary until the operator's flip is parked: it lands
            # at wave 1 (a lock and a thread join, no CUDA sync here).
            waved.set()
            while "error" not in flip and not ctl.status()["flip_pending"] and eng.swaps == 0:
                time.sleep(0.001)

    def operator():
        try:
            staged = ctl.stage(qparams=cal_d, plan=plan_d)
            waved.wait(600)
            flip["report"] = ctl.flip(staged, timeout=600)
        except Exception as e:                        # reported by the check below
            flip["error"] = repr(e)

    records = []
    eng.on_wave = lambda r: (records.append(r), on_wave(r))
    op = threading.Thread(target=operator, daemon=True)
    with ThreadSyncs(torch) as syncs:
        op.start()
        got = eng.generate(lreqs)
        op.join(600)
    eng.on_wave = None              # its hook closes over eng: a reference cycle
    serving = threading.get_ident()
    stage_threads = sobs.span_threads.get("swap stage", [])
    check("error" not in flip and not op.is_alive() and got == want_d and eng.swaps == 1
          and eng.last_swap_wave == 1, f"16c: swap {flip}, swaps {eng.swaps} at wave "
                                       f"{eng.last_swap_wave}, tokens equal {got == want_d}")
    check(trace_counts(sobs, "swap stage") == 1 and trace_counts(sobs, "swap flip") == 1
          and len(stage_threads) == 1 and stage_threads[0] not in (serving, op.ident),
          f"16c: {trace_counts(sobs, 'swap stage')} stage / {trace_counts(sobs, 'swap flip')} "
          f"flip spans; the stage span recorded on the serving or operator thread")
    check(syncs.on(serving) == eng.host_syncs == len(records),
          f"16c: {syncs.on(serving)} synchronizing calls on the serving thread, "
          f"{eng.host_syncs} host syncs, {len(records)} waves")
    rep = flip["report"]
    out["c"] = dict(layers=OBS_LIVE_LAYERS, attempts=attempts, live_trace_events=len(levs),
                    supervisor_events=sorted(sup_names), stage_s=rep.stage_seconds,
                    flip_wait_s=rep.flip_wait_seconds, flip_wave=rep.wave,
                    swap_spans={e.name: e.dur for e in sobs.tracer.events() if e.track == "swap"})
    log(f"phase 16c [{smi}]: {OBS_LIVE_LAYERS} layers: a traced LiveServer killed at wave 1 gave "
        f"the undisturbed tokens, (waves, syncs, serving-thread syncs) per attempt {attempts}; "
        f"its trace file ({len(levs)} events) loads with {sorted(sup_names)} on the supervisor "
        f"track, no tmp file left; a traced swap to the 16 GiB plan, staged on a side stream "
        f"({rep.stage_seconds:.2f} s, its span recorded on the stage's thread), flipped at wave "
        f"{rep.wave} ({rep.flip_wait_seconds:.3f} s), tokens equal, one sync a wave on the "
        f"serving thread")
    del eng, ctl, srv, tree_d, cal_d, model_d
    torch.cuda.empty_cache()

    # --- (d) the launcher ---------------------------------------------------------
    ltrace, lmetrics = OBS_DIR / "launch_trace.json", OBS_DIR / "launch_metrics.jsonl"
    louts = launch_serve.main(["--smoke", "--mode", "lut", "--calibrate", "32",
                               "--trace", str(ltrace), "--metrics", str(lmetrics)])
    with open(ltrace) as f:
        n_life = sum(1 for e in json.load(f)["traceEvents"] if e["name"].endswith(" lifecycle"))
    with open(lmetrics) as f:
        lslo = [json.loads(ln) for ln in f][1]
    check(n_life == len(louts) and lslo["t"] == "slo" and lslo["completed"] == len(louts),
          f"16d: launch/serve.py --trace --metrics: {n_life} lifecycle spans, slo {lslo}")
    out["d"] = dict(requests=len(louts), trace_bytes=os.path.getsize(ltrace),
                    metrics_bytes=os.path.getsize(lmetrics))
    log(f"phase 16d: launch/serve.py --smoke --mode lut --calibrate 32 --trace --metrics on "
        f"the card: both files load ({n_life} lifecycle spans, {lslo['completed']} completed)")
    return out


# ---------------------------------------------------------------------------
# Phase 17: deepseek-v2-lite-16b whole (MoE + multi-head latent attention)
# ---------------------------------------------------------------------------

DEEPSEEK = "deepseek-v2-lite-16b"
DS_MAX_SEQ = 512              # 17a / 17c: ServeEngine(batch=4, max_seq=512)
DS_NEW = 32                   # new tokens a request
DS_PROMPT = 128               # the longest prompt, and the timed prefill's length
DS_CHUNKED_SEQ = 4608         # 17b: one row through MLA's chunked branch (> 4096, % 512 == 0)
DS_LUT_LAYERS = 4             # 17c: depth cut to 1 "F" + 3 "D" units
DS_SERVE_LAYERS = 4           # 17: depth (of 27: 1 "F" + 3 "D"), to keep the script
                              # in its time limit (each check holds at any depth)
TOL_MLA_CHUNKED = 2e-4        # 17b: chunked vs unchunked latent attention (f32), relative to
                              # max |y|: the same per-row sums, in other GEMM shapes
TOL_CPU_DS = 1e-4             # 17d: card vs CPU logits (f32, 2 layers), relative to max |logit|


def applied_projections(params, *, frames=False):
    """The quantized projections one forward applies, counted from the tree:
    every quantized leaf times its stack, except MLA's absorbed ``W_kup`` /
    ``W_vup`` (decoded, never applied) and the MoE expert stacks (decoded for
    the batched expert GEMMs); a MoE block's shared experts are applied; a
    leaf of zamba2's shared block (``shared_attn``, one copy in the tree) is
    applied once per ``"S"`` sublayer (counted by their stacked Mamba2
    ``in_proj`` leaves).  On an encoder-decoder tree a forward without
    frames (``ServeEngine``'s, a decode step) applies neither the encoder's
    leaves nor the cross blocks' ``wk`` / ``wv`` (the cross keys and values
    come from the cache); a forward over frames (``frames=True``: a prefill
    or a cache-free forward with ``prefix_embeds``) applies them too.
    Returns ``(count, {leaf path: (count, K, F)})``."""
    from repro_torch.tune.plan import quantized_leaf_items

    by_path = {}
    for path, leaf in quantized_leaf_items(params):
        parts = path.split("/")
        if parts[-1] in ("w_kup", "w_vup") or ("moe" in parts and "shared" not in parts):
            continue
        if not frames and (parts[0] == "encoder" or parts[-2:] in (["cross", "wk"],
                                                                   ["cross", "wv"])):
            continue
        by_path[path] = (leaf.codes.shape[0] if leaf.codes.ndim == 3 else 1, leaf.k, leaf.f)
    n_shared = sum(n for path, (n, _k, _f) in by_path.items()
                   if path.split("/")[-3].endswith("_S") and path.endswith("ssm/in_proj"))
    for path, (_n, k, f) in by_path.items():
        if path.startswith("shared_attn/"):
            by_path[path] = (n_shared, k, f)
    return sum(n for n, _k, _f in by_path.values()), by_path


def projection_shapes(params):
    """``{name: (K, F)}``: each distinct shape among the applied projections
    (:func:`applied_projections`) once, named by the last two parts of the
    paths that have it."""
    names = {}
    for path, (_n, k, f) in applied_projections(params)[1].items():
        names.setdefault((k, f), []).append("/".join(path.split("/")[-2:]))
    return {"+".join(dict.fromkeys(ns)): kf for kf, ns in names.items()}


def bucket_led_requests(cfg):
    """Phases 17 and 18's 8 requests: prompts of 16-128 tokens from ``default_rng(0)``,
    the first of each group of 4 (one wave, one chunk) exactly DS_PROMPT
    tokens, so the continuous and chunked drivers' prompt bucket and the loop
    driver's exact length agree (the MoE capacity follows the prefill's token
    count); DS_NEW new tokens each."""
    from repro_torch.serve.serving import Request
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(16, DS_PROMPT + 1, 8)
    lens[0] = lens[4] = DS_PROMPT
    return lens, [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                          max_new_tokens=DS_NEW) for n in lens]


def deepseek_regions():
    """Phase 17's profiler regions, ``(module, function, label)``: the
    expert stacks' dequantization (``models.model.maybe_dequant``, which
    ``moe_apply`` imports at each call), the routing (``moe._route``), the
    dispatch and combine around the expert GEMMs (``moe._dispatch_compute``)
    and the latent attention (``attention._latent_attend``).  The expert
    GEMMs are the ``aten::bmm`` ops inside the dispatch range
    (:func:`region_of`)."""
    from repro_torch.models import attention, model, moe

    return ((model, "maybe_dequant", "expert dequant"), (moe, "_route", "moe routing"),
            (moe, "_dispatch_compute", "moe dispatch+combine"),
            (attention, "_latent_attend", "latent attention"))


def zamba2_regions():
    """Phase 18's profiler regions: the SSD recurrence (each step of
    ``ssm._step``), the causal conv (``ssm._causal_conv``) and the shared
    block's cached attention (``attention._attend_cache_invariant``)."""
    from repro_torch.models import attention, ssm

    return ((ssm, "_step", "ssd recurrence"), (ssm, "_causal_conv", "causal conv"),
            (attention, "_attend_cache_invariant", "shared attention"))


class _RegionLabels:
    """Label a phase's regions (``(module, function, label)``, e.g.
    :func:`deepseek_regions`) with torch.profiler ranges while it records (a
    check of this script; the port has no such hooks)."""

    def __init__(self, torch, labels):
        self.torch, self.modules = torch, labels

    def __enter__(self):
        rf = self.torch.profiler.record_function
        self.saved = [getattr(mod, name) for mod, name, _label in self.modules]
        for (mod, name, label), fn in zip(self.modules, self.saved):
            def wrapped(*args, _fn=fn, _label=label, **kw):
                with rf(_label):
                    return _fn(*args, **kw)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for (mod, name, _label), fn in zip(self.modules, self.saved):
            setattr(mod, name, fn)
        return False


def region_names(labels):
    """The regions of ``labels``; with the MoE dispatch range, also the
    expert bmm inside it."""
    names = [label for _mod, _name, label in labels]
    if "moe dispatch+combine" in names:
        names.insert(1, "expert bmm")
    return tuple(names)


def region_of(event, names):
    """The region (of ``names``) of a profiled host event: its innermost
    enclosing :class:`_RegionLabels` range, read as "expert bmm" where an
    ``aten::bmm`` lies between the event and the dispatch range; ``None``
    outside every range."""
    bmm = False
    while event is not None:
        if event.name == "aten::bmm":
            bmm = True
        if event.name in names:
            return "expert bmm" if bmm and event.name == "moe dispatch+combine" else event.name
        event = event.cpu_parent
    return None


def region_breakdown(torch, fn, iters, wall_ms, *, kernel, card, what, labels):
    """Device time of one call of ``fn`` by region (:class:`_RegionLabels`),
    beside ``kernel``'s time, the busy time and the idle share against
    ``wall_ms``, from torch.profiler over ``iters`` calls after a warmup
    call; logs it and returns it, or ``None`` when the profiler saw no
    device time.  Each device kernel counts once, in the region of the host
    event that launched it (:func:`region_of`), so the regions, ``kernel``
    and the rest partition the busy time; each region's copy kernels (casts)
    and the ``flash_attention`` kernel's time are returned beside them.
    Fails where a region reads 0 or the rest is negative."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = region_names(labels)
    with _RegionLabels(torch, labels):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    busy = ours = ours_n = 0.0
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key in names:
            continue                   # host events; the ranges' device-side spans
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        ms = us / 1e3 / iters
        busy += ms
        by_name[e.key] = by_name.get(e.key, 0.0) + ms
        if kernel in e.key:
            ours += ms
            ours_n += e.count / iters
    if busy <= 0:
        log(f"  {what}: device time by region not measured (the profiler saw no device time)")
        return None
    regions = dict.fromkeys(names, 0.0)
    copies = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        region = region_of(e, names)
        if region is not None:
            for k in e.kernels:
                if kernel not in k.name:
                    regions[region] += k.duration / 1e3 / iters
                    if "copy" in k.name.lower():
                        copies[region] += k.duration / 1e3 / iters
    out = dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1 - busy / wall_ms, kernel_ms=ours,
               kernel_launches=ours_n, regions_ms=regions, region_copy_ms=copies,
               flash_ms=sum(ms for n, ms in by_name.items() if "flash_attention" in n),
               other_ms=busy - ours - sum(regions.values()),
               top=[(name, ms) for ms, name in sorted(((ms, n) for n, ms in by_name.items()),
                                                      reverse=True)[:8]])
    log(f"  {what} [{card}]: device busy {busy:.2f} of {wall_ms:.2f} ms (idle share "
        f"{out['idle_share']:.3f}); {kernel} {ours:.2f} ms in {ours_n:.0f} launches; "
        + "; ".join(f"{k} {v:.2f} ms" for k, v in regions.items())
        + f"; the rest {out['other_ms']:.2f} ms; largest device ops:")
    for name, ms in out["top"]:
        log(f"    {ms:8.3f} ms  {name[:100]}")
    check(all(v > 0 for v in regions.values()),
          f"{what}: a region read no device time: {regions} (a renamed function of the port?)")
    check(out["other_ms"] >= -1e-6 * busy,
          f"{what}: the regions and {kernel} add up to more than the busy time ({busy:.3f} ms)")
    return out


HELD_SLACK = 1 << 26          # phases 17-18: what gc.collect() may free on the card before a
                              # build (64 MB): earlier phases leave no tree in a reference cycle


def _cycle_owner(o):
    """The qualified name of a function, or of an object's class, defined in
    the port or in this script; ``None`` for anything else."""
    fn = isinstance(o, types.FunctionType)
    mod = o.__module__ if fn else type(o).__module__
    if mod == "__main__" or str(mod).startswith("repro_torch"):
        return o.__qualname__ if fn else type(o).__qualname__
    return None


def held_before_build(torch, dev, what):
    """What the card holds before a phase builds its model, logged: the
    bytes allocated, then the CUDA tensors that ``gc.collect()`` finds only
    in reference cycles (and the functions and objects of the port and of
    this script among the cycles), then the bytes allocated after the
    collect.  Fails where the collect frees more than :data:`HELD_SLACK`:
    each phase's memory must be its own without a collect.  Returns the bytes
    held after the collect."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        cyclic = {}
        for o in gc.garbage:
            if type(o) in (torch.Tensor, torch.nn.Parameter) and o.is_cuda:
                st = o.untyped_storage()
                cyclic[st.data_ptr()] = st.nbytes()
        owners = sorted({name for name in map(_cycle_owner, gc.garbage) if name})
    finally:
        gc.garbage.clear()
        gc.set_debug(0)
    gc.collect()
    torch.cuda.empty_cache()
    after, referenced, n_storages, largest = held_on_card(torch, dev)
    log(f"{what}: held on the card before the build (what earlier phases left): "
        f"{before / 1e9:.3f} GB allocated, {after / 1e9:.3f} GB after gc.collect(); "
        f"{len(cyclic)} CUDA storages ({sum(cyclic.values()) / 1e9:.3f} GB) only in reference "
        f"cycles, among them objects of {owners[:12]}; {n_storages} CUDA storages referenced "
        f"from Python, {referenced / 1e9:.2f} GB, the largest "
        f"{[(f'{n / 1e9:.2f} GB', shape, dt) for n, shape, dt in largest]}")
    check(before - after <= HELD_SLACK,
          f"{what}: gc.collect() freed {(before - after) / 1e9:.3f} GB on the card: an earlier "
          f"phase left a tree in a reference cycle ({owners[:12]})")
    return before, after


def held_on_card(torch, dev, top=3):
    """What the card holds: ``torch.cuda.memory_allocated`` and the CUDA
    tensors the Python heap still references, each storage once: ``(allocated
    bytes, referenced bytes, storages, the largest top as (bytes, shape,
    dtype))``.  Tensor subclasses (torch.compile's fake and functional
    tensors) own no device memory and are not counted."""
    storages = {}
    for o in gc.get_objects():
        if type(o) in (torch.Tensor, torch.nn.Parameter) and o.is_cuda:
            st = o.untyped_storage()
            storages[st.data_ptr()] = (st.nbytes(), tuple(o.shape), str(o.dtype))
    return (torch.cuda.memory_allocated(dev), sum(n for n, _s, _d in storages.values()),
            len(storages), sorted(storages.values(), reverse=True)[:top])


def drivers_agree(torch, dev, cfg, n_layers, reqs, what):
    """``decode="scan"``, ``"loop"`` and ``"chunked"`` serve ``reqs`` (each
    wave led by a bucket) to the same tokens on a copy of ``cfg`` cut to
    ``n_layers``, W4A4 ``pallas`` prepared in the config's dtype: the
    drivers' equivalence holds at any depth, and a cut copy costs a fraction
    of a second full-depth serve.  Returns each driver's host syncs and
    seconds."""
    from repro_torch.core import LutLinearSpec
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.serve.serving import ServeEngine

    ccfg = dataclasses.replace(cfg, n_layers=n_layers)
    cmodel = build_model(ccfg)
    cparams = cmodel.prepare(cmodel.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"),
                                                   seed=0, device=dev), n_hint=4)
    outs, out = {}, {}
    for decode in ("scan", "loop", "chunked"):
        t0 = time.perf_counter()
        eng = ServeEngine(cmodel, cparams, batch=4, max_seq=DS_MAX_SEQ, decode=decode,
                          device=dev)
        outs[decode] = eng.generate(reqs)
        out[decode] = dict(host_syncs=eng.host_syncs, seconds=time.perf_counter() - t0)
        del eng
    check(outs["loop"] == outs["scan"] and outs["chunked"] == outs["scan"],
          f"{what}: at {n_layers} layers decode='loop' / 'chunked' tokens differ from "
          f"decode='scan'")
    check(all(len(o) == r.max_new_tokens for o, r in zip(outs["scan"], reqs)),
          f"{what}: at {n_layers} layers token counts {[len(o) for o in outs['scan']]}")
    log(f"{what}: decode='loop' and 'chunked' give scan's tokens bit for bit on these waves, "
        f"each led by a {DS_PROMPT}-token prompt (a bucket), on a copy cut to {n_layers} "
        f"layers {transformer.segments(ccfg)}: "
        + ", ".join(f"{d} {r['host_syncs']} host syncs, {r['seconds']:.2f} s"
                    for d, r in out.items()))
    return out


def lut_cut_serve(torch, dev, cfg, n_layers, reqs, smi, *, what, want_per=None,
                  drivers=("loop",), max_seq=None, keep=False):
    """A copy of ``cfg`` cut to ``n_layers``, W1A3 p=4 ``lut``, calibrated and
    prepared, served on ``reqs`` through ``ServeEngine(batch=4,
    max_seq=512)``: every projection a frozen scale, ``want_per`` applied
    projections a forward (when given), ``lut_stream_gemm`` launched on the
    tensor-core route only with one canonicalize launch a projection
    (:func:`check_served` too), and each of ``drivers`` giving the scan
    driver's tokens (each wave led by a bucket).  Phases 17c, 18b, 19b and
    20d.  An encoder-decoder copy is cut to ``n_layers`` encoder layers too
    and calibrated over seeded bf16 frames as well as the tokens
    (``calibrate_tree`` with a closure that passes them: ``Model.prepare(
    calibrate=tokens)`` runs no frames, and the reference raises there);
    ``keep`` returns the model, its tree and the frames beside the result."""
    from repro_torch.core import LutLinearSpec
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.serve.serving import Request, ServeEngine
    from repro_torch.tune.plan import quantized_leaf_items
    import numpy as np

    from repro_torch.core.calibrate import calibrate_tree

    lcfg = dataclasses.replace(cfg, n_layers=n_layers, **(
        dict(encoder_layers=n_layers) if cfg.is_encdec else {}))
    max_seq = max_seq or DS_MAX_SEQ
    lmodel = build_model(lcfg)
    t0 = time.perf_counter()
    cal = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lq = lmodel.init_quantized(LutLinearSpec(mode="lut", **LUT_SPEC), seed=0, device=dev)
    frames = None
    if lcfg.is_encdec:
        frames = whisper_frames(torch, dev, lcfg, 2, seed=1, dtype=torch.bfloat16)
        cal_t = torch.from_numpy(cal).to(dev)
        lq = calibrate_tree(lambda probed: lmodel.forward(probed, cal_t,
                                                          prefix_embeds=frames)[0], lq)
        lparams = lmodel.prepare(lq, n_hint=4)
    else:
        lparams = lmodel.prepare(lq, calibrate=cal, n_hint=4)
    del lq
    torch.cuda.synchronize()
    lper, _ = applied_projections(lparams)
    lby = applied_projections(lparams, frames=True)[1]       # what the calibration applied
    scaled = [leaf for _p, leaf in quantized_leaf_items(lparams) if leaf.ascale is not None]
    check(len(scaled) == len(lby) and lper == (want_per or lper),
          f"{what}: {len(scaled)} of {len(lby)} leaves carry a frozen scale; {lper} applied "
          f"projections a forward, want {want_per}")
    log(f"{what}: {lcfg.n_layers} layers {transformer.segments(lcfg)}, W1A3 p=4 lut, "
        f"calibrated on {cal.size} tokens and prepared in {time.perf_counter() - t0:.1f} s; "
        f"{lper} applied projections per forward")
    leng = ServeEngine(lmodel, lparams, batch=4, max_seq=max_seq, decode="scan", device=dev)
    leng.generate([Request(prompt=reqs[0].prompt[:16], max_new_tokens=2)])   # warmup
    torch.cuda.synchronize()
    louts, lwall, lrecords, lcounts, lsync = counted_generate(torch, leng, reqs)
    lprefills, lsteps, llaunches = check_served(lcfg, leng, louts, DS_NEW, lrecords, lcounts, lsync,
                                                kernel="lut_stream_gemm", what=what)
    check(lcounts["lut_stream_gemm_tc"] == llaunches and lcounts["lut_stream_gemm_lookup"] == 0,
          f"{what}: lut_stream_gemm routes {lcounts}: the W1A3 p=4 pack must take the "
          f"tensor-core route on every launch")
    check(lcounts["lut_stream_gemm_canon"] == llaunches,
          f"{what}: canonicalize launches {lcounts['lut_stream_gemm_canon']} != "
          f"{llaunches}: one per projection")
    others = {}
    for decode in drivers:
        t0 = time.perf_counter()
        other = ServeEngine(lmodel, lparams, batch=4, max_seq=max_seq, decode=decode,
                            device=dev)
        check(other.generate(reqs) == louts,
              f"{what}: decode={decode!r} tokens differ from decode='scan'")
        others[decode] = dict(host_syncs=other.host_syncs, seconds=time.perf_counter() - t0)
        del other
    ldigest = zlib.crc32(json.dumps([list(map(int, o)) for o in louts]).encode())
    log(f"{what} [{smi}]: served the 8 requests, {sum(map(len, louts))} tokens in "
        f"{lwall:.3f} s; {len(lrecords)} waves, {lprefills} prefills, {lsteps} decode steps, "
        f"{leng.host_syncs} host syncs; lut_stream_gemm {llaunches} launches (= {lper} x "
        f"{lprefills + lsteps}; tensor cores {lcounts['lut_stream_gemm_tc']}, lookup "
        f"{lcounts['lut_stream_gemm_lookup']}, CUDA cores "
        f"{llaunches - lcounts['lut_stream_gemm_tc'] - lcounts['lut_stream_gemm_lookup']}), "
        f"canonicalize {lcounts['lut_stream_gemm_canon']}; scan's tokens under "
        + ", ".join(f"decode={d!r} ({r['host_syncs']} host syncs, {r['seconds']:.2f} s)"
                    for d, r in others.items())
        + f"; tokens crc32 {ldigest:08x}")
    out = dict(launches=llaunches, launches_tc=lcounts["lut_stream_gemm_tc"],
               launches_lookup=lcounts["lut_stream_gemm_lookup"],
               launches_canon=lcounts["lut_stream_gemm_canon"], per_forward=lper,
               prefills=lprefills, decode_steps=lsteps, host_syncs=leng.host_syncs,
               waves=len(lrecords), wall_s=lwall, tokens_crc32=ldigest, drivers=others)
    del leng
    if keep:
        return out, lmodel, lparams, frames
    del lparams
    torch.cuda.empty_cache()
    return out


CPU_SEQ = 64                  # 18c / 19c: one prefill of 2 x this many tokens on the card and
                              # the CPU
CPU_TF = 8                    # 18c / 19c: decode steps after a prefill of CPU_SEQ - CPU_TF tokens
TOL_CPU_REC = 1e-4            # 18c / 19c: card vs CPU, and prefill vs prefill + decode (f32),
                              # relative to max |logit|


def card_vs_cpu(torch, dev, cfg, n_layers, smi, *, what, seq=CPU_SEQ, tf=CPU_TF,
                tol=TOL_CPU_REC):
    """A copy of ``cfg`` cut to ``n_layers`` in f32, W4A4 ``pallas`` prepared
    (seed 3): one prefill of 2 x ``seq`` tokens on the card against the
    CPU's (the kernels' plain versions), and against a prefill of ``seq -
    tf`` followed by ``tf`` decode steps on the card, each within ``tol`` x
    max |logit|.  Phases 18c, 19c, 20c and 21b.  An encoder-decoder copy is
    cut to ``n_layers`` encoder layers too, and each prefill runs over the
    same seeded f32 frames (the decode steps over the cached cross keys and
    values); a VLM's prefills run over seeded f32 patches prepended to the
    tokens (the decode steps at offsets from P + S), and the last decode
    step is also held against the cache-free forward over patches and
    tokens."""
    from repro_torch import tree
    from repro_torch.core import LutLinearSpec
    from repro_torch.models.model import build_model
    import numpy as np

    dcfg = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32", **(
        dict(encoder_layers=n_layers) if cfg.is_encdec else {}))
    dmodel = build_model(dcfg)
    dparams = dmodel.prepare(dmodel.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"),
                                                   seed=3, device=dev), n_hint=4)
    dtoks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    toks_gpu = torch.from_numpy(dtoks).to(dev)
    fr, extra = {}, 0
    if dcfg.frontend is not None:     # an enc-dec model's frames, or a VLM's patches
        fr = dict(prefix_embeds=whisper_frames(torch, dev, dcfg, 2, seed=4))
        extra = 0 if dcfg.is_encdec else dcfg.frontend_seq
    lg_gpu, _ = dmodel.prefill(dparams, toks_gpu,
                               dmodel.init_cache(2, seq + extra, torch.float32, device=dev), **fr)
    split = dmodel.init_cache(2, seq + extra, torch.float32, device=dev)
    dmodel.prefill(dparams, toks_gpu[:, : seq - tf], split, **fr)
    for t in range(seq - tf, seq):
        lg_split, _ = dmodel.decode_step(dparams, toks_gpu[:, t : t + 1], split, t + extra)
    ferr = None
    if extra:   # a VLM: the prefill + decode steps against the cache-free forward too
        lg_fwd, _ = dmodel.forward(dparams, toks_gpu, last_token_only=True, **fr)
        ferr = (lg_split - lg_fwd).abs().max().item()
    lg_gpu, lg_split = lg_gpu.cpu(), lg_split.cpu()
    params_cpu = tree.tree_map(lambda t: t.cpu(), dparams)
    del dparams, split
    t1 = time.perf_counter()
    lg_cpu, _ = dmodel.prefill(params_cpu, torch.from_numpy(dtoks),
                               dmodel.init_cache(2, seq + extra, torch.float32, device="cpu"),
                               **{k: v.cpu() for k, v in fr.items()})
    cpu_s = time.perf_counter() - t1
    del params_cpu
    lscale = lg_cpu.abs().max().item()
    lerr = (lg_gpu - lg_cpu).abs().max().item()
    serr = (lg_split - lg_gpu).abs().max().item()
    check(bool(torch.isfinite(lg_gpu).all()) and lg_gpu.shape == (2, 1, cfg.vocab_size),
          f"{what}: logits of shape {tuple(lg_gpu.shape)} or not finite")
    check(lerr <= tol * lscale, f"{what}: card vs CPU logits max err {lerr:.3e} > "
                                f"{tol} x max|logit| {lscale:.3e}")
    check(serr <= tol * lscale,
          f"{what}: prefill of {seq} vs prefill of {seq - tf} + {tf} decode steps: max err "
          f"{serr:.3e} > {tol} x max|logit| {lscale:.3e}")
    check(ferr is None or ferr <= tol * lscale,
          f"{what}: prefill + decode steps vs the cache-free forward: max err {ferr} > {tol} x "
          f"max|logit| {lscale:.3e}")
    log(f"{what} [{smi}]: {n_layers} layers at full width, f32, one prefill of 2 x {seq} "
        f"tokens{' over 2 x ' + str(dcfg.frontend_seq) + (' frames' if dcfg.is_encdec else ' patches') if fr else ''}: card "
        f"(lut_dequant_gemm's CUDA-core route) vs CPU (plain versions, "
        f"{cpu_s:.1f} s): max err {lerr:.3e} = {lerr / lscale:.3e} x max|logit|; a prefill of "
        f"{seq - tf} + {tf} decode steps on the card: {serr:.3e} = {serr / lscale:.3e} x "
        f"max|logit|" + ("" if ferr is None else f"; against the cache-free forward over the "
                         f"{extra} patches + {seq} tokens: {ferr:.3e} = {ferr / lscale:.3e} x "
                         f"max|logit|"))
    out = dict(rel_err=lerr / lscale, prefill_vs_decode_rel_err=serr / lscale, cpu_s=cpu_s)
    if ferr is not None:
        out["decode_vs_forward_rel_err"] = ferr / lscale
    return out


def phase_deepseek(torch, dev, smi):
    """Phase 17: deepseek-v2-lite-16b (MLA attention, 64 routed + 2 shared
    experts top-6, a dense first layer) at its published widths.

    17a: :data:`DS_SERVE_LAYERS` of its 27 layers, W4A4 ``pallas`` prepared,
    bf16, served through
    ``ServeEngine(batch=4, max_seq=512)`` (the published capacity factor):
    exact token counts, one host sync a wave and no other synchronizing
    call, ``lut_dequant_gemm`` launched (applied projections per forward,
    counted from the tree) x (prefills + steps) times, all on the tensor
    cores; ``decode="loop"`` and ``"chunked"`` give the same tokens; one MoE
    layer twice on the same input gives the same bits; times and the
    profiler's breakdown.  17b: one layer's ``mla_attention`` on one row of
    4608 tokens (the chunked branch) against its unchunked latent attention.
    17c: W1A3 ``lut``, calibrated and prepared, 4 layers, phase 17a's
    requests: ``lut_stream_gemm`` and canonicalize launches per route, scan
    == loop.  17d: 2 layers in f32, one prefill on the card against the
    CPU's (the kernels' plain versions): logits and expert ids.  17e: each
    distinct shape of 17a's applied projections, B = 4 and 4 x 128, bf16 x:
    ``lut_dequant_gemm`` on the tensor cores against its plain version (phase
    2's sweep), ``lut_stream_gemm`` and ``lut_canon`` at W1A3 p=4 against
    theirs (phase 6's), with times.

    scan == loop == chunked holds on these waves because each wave's longest
    prompt is a bucket: the MoE capacity follows the call's token count, pads
    included, so on other waves the drivers may route otherwise, as the
    reference's do (ROADMAP Numerics rules)."""
    from repro_torch import hw, tree
    from repro_torch.configs import get_config
    from repro_torch.core import LutLinearSpec
    from repro_torch.models import attention, moe
    from repro_torch.models.model import build_model
    from repro_torch.serve.serving import Request, ServeEngine
    from repro_torch.tune.plan import quantized_leaf_items
    import numpy as np

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(DEEPSEEK), n_layers=DS_SERVE_LAYERS)
    out = {}

    # --- 17a: DS_SERVE_LAYERS layers, W4A4 pallas, bf16, served --------------
    model = build_model(cfg)
    before_gc, base = held_before_build(torch, dev, "phase 17a")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.prepare(model.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"), seed=0,
                                                device=dev), n_hint=4)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    code_bytes = sum(leaf.codes.numel() for _p, leaf in quantized_leaf_items(params))
    param_bytes = sum(t.numel() * t.element_size() for t in tree.tensors(params))
    per_forward, by_path = applied_projections(params)
    shapes = projection_shapes(params)
    log(f"phase 17a: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} MLA lora="
        f"{cfg.mla.kv_lora_rank} rope={cfg.mla.qk_rope_dim} experts={cfg.moe.n_experts} "
        f"(+{cfg.moe.n_shared_experts} shared) top-{cfg.moe.top_k} d_ff_expert="
        f"{cfg.moe.d_ff_expert} capacity_factor={cfg.moe.capacity_factor} vocab="
        f"{cfg.vocab_size} layers={cfg.n_layers} (1 F + {cfg.n_layers - 1} D), W4A4 pallas, "
        f"bf16, built + prepared in {build_s:.1f} s; codes {code_bytes:,} B, parameters "
        f"{param_bytes:,} B, {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on the card; "
        f"{per_forward} applied projections per forward "
        f"({', '.join(f'{p.split('/', 2)[-1]} x{n}' for p, (n, _k, _f) in by_path.items())})")
    eng = ServeEngine(model, params, batch=4, max_seq=DS_MAX_SEQ, decode="scan", device=dev)
    lens, reqs = bucket_led_requests(cfg)
    eng.generate([Request(prompt=reqs[0].prompt[:16], max_new_tokens=2)])   # warmup
    torch.cuda.synchronize()
    outs, wall, records, counts, sync_warnings = counted_generate(torch, eng, reqs)
    prefills, steps, launches = check_served(cfg, eng, outs, DS_NEW, records, counts,
                                             sync_warnings, kernel="lut_dequant_gemm",
                                             what="phase 17a")
    digest = zlib.crc32(json.dumps([list(map(int, o)) for o in outs]).encode())
    n_tok = sum(len(o) for o in outs)
    log(f"phase 17a [{smi}]: served {len(reqs)} requests (prompt lengths {lens.tolist()}, "
        f"prefill buckets {sorted({r.prefill_bucket for r in records if r.prefill_bucket})}), "
        f"{n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s end to end); {len(records)} "
        f"waves, {prefills} prefills, {steps} decode steps, {eng.host_syncs} host syncs, "
        f"{launches} lut_dequant_gemm launches (= {per_forward} x {prefills + steps}, all on the "
        f"tensor cores); sync-debug warnings {len(sync_warnings)} (the token fetches); "
        f"admissions {eng.admissions}; tokens crc32 {digest:08x}")
    drivers = drivers_agree(torch, dev, cfg, DS_LUT_LAYERS, reqs, "phase 17a")
    unit = tree.index(params["segments"][1], 0)["s0_D"]
    gen = torch.Generator(device=dev).manual_seed(5)
    xm = torch.randn((4, DS_PROMPT, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    y1, aux1 = moe.moe_apply(unit["moe"], xm, cfg)
    y2, aux2 = moe.moe_apply(unit["moe"], xm, cfg)
    check(torch.equal(y1, y2) and torch.equal(aux1, aux2),
          "phase 17a: one MoE layer twice on the same input gave other bits")
    check(bool(torch.isfinite(y1).all()), "phase 17a: MoE output not finite")
    log(f"phase 17a: one MoE layer twice on the same [4, {DS_PROMPT}, {cfg.d_model}] bf16 input: "
        f"the same bits (aux {aux1.item():.6f})")
    del y1, y2, xm

    caches = eng._new_cache()
    toks = torch.randint(0, cfg.vocab_size, (4, DS_PROMPT), device=dev, dtype=torch.int32)
    pad = torch.zeros((4,), dtype=torch.int32, device=dev)
    tok, pos = toks[:, -1:], torch.full((4,), DS_PROMPT, dtype=torch.int32, device=dev)
    prefill = lambda: model.prefill(params, toks, caches, pad_len=pad)            # noqa: E731
    step = lambda: model.decode_step(params, tok, caches, pos, pad_len=pad)       # noqa: E731
    prefill_ms = time_ms(torch, lambda i: prefill(), 3)
    step_ms = time_ms(torch, lambda i: step(), 5)
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    log(f"phase 17a [{smi}]: prefill B=4 x {DS_PROMPT} tokens {prefill_ms:.2f} ms; decode step "
        f"B=4 at {DS_PROMPT} {step_ms:.2f} ms ({4e3 / step_ms:.1f} tok/s); peak memory "
        f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated less the {base / 1e9:.2f} GB held "
        f"before the build)")
    log("phase 17a: where the device time goes (torch.profiler; wall time from the unprofiled "
        "runs above):")
    prefill_prof = region_breakdown(torch, prefill, 2, prefill_ms, kernel="lut_dequant_gemm",
                                    card=smi, what=f"prefill B=4 x {DS_PROMPT}",
                                    labels=deepseek_regions())
    step_prof = region_breakdown(torch, step, 3, step_ms, kernel="lut_dequant_gemm", card=smi,
                                 what=f"decode step B=4 at {DS_PROMPT}",
                                 labels=deepseek_regions())
    out["a"] = dict(
        launches=launches, launches_tc=counts["lut_dequant_gemm_tc"], per_forward=per_forward,
        prefills=prefills, decode_steps=steps, host_syncs=eng.host_syncs, waves=len(records),
        wall_s=wall, tokens=n_tok, tok_s=n_tok / wall, tokens_crc32=digest,
        prefill_wall_s=sum(r.t_decode - r.t_start for r in records),
        decode_wall_s=sum(r.t_sync - r.t_decode for r in records),
        prefill_ms=prefill_ms, step_ms=step_ms, peak_gb=peak_gb, held_before_gb=base / 1e9,
        held_before_gc_gb=before_gc / 1e9, code_bytes=code_bytes,
        param_bytes=param_bytes, build_s=build_s, prefill_profile=prefill_prof,
        decode_profile=step_prof, drivers=drivers)
    del eng, caches, prefill, step

    # --- 17b: MLA's chunked prefill at full width, one row, f32 ----------------
    f32 = dataclasses.replace(cfg, dtype="float32")
    layer = tree.index(params["segments"][1], 0)["s0_D"]["attn"]
    xa = torch.randn((1, DS_CHUNKED_SEQ, cfg.d_model), generator=gen, device=dev)
    positions = torch.arange(DS_CHUNKED_SEQ, device=dev)[None]
    chunks = []
    attend = attention._latent_attend
    threshold = attention.CHUNK_THRESHOLD
    run = lambda i=0: attention.mla_attention(layer, xa, cfg=f32, positions=positions)  # noqa: E731
    try:
        attention._latent_attend = lambda *a: chunks.append(a[0].shape[1]) or attend(*a)
        y_chunked, _ = run()
        n_chunks = list(chunks)
        attention.CHUNK_THRESHOLD = DS_CHUNKED_SEQ     # the unchunked latent attention
        chunks.clear()
        y_whole, _ = run()
        attention._latent_attend = attend
        whole_ms = time_ms(torch, run, 3)
        attention.CHUNK_THRESHOLD = threshold
        chunked_ms = time_ms(torch, run, 3)
    finally:
        attention._latent_attend, attention.CHUNK_THRESHOLD = attend, threshold
    check(n_chunks == [attention.CHUNK_SIZE] * (DS_CHUNKED_SEQ // attention.CHUNK_SIZE)
          and chunks == [DS_CHUNKED_SEQ], f"phase 17b: chunks {n_chunks}, then {chunks}")
    scale = y_whole.abs().max().item()
    err = (y_chunked - y_whole).abs().max().item()
    check(math.isfinite(err) and err <= TOL_MLA_CHUNKED * scale,
          f"phase 17b: chunked vs unchunked MLA max err {err:.3e} > {TOL_MLA_CHUNKED} x "
          f"max|y| {scale:.3e}")
    log(f"phase 17b [{smi}]: one MLA layer, one row of {DS_CHUNKED_SEQ} tokens, f32: "
        f"{len(n_chunks)} query chunks of {attention.CHUNK_SIZE} in {chunked_ms:.2f} ms vs the "
        f"unchunked latent attention in {whole_ms:.2f} ms (CUDA events, 3 calls after a "
        f"warmup); max err {err:.3e} = "
        f"{err / scale:.3e} x max|y|")
    out["b"] = dict(chunks=len(n_chunks), chunked_ms=chunked_ms, unchunked_ms=whole_ms,
                    rel_err=err / scale)
    del params, layer, xa, y_chunked, y_whole, unit
    torch.cuda.empty_cache()

    # --- 17c: W1A3 lut, calibrated + prepared, 4 layers ------------------------
    out["c"] = lut_cut_serve(torch, dev, cfg, DS_LUT_LAYERS, reqs, smi, what="phase 17c")

    # --- 17d: the card against the CPU, 2 layers, f32 -------------------------
    dcfg = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    dmodel = build_model(dcfg)
    dparams = dmodel.prepare(dmodel.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"),
                                                   seed=3, device=dev), n_hint=4)
    dtoks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    ids = []
    route = moe._route

    def recorded(*args):
        r = route(*args)
        ids.append(r[1].cpu())
        return r

    moe._route = recorded
    try:
        lg_gpu, _ = dmodel.prefill(dparams, torch.from_numpy(dtoks).to(dev),
                                   dmodel.init_cache(2, 64, torch.float32, device=dev))
        lg_gpu = lg_gpu.cpu()
        gpu_ids, ids[:] = list(ids), []
        params_cpu = tree.tree_map(lambda t: t.cpu(), dparams)
        del dparams
        t1 = time.perf_counter()
        lg_cpu, _ = dmodel.prefill(params_cpu, torch.from_numpy(dtoks),
                                   dmodel.init_cache(2, 64, torch.float32, device="cpu"))
        cpu_s = time.perf_counter() - t1
    finally:
        moe._route = route
    del params_cpu
    lscale = lg_cpu.abs().max().item()
    lerr = (lg_gpu - lg_cpu).abs().max().item()
    check(bool(torch.isfinite(lg_gpu).all()) and lg_gpu.shape == (2, 1, cfg.vocab_size),
          f"phase 17d: logits of shape {tuple(lg_gpu.shape)} or not finite")
    check(lerr <= TOL_CPU_DS * lscale, f"phase 17d: card vs CPU logits max err {lerr:.3e} > "
                                       f"{TOL_CPU_DS} x max|logit| {lscale:.3e}")
    check(len(gpu_ids) == len(ids) == 1 and all(torch.equal(a, b) for a, b in zip(gpu_ids, ids)),
          f"phase 17d: expert ids differ between the card and the CPU ({len(gpu_ids)} / "
          f"{len(ids)} MoE layers)")
    log(f"phase 17d [{smi}]: 2 layers (F + D) at full width, f32, one prefill of 2 x 64 tokens: "
        f"card (lut_dequant_gemm) vs CPU (plain versions, {cpu_s:.1f} s): max err {lerr:.3e} = "
        f"{lerr / lscale:.3e} x max|logit|; expert ids equal ({gpu_ids[0].numel()} routed slots)")
    out["d"] = dict(rel_err=lerr / lscale, routed_slots=gpu_ids[0].numel(), cpu_s=cpu_s)

    # --- 17e: the kernels against their plain versions at deepseek's shapes ---
    log(f"phase 17e: {cfg.name}'s {len(shapes)} distinct applied projection shapes (K, F) "
        f"{shapes}, B = 4 and 4 x {DS_PROMPT}, bf16 x [{smi}]:")
    rows, rel, abs_err = phase_kernel_times(torch, dev, cfg, hw.H100_SXM, iters=(10, 3, 3),
                                            label="phase 17e", shapes=shapes)
    srows, sabs = phase_stream_times(torch, dev, cfg, hw.H100_SXM, smi, shapes=shapes,
                                     label="phase 17e")
    out["e"] = dict(shapes=shapes, dequant_rows=rows, dequant_rel=rel, dequant_abs=abs_err,
                    stream_rows=srows, stream_abs=sabs)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 17: {out['seconds']:.1f} s")
    return out


ZAMBA = "zamba2-7b"
ZB_LUT_LAYERS = 6             # 18b / 18c: depth cut to one "MMMMMS" unit
ZB_SERVE_LAYERS = 6           # 18: depth (of 81: one "MMMMMS" unit), to keep
                              # the script in its time limit (each check holds at any depth)
ZB_PROFILED = 32              # 18a: the profiled prefill's length (B = 4): torch.profiler parses
                              # about 4 host events a recurrence step and layer, ~0.5 M at 128


def zamba2_applied(cfg):
    """``(applied projections a forward, "S" sublayers)`` of a zamba2 config
    from its segments: an in_proj and an out_proj a layer, and the shared
    block's 7 projections once per "S" sublayer."""
    from repro_torch.models import transformer

    n_s = sum(pat.count("S") * n for pat, n in transformer.segments(cfg))
    return 2 * cfg.n_layers + 7 * n_s, n_s


def cache_bytes(caches):
    """``(attention K/V bytes, Mamba2 state bytes)`` of a zamba2 cache tree."""
    from repro_torch import tree

    kv = sum(t.numel() * t.element_size() for seg in caches for key, c in seg.items()
             if key.endswith("_S") for t in tree.tensors(c["attn"]))
    state = sum(t.numel() * t.element_size() for t in tree.tensors(caches)) - kv
    return kv, state


def phase_zamba2(torch, dev, smi):
    """Phase 18: zamba2-7b (81 layers: 13 "MMMMMS" units + "MMM"; Mamba2 SSD
    mixers, d_model 3584, 112 heads of 64, state 64, and one shared
    attention + FFN block, 32/32 heads of 112, d_ff 14336, applied by each of
    the 13 "S" sublayers) at its published widths.

    18a: :data:`ZB_SERVE_LAYERS` of its 81 layers (one "MMMMMS" unit),
    W4A4 ``pallas`` prepared, bf16, served through
    ``ServeEngine(batch=4, max_seq=512)`` on phase 17's requests (each wave
    led by a 128-token prompt): exact token counts, one host sync a wave and
    no other synchronizing call, ``lut_dequant_gemm`` launched 27 x 2 + 4 x 7
    = 82 times a forward (the shared block per application), all on the
    tensor cores; ``decode="loop"`` and ``"chunked"`` give scan's tokens on a
    copy cut to 6 layers (:func:`drivers_agree`);
    build time, bytes, the decode step and the 4 x 128 prefill on CUDA
    events, the profiler's busy / idle and the recurrence's and the conv's
    share, tok/s, peak memory.  18b: W1A3 ``lut`` p=4, calibrated and
    prepared, 6 layers (one unit), 18a's requests: ``lut_stream_gemm`` and
    canonicalize launches per route (the shared block per application),
    scan == loop.  18c: 6 layers in f32, one prefill on the card against
    the CPU's (the kernels' plain versions), and a prefill of S tokens
    against a prefill of S - 8 followed by 8 decode steps, each within
    1e-4 x max |logit|.  18d: each distinct applied shape at B = 4 and 4 x
    128: ``lut_dequant_gemm`` against its plain version (phase 2's sweep),
    ``lut_stream_gemm`` and ``lut_canon`` at W1A3 p=4 against theirs (phase
    6's), with times.

    The pads of a left-padded row go through the conv and the recurrence,
    as in the reference, so scan == loop == chunked holds only where every
    driver pads a row alike: each wave's longest prompt a bucket."""
    from repro_torch import hw, tree
    from repro_torch.configs import get_config
    from repro_torch.core import LutLinearSpec
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.serve.serving import Request, ServeEngine
    from repro_torch.tune.plan import quantized_leaf_items

    t_phase = time.perf_counter()
    laps = {}

    def lap(what):
        laps[what] = time.perf_counter() - t_phase - sum(laps.values())

    cfg = dataclasses.replace(get_config(ZAMBA), n_layers=ZB_SERVE_LAYERS)
    out = {"laps_s": laps}
    want_per, n_s = zamba2_applied(cfg)

    # --- 18a: ZB_SERVE_LAYERS layers, W4A4 pallas, bf16, served --------------
    model = build_model(cfg)
    before_gc, base = held_before_build(torch, dev, "phase 18a")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.prepare(model.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"), seed=0,
                                                device=dev), n_hint=4)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    code_bytes = sum(leaf.codes.numel() for _p, leaf in quantized_leaf_items(params))
    param_bytes = sum(t.numel() * t.element_size() for t in tree.tensors(params))
    per_forward, by_path = applied_projections(params)
    shapes = projection_shapes(params)
    check(per_forward == want_per, f"phase 18a: {per_forward} applied projections a forward, "
                                   f"want 2 x {cfg.n_layers} + 7 x {n_s} = {want_per}")
    log(f"phase 18a: {cfg.name} d_model={cfg.d_model} SSD heads="
        f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} x {cfg.ssm.head_dim} state="
        f"{cfg.ssm.d_state} conv={cfg.ssm.conv_width}; shared block {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads hd={cfg.hd} d_ff={cfg.d_ff}, applied by {n_s} 'S' sublayers; "
        f"vocab={cfg.vocab_size} layers={cfg.n_layers} {transformer.segments(cfg)}, W4A4 pallas, "
        f"bf16, built + prepared in {build_s:.1f} s; codes {code_bytes:,} B, parameters "
        f"{param_bytes:,} B, {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on the card; "
        f"{per_forward} applied projections per forward "
        f"({', '.join(f'{p.split('/', 2)[-1]} x{n}' for p, (n, _k, _f) in by_path.items())})")
    eng = ServeEngine(model, params, batch=4, max_seq=DS_MAX_SEQ, decode="scan", device=dev)
    kv_bytes, state_bytes = cache_bytes(eng._new_cache())
    lens, reqs = bucket_led_requests(cfg)
    eng.generate([Request(prompt=reqs[0].prompt[:16], max_new_tokens=2)])   # warmup
    torch.cuda.synchronize()
    outs, wall, records, counts, sync_warnings = counted_generate(torch, eng, reqs)
    prefills, steps, launches = check_served(cfg, eng, outs, DS_NEW, records, counts,
                                             sync_warnings, kernel="lut_dequant_gemm",
                                             what="phase 18a")
    digest = zlib.crc32(json.dumps([list(map(int, o)) for o in outs]).encode())
    n_tok = sum(len(o) for o in outs)
    log(f"phase 18a [{smi}]: served {len(reqs)} requests (prompt lengths {lens.tolist()}, "
        f"prefill buckets {sorted({r.prefill_bucket for r in records if r.prefill_bucket})}), "
        f"{n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s end to end); {len(records)} "
        f"waves, {prefills} prefills, {steps} decode steps, {eng.host_syncs} host syncs, "
        f"{launches} lut_dequant_gemm launches (= {per_forward} x {prefills + steps}, all on the "
        f"tensor cores); sync-debug warnings {len(sync_warnings)} (the token fetches); "
        f"admissions {eng.admissions}; the serve's caches: shared-attention K/V "
        f"{kv_bytes:,} B, Mamba2 state {state_bytes:,} B (f32); tokens crc32 {digest:08x}")
    drivers = drivers_agree(torch, dev, cfg, ZB_LUT_LAYERS, reqs, "phase 18a")

    caches = eng._new_cache()
    toks = torch.randint(0, cfg.vocab_size, (4, DS_PROMPT), device=dev, dtype=torch.int32)
    pad = torch.zeros((4,), dtype=torch.int32, device=dev)
    tok, pos = toks[:, -1:], torch.full((4,), DS_PROMPT, dtype=torch.int32, device=dev)
    prefill = lambda: model.prefill(params, toks, caches, pad_len=pad)            # noqa: E731
    short = lambda: model.prefill(params, toks[:, :ZB_PROFILED], caches, pad_len=pad)  # noqa: E731
    step = lambda: model.decode_step(params, tok, caches, pos, pad_len=pad)       # noqa: E731
    prefill_ms = time_ms(torch, lambda i: prefill(), 2)
    short_ms = time_ms(torch, lambda i: short(), 2)
    step_ms = time_ms(torch, lambda i: step(), 5)
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    log(f"phase 18a [{smi}]: prefill B=4 x {DS_PROMPT} tokens {prefill_ms:.2f} ms (B=4 x "
        f"{ZB_PROFILED}: {short_ms:.2f} ms); decode step "
        f"B=4 at {DS_PROMPT} {step_ms:.2f} ms ({4e3 / step_ms:.1f} tok/s); peak memory "
        f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated less the {base / 1e9:.2f} GB held "
        f"before the build)")
    log("phase 18a: where the device time goes (torch.profiler; wall time from the unprofiled "
        "runs above):")
    profiles = {}
    for name, fn, iters, ms, what in (
            ("prefill", short, 1, short_ms, f"prefill B=4 x {ZB_PROFILED}"),
            ("decode", step, 3, step_ms, f"decode step B=4 at {DS_PROMPT}")):
        prof = region_breakdown(torch, fn, iters, ms, kernel="lut_dequant_gemm", card=smi,
                                what=what, labels=zamba2_regions())
        if prof is not None:
            shares = {k: v / prof["busy_ms"] for k, v in prof["regions_ms"].items()}
            log(f"  {name}: share of busy: " + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
                + f", lut_dequant_gemm {prof['kernel_ms'] / prof['busy_ms']:.3f}")
            prof["shares"] = shares
        profiles[name] = prof
    out["a"] = dict(
        launches=launches, launches_tc=counts["lut_dequant_gemm_tc"], per_forward=per_forward,
        prefills=prefills, decode_steps=steps, host_syncs=eng.host_syncs, waves=len(records),
        wall_s=wall, tokens=n_tok, tok_s=n_tok / wall, tokens_crc32=digest,
        prefill_wall_s=sum(r.t_decode - r.t_start for r in records),
        decode_wall_s=sum(r.t_sync - r.t_decode for r in records),
        prefill_ms=prefill_ms, profiled_prefill_ms=short_ms, step_ms=step_ms, peak_gb=peak_gb,
        held_before_gb=base / 1e9, held_before_gc_gb=before_gc / 1e9, code_bytes=code_bytes,
        param_bytes=param_bytes, kv_cache_bytes=kv_bytes, state_bytes=state_bytes, build_s=build_s,
        prefill_profile=profiles["prefill"], decode_profile=profiles["decode"], drivers=drivers)
    del eng, caches, prefill, short, step, params
    torch.cuda.empty_cache()
    lap("18a")

    # --- 18b: W1A3 lut, calibrated + prepared, one unit ------------------------
    out["b"] = lut_cut_serve(torch, dev, cfg, ZB_LUT_LAYERS, reqs, smi, what="phase 18b",
                             want_per=zamba2_applied(dataclasses.replace(
                                 cfg, n_layers=ZB_LUT_LAYERS))[0])
    lap("18b")

    # --- 18c: f32, one unit: the card against the CPU; prefill vs decode -------
    out["c"] = card_vs_cpu(torch, dev, cfg, ZB_LUT_LAYERS, smi, what="phase 18c")
    lap("18c")

    # --- 18d: the kernels against their plain versions at zamba2's shapes -----
    log(f"phase 18d: {cfg.name}'s {len(shapes)} distinct applied projection shapes (K, F) "
        f"{shapes}, B = 4 and 4 x {DS_PROMPT}, bf16 x [{smi}]:")
    rows, rel, abs_err = phase_kernel_times(torch, dev, cfg, hw.H100_SXM, iters=(10, 3, 3),
                                            label="phase 18d", shapes=shapes)
    srows, sabs = phase_stream_times(torch, dev, cfg, hw.H100_SXM, smi, shapes=shapes,
                                     label="phase 18d")
    out["d"] = dict(shapes=shapes, dequant_rows=rows, dequant_rel=rel, dequant_abs=abs_err,
                    stream_rows=srows, stream_abs=sabs)
    lap("18d")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 18: {out['seconds']:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
        + ")")
    return out


RWKV = "rwkv6-3b"
RW_SERVE_LAYERS = 8           # 19a: depth (of 32), to keep the script in its time limit
                              # (each check holds at any depth)
RW_LUT_LAYERS = 4             # 19b: depth cut to 4 "R" units
RW_CPU_LAYERS = 2             # 19c: depth of the f32 card-vs-CPU check
RW_PROFILED = 32              # 19a: the profiled prefill's length (B = 4), as 18a's
RW_LONG_SEQ = 8192            # 19a: a second engine's max_seq: the state must not grow with it


def rwkv_regions():
    """Phase 19's profiler regions: the WKV recurrence (each step of
    ``rwkv._step``), the rest of the time mix (token shift, the ddlerp
    LoRA mixes, the decay, the group norm and the gate; ``rwkv_time_mix``
    less its steps) and the channel mix's elementwise work
    (``rwkv_channel_mix``); their projections are ``lut_dequant_gemm``."""
    from repro_torch.models import rwkv

    return ((rwkv, "_step", "wkv recurrence"), (rwkv, "rwkv_time_mix", "time mix rest"),
            (rwkv, "rwkv_channel_mix", "channel mix rest"))


def rwkv_state_bytes(cfg, batch):
    """The RWKV6 serving state from the shapes, f32 (``ServeEngine``'s cache
    dtype): per layer the WKV state ``[B, H, P, P]`` and the two token-shift
    rows ``[B, D]``, whatever ``max_seq`` is."""
    n_heads, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    return cfg.n_layers * (batch * n_heads * hd * hd + 2 * batch * cfg.d_model) * 4


def phase_rwkv(torch, dev, smi):
    """Phase 19: rwkv6-3b (32 RWKV6 "Finch" layers, d_model 2560, 40 heads of
    64, d_ff 8960, vocab 65536; no attention) at its published widths.

    19a: :data:`RW_SERVE_LAYERS` of its 32 layers, W4A4 ``pallas`` prepared,
    bf16, served through ``ServeEngine(batch=4, max_seq=512)`` on phase 17's
    requests (each wave led by a 128-token prompt): exact token counts, one
    host sync a wave and no other synchronizing call, ``lut_dequant_gemm``
    launched 8 a layer a forward, all on the tensor cores, and no other
    kernel; the
    serve's state bytes equal the count from the shapes and are the same at
    ``max_seq`` 8192; build time, bytes, the decode step and the 4 x 128
    prefill on CUDA events, the profiler's busy / idle and the recurrence's
    share at a 4 x 32 prefill and a decode step, tok/s, peak memory.  19b:
    W1A3 ``lut`` p=4, calibrated and prepared, 4 layers, 19a's requests:
    ``lut_stream_gemm`` and canonicalize launches per route, scan == loop ==
    chunked.  19c: 2 layers in f32, one prefill on the card against the
    CPU's (the kernels' plain versions), and a prefill of S tokens against a
    prefill of S - 8 followed by 8 decode steps, each within 1e-4 x max
    |logit|.  19d: the 3 distinct applied shapes at B = 4 and 4 x 128:
    ``lut_dequant_gemm`` against its plain version (phase 2's sweep),
    ``lut_stream_gemm`` and ``lut_canon`` at W1A3 p=4 against theirs (phase
    6's), with times.

    The pads of a left-padded row go through the token shift and the
    recurrence, as in the reference, so scan == loop == chunked holds only
    where every driver pads a row alike: each wave's longest prompt a
    bucket."""
    from repro_torch import hw, tree
    from repro_torch.configs import get_config
    from repro_torch.core import LutLinearSpec
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.serve.serving import Request, ServeEngine
    from repro_torch.tune.plan import quantized_leaf_items

    t_phase = time.perf_counter()
    laps = {}

    def lap(what):
        laps[what] = time.perf_counter() - t_phase - sum(laps.values())

    cfg = dataclasses.replace(get_config(RWKV), n_layers=RW_SERVE_LAYERS)
    out = {"laps_s": laps}
    want_per = 8 * cfg.n_layers

    # --- 19a: RW_SERVE_LAYERS layers, W4A4 pallas, bf16, served --------------
    model = build_model(cfg)
    before_gc, base = held_before_build(torch, dev, "phase 19a")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.prepare(model.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"), seed=0,
                                                device=dev), n_hint=4)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    code_bytes = sum(leaf.codes.numel() for _p, leaf in quantized_leaf_items(params))
    param_bytes = sum(t.numel() * t.element_size() for t in tree.tensors(params))
    dense_bytes = sum(v.numel() * v.element_size() for seg in params["segments"]
                      for unit in seg.values() for sub in unit.values() for v in sub.values()
                      if isinstance(v, torch.Tensor))
    per_forward, by_path = applied_projections(params)
    shapes = projection_shapes(params)
    check(per_forward == want_per, f"phase 19a: {per_forward} applied projections a forward, "
                                   f"want 8 x {cfg.n_layers} = {want_per}")
    log(f"phase 19a: {cfg.name} d_model={cfg.d_model} heads={cfg.d_model // cfg.rwkv.head_dim} "
        f"x {cfg.rwkv.head_dim} d_ff={cfg.d_ff} mix_lora={cfg.rwkv.mix_lora} decay_lora="
        f"{cfg.rwkv.decay_lora} vocab={cfg.vocab_size} layers={cfg.n_layers} "
        f"{transformer.segments(cfg)}, W4A4 pallas, bf16, built + prepared in {build_s:.1f} s; "
        f"codes {code_bytes:,} B, parameters {param_bytes:,} B (the dense f32 LoRA, mix, "
        f"decay, bonus and norm leaves of the units {dense_bytes:,} B), {torch.cuda.memory_allocated(dev) / 1e9:.2f} "
        f"GB on the card; {per_forward} applied projections per forward "
        f"({', '.join(f'{p.split('/', 2)[-1]} x{n}' for p, (n, _k, _f) in by_path.items())})")
    eng = ServeEngine(model, params, batch=4, max_seq=DS_MAX_SEQ, decode="scan", device=dev)
    state_bytes = sum(t.numel() * t.element_size() for t in tree.tensors(eng._new_cache()))
    long_bytes = sum(t.numel() * t.element_size() for t in tree.tensors(
        ServeEngine(model, params, batch=4, max_seq=RW_LONG_SEQ, decode="scan",
                    device=dev)._new_cache()))
    want_state = rwkv_state_bytes(cfg, 4)
    check(state_bytes == want_state == long_bytes,
          f"phase 19a: the serve's state {state_bytes:,} B at max_seq {DS_MAX_SEQ}, "
          f"{long_bytes:,} B at {RW_LONG_SEQ}; from the shapes {want_state:,} B")
    lens, reqs = bucket_led_requests(cfg)
    eng.generate([Request(prompt=reqs[0].prompt[:16], max_new_tokens=2)])   # warmup
    torch.cuda.synchronize()
    outs, wall, records, counts, sync_warnings = counted_generate(torch, eng, reqs)
    prefills, steps, launches = check_served(cfg, eng, outs, DS_NEW, records, counts,
                                             sync_warnings, kernel="lut_dequant_gemm",
                                             what="phase 19a")
    digest = zlib.crc32(json.dumps([list(map(int, o)) for o in outs]).encode())
    n_tok = sum(len(o) for o in outs)
    log(f"phase 19a [{smi}]: served {len(reqs)} requests (prompt lengths {lens.tolist()}, "
        f"prefill buckets {sorted({r.prefill_bucket for r in records if r.prefill_bucket})}), "
        f"{n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s end to end); {len(records)} "
        f"waves, {prefills} prefills, {steps} decode steps, {eng.host_syncs} host syncs, "
        f"{launches} lut_dequant_gemm launches (= {per_forward} x {prefills + steps}, all on the "
        f"tensor cores), flash_attention {counts['flash_attention']}, lut_stream_gemm "
        f"{counts['lut_stream_gemm']}; sync-debug warnings {len(sync_warnings)} (the token "
        f"fetches); admissions {eng.admissions}; the serve's state {state_bytes:,} B (f32) at "
        f"max_seq {DS_MAX_SEQ} and {long_bytes:,} B at {RW_LONG_SEQ} (from the shapes "
        f"{want_state:,} B); tokens crc32 {digest:08x}")

    caches = eng._new_cache()
    toks = torch.randint(0, cfg.vocab_size, (4, DS_PROMPT), device=dev, dtype=torch.int32)
    pad = torch.zeros((4,), dtype=torch.int32, device=dev)
    tok, pos = toks[:, -1:], torch.full((4,), DS_PROMPT, dtype=torch.int32, device=dev)
    prefill = lambda: model.prefill(params, toks, caches, pad_len=pad)            # noqa: E731
    short = lambda: model.prefill(params, toks[:, :RW_PROFILED], caches, pad_len=pad)  # noqa: E731
    step = lambda: model.decode_step(params, tok, caches, pos, pad_len=pad)       # noqa: E731
    prefill_ms = time_ms(torch, lambda i: prefill(), 2)
    short_ms = time_ms(torch, lambda i: short(), 2)
    step_ms = time_ms(torch, lambda i: step(), 5)
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    log(f"phase 19a [{smi}]: prefill B=4 x {DS_PROMPT} tokens {prefill_ms:.2f} ms (B=4 x "
        f"{RW_PROFILED}: {short_ms:.2f} ms); decode step B=4 at {DS_PROMPT} {step_ms:.2f} ms "
        f"({4e3 / step_ms:.1f} tok/s); peak memory {peak_gb:.2f} GB "
        f"(torch.cuda.max_memory_allocated less the {base / 1e9:.2f} GB held before the build)")
    log("phase 19a: where the device time goes (torch.profiler; wall time from the unprofiled "
        "runs above):")
    profiles = {}
    for name, fn, iters, ms, what in (
            ("prefill", short, 1, short_ms, f"prefill B=4 x {RW_PROFILED}"),
            ("decode", step, 3, step_ms, f"decode step B=4 at {DS_PROMPT}")):
        prof = region_breakdown(torch, fn, iters, ms, kernel="lut_dequant_gemm", card=smi,
                                what=what, labels=rwkv_regions())
        if prof is not None:
            shares = {k: v / prof["busy_ms"] for k, v in prof["regions_ms"].items()}
            log(f"  {name}: share of busy: " + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
                + f", lut_dequant_gemm {prof['kernel_ms'] / prof['busy_ms']:.3f}")
            prof["shares"] = shares
        profiles[name] = prof
    out["a"] = dict(
        launches=launches, launches_tc=counts["lut_dequant_gemm_tc"], per_forward=per_forward,
        flash_attention_launches=counts["flash_attention"],
        lut_stream_gemm_launches=counts["lut_stream_gemm"],
        prefills=prefills, decode_steps=steps, host_syncs=eng.host_syncs, waves=len(records),
        wall_s=wall, tokens=n_tok, tok_s=n_tok / wall, tokens_crc32=digest,
        prefill_wall_s=sum(r.t_decode - r.t_start for r in records),
        decode_wall_s=sum(r.t_sync - r.t_decode for r in records),
        prefill_ms=prefill_ms, profiled_prefill_ms=short_ms, step_ms=step_ms, peak_gb=peak_gb,
        held_before_gb=base / 1e9, held_before_gc_gb=before_gc / 1e9, code_bytes=code_bytes,
        param_bytes=param_bytes, dense_bytes=dense_bytes, state_bytes=state_bytes,
        state_bytes_long=long_bytes, build_s=build_s,
        prefill_profile=profiles["prefill"], decode_profile=profiles["decode"])
    del eng, caches, prefill, short, step, params
    torch.cuda.empty_cache()
    lap("19a")

    # --- 19b: W1A3 lut, calibrated + prepared, 4 layers ------------------------
    out["b"] = lut_cut_serve(torch, dev, cfg, RW_LUT_LAYERS, reqs, smi, what="phase 19b",
                             want_per=8 * RW_LUT_LAYERS, drivers=("loop", "chunked"))
    lap("19b")

    # --- 19c: f32, 2 layers: the card against the CPU; prefill vs decode -------
    out["c"] = card_vs_cpu(torch, dev, cfg, RW_CPU_LAYERS, smi, what="phase 19c")
    lap("19c")

    # --- 19d: the kernels against their plain versions at rwkv's shapes -------
    log(f"phase 19d: {cfg.name}'s {len(shapes)} distinct applied projection shapes (K, F) "
        f"{shapes}, B = 4 and 4 x {DS_PROMPT}, bf16 x [{smi}]:")
    rows, rel, abs_err = phase_kernel_times(torch, dev, cfg, hw.H100_SXM, iters=(10, 3, 3),
                                            label="phase 19d", shapes=shapes)
    srows, sabs = phase_stream_times(torch, dev, cfg, hw.H100_SXM, smi, shapes=shapes,
                                     label="phase 19d")
    out["d"] = dict(shapes=shapes, dequant_rows=rows, dequant_rel=rel, dequant_abs=abs_err,
                    stream_rows=srows, stream_abs=sabs)
    lap("19d")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 19: {out['seconds']:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
        + ")")
    return out


WHISPER = "whisper-large-v3"
WH_MAX_SEQ = 448              # 20a / 20b / 20d: whisper's published decoder context (the caches)
WH_PROMPT = 4                 # 20a: the prompt prefilled with the frames
WH_DECODE = 64                # 20a: greedy decode steps after it
WH_SERVE_LAYERS = 4           # 20a / 20b: 4 encoder + 4 decoder layers (of 32 + 32), to keep
                              # the script in its time limit (each check holds at any depth)
WH_CUT_LAYERS = 2             # 20c: 2 encoder + 2 decoder layers
WH_LUT_LAYERS = 4             # 20d: 4 + 4 layers


def whisper_frames(torch, dev, cfg, batch, *, seed=0, dtype=None):
    """Stub frontend embeddings ``[batch, frontend_seq, frontend_dim]`` from
    ``numpy.random.default_rng(seed)``: f32 (the reference's own input
    dtype) or ``dtype``, on ``dev``."""
    import numpy as np

    f = np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_seq, cfg.frontend_dim), dtype=np.float32)
    t = torch.from_numpy(f).to(dev)
    return t if dtype is None else t.to(dtype)


def whisper_regions():
    """Phase 20's profiler region: the decoder's cross attention
    (``attention.cross_attention``: the f32 ``_attend`` over the cross keys
    and values, with their f32 copies; its ``wq`` / ``wo`` are
    ``lut_dequant_gemm`` launches).  The encoder is profiled alone."""
    from repro_torch.models import attention

    return ((attention, "cross_attention", "cross attention"),)


def encdec_cache_bytes(cfg, batch, max_seq, elem_bytes=2):
    """``(cross, self)`` K/V bytes of the decoder's caches from the shapes:
    ``ck`` / ``cv`` ``[B, frontend_seq, Hkv, hd]`` and ``k`` / ``v`` ``[B,
    max_seq, Hkv, hd]`` a layer."""
    per = 2 * batch * cfg.n_kv_heads * cfg.hd * elem_bytes * cfg.n_layers
    return per * cfg.frontend_seq, per * max_seq


def whisper_flash(torch, dev, cfg, card, smi, *, s=None, causal=False, f32=True,
                  what="phase 20e", shape="the encoder's shape"):
    """flash_attention at the encoder's shape (B = 4, S = T = frontend_seq,
    all heads, no mask: ``causal=False``), bf16 (the tensor cores) and f32
    (the CUDA cores), against its plain version (phase 9's tolerances and,
    in bf16, its row check), timed beside the bound, the plain version and
    ``scaled_dot_product_attention(is_causal=False)``, which computes the
    same function.  ``s``, ``causal`` and ``f32=False`` (bf16 alone) set
    another shape: phase 21d's, a VLM's 256 + 128 positions, causal."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(20)
    b, h, hd = 4, cfg.n_heads, cfg.hd
    s = s or cfg.frontend_seq
    kw = dict(causal=causal)
    rows, worst = [], 0.0
    for dtype, want_route in ((torch.bfloat16, "tc"), (torch.float32, "cuda_core"))[:1 + f32]:
        q, k, v = flash_inputs(torch, dev, gen, b, s, s, h, cfg.n_kv_heads, hd, dtype)
        route = fa.route(dtype, hd)
        check(route == want_route, f"{what}: flash {dtype} hd {hd} routed to {route}")
        before = fa.launches_tc
        got = fa.flash_attention(q, k, v, **flash_kw(kw))
        check((fa.launches_tc - before) == (route == "tc"), f"{what}: flash {dtype} route count")
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), **flash_kw(kw))
        err, scale = flash_err(torch, got, want32.to(dtype))
        tol = TOL_FLASH_BF16 * scale if dtype == torch.bfloat16 else TOL_FLASH_F32 * max(scale, 1.0)
        check(got.shape == q.shape and got.dtype == dtype and err <= tol,
              f"{what}: flash {dtype} at {shape}: max err {err:.3e} > {tol:.3e}")
        row = flash_row_err(got, want32) if dtype == torch.bfloat16 else None
        check(row is None or row <= TOL_FLASH_BF16_ROW,
              f"{what}: flash bf16 row error {row} > {TOL_FLASH_BF16_ROW}")
        worst = max(worst, err)
        del got, want32
        kern = time_ms(torch, lambda i: fa.flash_attention(q, k, v, **flash_kw(kw)), 5)
        plain = time_ms(torch, lambda i: ref.flash_attention_ref(q, k, v, **flash_kw(kw)), 2)
        lib_name, lib_fn = library_fn(torch, q, k, v, kw)
        lerr, lscale = flash_err(torch, lib_fn(), ref.flash_attention_ref(q, k, v, **flash_kw(kw)))
        check(lerr <= (TOL_FLASH_BF16 if dtype == torch.bfloat16 else TOL_FLASH_F32) *
              max(lscale, 1.0), f"{what}: {lib_name} != plain ({dtype}): {lerr:.3e}")
        lib = time_ms(torch, lambda i: lib_fn(), 10)
        elem = 2 if dtype == torch.bfloat16 else 4
        bnd, by = flash_bound_s(b, s, s, h, cfg.n_kv_heads, hd, kw, elem, card)
        tflops = flash_ops(b, s, s, h, hd, kw) / (kern * 1e-3) / 1e12
        rows.append(dict(shape=shape, dtype=str(dtype).split(".")[-1], B=b, S=s, T=s,
                         H=h, Hkv=cfg.n_kv_heads, hd=hd, causal=causal, route=route, ms=kern,
                         tflops=tflops, bound_fraction=bnd * 1e3 / kern, plain_ms=plain,
                         bound_ms=bnd * 1e3, bound_by=by, library=lib_name, library_ms=lib,
                         library_max_abs_err=lerr, max_abs_err=err, row_err=row))
        log(f"  flash_attention, {shape} B={b} S=T={s} H={h} hd={hd} causal={causal} "
            f"{rows[-1]['dtype']}: kernel ({route}) {kern:.3f} ms = {tflops:.1f} TFLOP/s, "
            f"{bnd * 1e3 / kern:.3f} of its bound {bnd * 1e3:.4f} ms ({by}); plain {plain:.3f} "
            f"ms, {lib_name} {lib:.3f} ms; max err vs plain {err:.3e}"
            + ("" if row is None else f", row err {row:.3e}") + f" [{smi}]")
        del q, k, v, lib_fn
        torch.cuda.empty_cache()
    return rows, worst


def phase_whisper(torch, dev, smi):
    """Phase 20: whisper-large-v3 (32 encoder + 32 decoder layers, d_model
    1280, 20 heads of 64, d_ff 5120, vocab 51872; the stub frontend's
    1500 frames of 1280) at its published widths, the encoder-decoder path.

    20a, the transcription path, at :data:`WH_SERVE_LAYERS` + as many layers
    (of 32 + 32): W4A4 ``pallas`` prepared, bf16,
    ``attn_impl="flash"``, bf16 caches at ``max_seq`` 448, B = 4: a
    4-token prompt prefilled with bf16 frames ``[4, 1500, 1280]``
    (``Model.prefill(prefix_embeds=)``), then 64 greedy ``decode_step``s.
    Launches: the prefill 6 a layer (encoder) + 10 a layer (decoder)
    ``lut_dequant_gemm`` and one ``flash_attention`` an encoder layer
    (non-causal), all on the tensor cores; each step 8 ``lut_dequant_gemm`` a
    decoder layer and no flash; no ``lut_stream_gemm``.  The
    cross caches' bytes equal the count from the shapes.  ``encode`` alone,
    the prefill and the decode step on CUDA events; busy, idle and the
    shares of the encoder attention, the encoder GEMMs and the cross
    attention from the profiler; tok/s; peak memory; build + prepare.  20b:
    the same tree through ``ServeEngine(batch=4, max_seq=448)`` on phase
    17's requests, text only as the reference serves (a zero cross cache:
    the encoder and the cross ``wk`` / ``wv`` never run): exact token
    counts, one host sync a wave and no other synchronizing call, 8
    ``lut_dequant_gemm`` launches a decoder layer a forward on the tensor
    cores, counted from the tree by path, no flash.  20c, f32 frames (the reference's own
    input dtype) on a 2 + 2-layer copy: the encoder's launches and the cross
    ``wk`` / ``wv`` that read its f32 output take both kernels' CUDA-core
    routes, the bf16 decoder the tensor cores (bf16 frames: every launch on
    the tensor cores); then in f32 the card against the CPU (the plain
    versions) for a prefill with frames, and a prefill of S tokens against
    one of S - 8 and 8 decode steps, each within 1e-4 x max |logit|.  20d:
    W1A3 ``lut`` p=4 on a 4 + 4-layer copy, calibrated with frames and
    prepared: ``lut_stream_gemm`` and canonicalize launches per route
    through ``ServeEngine`` (scan == loop == chunked) and on the
    transcription path.  20e: the 3 distinct applied shapes at B = 4 and 4
    x 1500 through phases 2 and 6's sweeps, and ``flash_attention`` at the
    encoder's shape in bf16 and f32 beside its bound and
    ``scaled_dot_product_attention``."""
    from repro_torch import hw, tree
    from repro_torch.configs import get_config
    from repro_torch.core import LutLinearSpec
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.serve.serving import Request, ServeEngine
    from repro_torch.tune.plan import quantized_leaf_items
    import numpy as np

    t_phase = time.perf_counter()
    laps = {}

    def lap(what):
        laps[what] = time.perf_counter() - t_phase - sum(laps.values())

    cfg = dataclasses.replace(get_config(WHISPER), attn_impl="flash", n_layers=WH_SERVE_LAYERS,
                              encoder_layers=WH_SERVE_LAYERS)
    out = {"laps_s": laps}
    want_frames = 6 * cfg.encoder_layers + 10 * cfg.n_layers
    want_step = 8 * cfg.n_layers

    # --- 20a: the transcription path, WH_SERVE_LAYERS + WH_SERVE_LAYERS layers --
    model = build_model(cfg)
    before_gc, base = held_before_build(torch, dev, "phase 20a")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.prepare(model.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"), seed=0,
                                                device=dev), n_hint=4)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    code_bytes = sum(leaf.codes.numel() for _p, leaf in quantized_leaf_items(params))
    param_bytes = sum(t.numel() * t.element_size() for t in tree.tensors(params))
    per_frames, by_path = applied_projections(params, frames=True)
    per_step, _ = applied_projections(params)
    shapes = projection_shapes(params)
    check(per_frames == want_frames and per_step == want_step,
          f"phase 20a: {per_frames} applied projections a forward with frames (want "
          f"{want_frames}), {per_step} without (want {want_step})")
    log(f"phase 20a: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} x "
        f"{cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab_size} layers {cfg.encoder_layers} + "
        f"{cfg.n_layers} {transformer.segments(cfg)}, frames {cfg.frontend_seq} x "
        f"{cfg.frontend_dim}, W4A4 pallas, bf16, attn_impl=flash, built + prepared in "
        f"{build_s:.1f} s; codes {code_bytes:,} B, parameters {param_bytes:,} B, "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on the card; {per_frames} applied "
        f"projections a forward with frames, {per_step} without "
        f"({', '.join(f'{p.split('/', 1)[-1]} x{n}' for p, (n, _k, _f) in by_path.items())})")
    frames = whisper_frames(torch, dev, cfg, 4, seed=0, dtype=torch.bfloat16)
    caches = model.init_cache(4, WH_MAX_SEQ, torch.bfloat16, device=dev)
    units = [seg["s0_C"] for seg in caches]
    cross_b = sum(u[k].numel() * u[k].element_size() for u in units for k in ("ck", "cv"))
    self_b = sum(u[k].numel() * u[k].element_size() for u in units for k in ("k", "v"))
    want_cross, want_self = encdec_cache_bytes(cfg, 4, WH_MAX_SEQ)
    check(cross_b == want_cross and self_b == want_self,
          f"phase 20a: cross caches {cross_b:,} B, self {self_b:,} B; from the shapes "
          f"{want_cross:,} / {want_self:,} B")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, WH_PROMPT)).astype(np.int32)).to(dev)
    reset_launches()
    (lg, _), first_prefill_ms = once_ms(
        torch, lambda: model.prefill(params, toks, caches, prefix_embeds=frames))
    pc = read_launches()
    check(pc["lut_dequant_gemm"] == want_frames and pc["lut_dequant_gemm_tc"] == want_frames
          and pc["flash_attention"] == cfg.encoder_layers
          and pc["flash_attention_tc"] == cfg.encoder_layers
          and pc["lut_stream_gemm"] == 0 and pc["lut_stream_gemm_canon"] == 0,
          f"phase 20a: the prefill with frames launched {pc}; want {want_frames} "
          f"lut_dequant_gemm and {cfg.encoder_layers} flash_attention, all on the tensor cores")
    check(bool(torch.isfinite(lg).all()) and lg.shape == (4, 1, cfg.vocab_size),
          f"phase 20a: prefill logits {tuple(lg.shape)} or not finite")
    check(all(bool(u[k].any()) for u in units for k in ("ck", "cv")),
          "phase 20a: a cross cache is still zero after the prefill with frames")
    tok = lg[:, -1:].argmax(-1).to(torch.int32)
    gen_toks = [tok]
    reset_launches()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(WH_DECODE):
        lg, _ = model.decode_step(params, tok, caches, WH_PROMPT + i)
        tok = lg[:, -1:].argmax(-1).to(torch.int32)
        gen_toks.append(tok)
    end.record()
    torch.cuda.synchronize()
    dc = read_launches()
    loop_ms = start.elapsed_time(end)
    out_toks = torch.cat(gen_toks, dim=1).cpu()
    check(dc["lut_dequant_gemm"] == want_step * WH_DECODE
          and dc["lut_dequant_gemm_tc"] == want_step * WH_DECODE
          and dc["flash_attention"] == 0 and dc["lut_stream_gemm"] == 0,
          f"phase 20a: {WH_DECODE} decode steps launched {dc}; want {want_step} "
          f"lut_dequant_gemm a step on the tensor cores and no flash")
    check(bool(torch.isfinite(lg).all()) and bool(((out_toks >= 0) & (out_toks < cfg.vocab_size))
                                                  .all()), "phase 20a: decode logits or tokens")
    digest = zlib.crc32(json.dumps(out_toks.tolist()).encode())
    encode_ms = time_ms(torch, lambda i: transformer.encode(params, cfg, frames), 2)
    prefill = lambda: model.prefill(params, toks, caches, prefix_embeds=frames)  # noqa: E731
    pos_t = WH_PROMPT + WH_DECODE
    step = lambda: model.decode_step(params, tok, caches, pos_t)                 # noqa: E731
    prefill_ms = time_ms(torch, lambda i: prefill(), 2)
    step_ms = time_ms(torch, lambda i: step(), 5)
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    n_tok = 4 * WH_DECODE
    log(f"phase 20a [{smi}]: prefill of B=4 x {WH_PROMPT} tokens over 4 x {cfg.frontend_seq} "
        f"bf16 frames: {pc['lut_dequant_gemm']} lut_dequant_gemm launches (tensor cores "
        f"{pc['lut_dequant_gemm_tc']}), {pc['flash_attention']} flash_attention (causal=False; "
        f"tensor cores {pc['flash_attention_tc']}); {WH_DECODE} greedy decode steps: "
        f"{dc['lut_dequant_gemm']} lut_dequant_gemm launches (= {want_step} x {WH_DECODE}, "
        f"tensor cores {dc['lut_dequant_gemm_tc']}), flash {dc['flash_attention']}; "
        f"{loop_ms:.1f} ms for the {WH_DECODE} steps ({n_tok / loop_ms * 1e3:.1f} tok/s); "
        f"encode alone {encode_ms:.2f} ms, prefill {prefill_ms:.2f} ms (first {first_prefill_ms:.2f}), "
        f"decode step at {pos_t} {step_ms:.2f} ms; caches: cross {cross_b:,} B, self {self_b:,} B "
        f"(bf16, = the count from the shapes); peak memory {peak_gb:.2f} GB above the "
        f"{base / 1e9:.2f} GB held before the build; tokens crc32 {digest:08x}")
    log("phase 20a: where the device time goes (torch.profiler; wall time from the unprofiled "
        "runs above):")
    profiles = {}
    encode = lambda: transformer.encode(params, cfg, frames)                    # noqa: E731
    for name, fn, iters, ms, labels, what in (
            ("encode", encode, 1, encode_ms, (), f"encode alone, B=4 x {cfg.frontend_seq} frames"),
            ("prefill", prefill, 1, prefill_ms, whisper_regions(),
             f"prefill B=4 x {WH_PROMPT} with frames"),
            ("decode", step, 3, step_ms, whisper_regions(), f"decode step B=4 at {pos_t}")):
        prof = region_breakdown(torch, fn, iters, ms, kernel="lut_dequant_gemm", card=smi,
                                what=what, labels=labels)
        if prof is not None and name != "encode":
            parts = {"cross attention (its attend, wq / wo aside)":
                     prof["regions_ms"]["cross attention"],
                     "cross attention's f32 copies": prof["region_copy_ms"]["cross attention"]}
            enc = profiles["encode"]
            if name == "prefill" and enc is not None:
                parts = {"encoder attention": enc["flash_ms"], "encoder GEMMs": enc["kernel_ms"],
                         "encoder rest": enc["busy_ms"] - enc["flash_ms"] - enc["kernel_ms"],
                         **parts}
            prof["parts_ms"] = parts
            prof["shares"] = {k: v / prof["busy_ms"] for k, v in parts.items()}
            log(f"  {name}: " + ", ".join(f"{k} {v:.3f} ms ({prof['shares'][k]:.3f} of busy)"
                                          for k, v in parts.items()))
        profiles[name] = prof
    out["a"] = dict(
        launches_prefill=pc, launches_decode=dc, per_forward_frames=per_frames,
        per_forward=per_step, decode_steps=WH_DECODE, loop_ms=loop_ms,
        tok_s=n_tok / loop_ms * 1e3, tokens_crc32=digest, encode_ms=encode_ms,
        prefill_ms=prefill_ms, first_prefill_ms=first_prefill_ms, step_ms=step_ms,
        peak_gb=peak_gb, held_before_gb=base / 1e9, held_before_gc_gb=before_gc / 1e9,
        code_bytes=code_bytes, param_bytes=param_bytes, cross_cache_bytes=cross_b,
        self_cache_bytes=self_b, build_s=build_s, encode_profile=profiles["encode"],
        prefill_profile=profiles["prefill"], decode_profile=profiles["decode"])
    del caches, units, prefill, step, encode, frames
    torch.cuda.empty_cache()
    lap("20a")

    # --- 20b: the same tree served, text only -------------------------------
    eng = ServeEngine(model, params, batch=4, max_seq=WH_MAX_SEQ, decode="scan", device=dev)
    lens, reqs = bucket_led_requests(cfg)
    eng.generate([Request(prompt=reqs[0].prompt[:16], max_new_tokens=2)])   # warmup
    torch.cuda.synchronize()
    outs, wall, records, counts, sync_warnings = counted_generate(torch, eng, reqs)
    prefills, steps, launches = check_served(cfg, eng, outs, DS_NEW, records, counts,
                                             sync_warnings, kernel="lut_dequant_gemm",
                                             what="phase 20b")
    check(launches == want_step * (prefills + steps),
          f"phase 20b: {launches} launches, want {want_step} x {prefills + steps}")
    sdigest = zlib.crc32(json.dumps([list(map(int, o)) for o in outs]).encode())
    n_served = sum(len(o) for o in outs)
    log(f"phase 20b [{smi}]: ServeEngine(batch=4, max_seq={WH_MAX_SEQ}) served {len(reqs)} "
        f"requests (prompt lengths {lens.tolist()}; no frames: the reference's Request has "
        f"none), {n_served} tokens in {wall:.3f} s ({n_served / wall:.1f} tok/s); "
        f"{len(records)} waves, {prefills} prefills, {steps} decode steps, {eng.host_syncs} host "
        f"syncs; {launches} lut_dequant_gemm launches (= {per_step} x {prefills + steps}, all on "
        f"the tensor cores; the encoder's {per_frames - per_step - 2 * cfg.n_layers} leaves and "
        f"the cross wk / wv never run), flash_attention {counts['flash_attention']}; "
        f"sync-debug warnings {len(sync_warnings)}; tokens crc32 {sdigest:08x}")
    out["b"] = dict(launches=launches, launches_tc=counts["lut_dequant_gemm_tc"],
                    flash_attention_launches=counts["flash_attention"], per_forward=per_step,
                    prefills=prefills, decode_steps=steps, host_syncs=eng.host_syncs,
                    waves=len(records), wall_s=wall, tokens=n_served, tok_s=n_served / wall,
                    tokens_crc32=sdigest)
    del eng, params
    torch.cuda.empty_cache()
    lap("20b")

    # --- 20c: f32 frames; the card against the CPU -------------------------
    ccfg = dataclasses.replace(cfg, n_layers=WH_CUT_LAYERS, encoder_layers=WH_CUT_LAYERS)
    cmodel = build_model(ccfg)
    cparams = cmodel.prepare(cmodel.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"),
                                                   seed=2, device=dev), n_hint=4)
    enc_n = 6 * WH_CUT_LAYERS + 2 * WH_CUT_LAYERS     # the encoder's and the cross wk / wv
    dec_n = 8 * WH_CUT_LAYERS
    routes = {}
    for fname, fdt, want_cc in (("f32 frames", torch.float32, enc_n),
                                ("bf16 frames", torch.bfloat16, 0)):
        cc = cmodel.init_cache(2, WH_MAX_SEQ, torch.bfloat16, device=dev)
        fr = whisper_frames(torch, dev, ccfg, 2, seed=2, dtype=fdt)
        reset_launches()
        lgc, _ = cmodel.prefill(cparams, toks[:2], cc, prefix_embeds=fr)
        p_cnt = read_launches()
        reset_launches()
        cmodel.decode_step(cparams, lgc[:, -1:].argmax(-1).to(torch.int32), cc, WH_PROMPT)
        d_cnt = read_launches()
        fl_cc = p_cnt["flash_attention"] - p_cnt["flash_attention_tc"]
        check(p_cnt["lut_dequant_gemm"] == enc_n + dec_n
              and p_cnt["lut_dequant_gemm"] - p_cnt["lut_dequant_gemm_tc"] == want_cc
              and p_cnt["flash_attention"] == WH_CUT_LAYERS
              and fl_cc == (WH_CUT_LAYERS if fdt == torch.float32 else 0)
              and d_cnt["lut_dequant_gemm"] == d_cnt["lut_dequant_gemm_tc"] == dec_n
              and d_cnt["flash_attention"] == 0,
              f"phase 20c, {fname}: prefill launches {p_cnt}, decode {d_cnt}; want {want_cc} "
              f"of {enc_n + dec_n} lut_dequant_gemm and "
              f"{WH_CUT_LAYERS if fdt == torch.float32 else 0} of {WH_CUT_LAYERS} flash on the "
              f"CUDA cores, a decode step's {dec_n} on the tensor cores")
        routes[fname] = dict(prefill=p_cnt, decode=d_cnt)
        log(f"phase 20c, {fname} (bf16 model, {WH_CUT_LAYERS} + {WH_CUT_LAYERS} layers): a "
            f"prefill with frames launched lut_dequant_gemm {p_cnt['lut_dequant_gemm']} "
            f"(CUDA cores {p_cnt['lut_dequant_gemm'] - p_cnt['lut_dequant_gemm_tc']}: the "
            f"encoder's and the cross wk / wv that read its output; tensor cores "
            f"{p_cnt['lut_dequant_gemm_tc']}), flash_attention {p_cnt['flash_attention']} (CUDA "
            f"cores {fl_cc}); a decode step lut_dequant_gemm {d_cnt['lut_dequant_gemm']} (tensor "
            f"cores {d_cnt['lut_dequant_gemm_tc']})")
        del cc, fr, lgc
    del cparams
    torch.cuda.empty_cache()
    out["c"] = dict(routes=routes, **card_vs_cpu(torch, dev, cfg, WH_CUT_LAYERS, smi,
                                                 what="phase 20c"))
    lap("20c")

    # --- 20d: W1A3 lut, calibrated with frames, 4 + 4 layers ---------------
    dres, lmodel, lparams, lframes = lut_cut_serve(
        torch, dev, cfg, WH_LUT_LAYERS, reqs, smi, what="phase 20d", want_per=8 * WH_LUT_LAYERS,
        drivers=("loop", "chunked"), max_seq=WH_MAX_SEQ, keep=True)
    lc = lmodel.init_cache(2, WH_MAX_SEQ, torch.bfloat16, device=dev)
    reset_launches()
    llg, _ = lmodel.prefill(lparams, toks[:2], lc, prefix_embeds=lframes)
    lp = read_launches()
    reset_launches()
    llg2, _ = lmodel.decode_step(lparams, llg[:, -1:].argmax(-1).to(torch.int32), lc, WH_PROMPT)
    ld = read_launches()
    lwant_p, lwant_d = 16 * WH_LUT_LAYERS, 8 * WH_LUT_LAYERS
    for what, cnt, want_n, want_fl in (("prefill with frames", lp, lwant_p, WH_LUT_LAYERS),
                                       ("decode step", ld, lwant_d, 0)):
        check(cnt["lut_stream_gemm"] == cnt["lut_stream_gemm_tc"] == want_n
              and cnt["lut_stream_gemm_canon"] == want_n and cnt["lut_stream_gemm_lookup"] == 0
              and cnt["lut_dequant_gemm"] == 0 and cnt["flash_attention"] == want_fl
              and cnt["flash_attention_tc"] == want_fl,
              f"phase 20d, the transcription path's {what}: launches {cnt}; want {want_n} "
              f"lut_stream_gemm on the tensor cores, as many canonicalizations, {want_fl} flash")
    check(bool(torch.isfinite(llg).all() and torch.isfinite(llg2).all()),
          "phase 20d: transcription-path logits not finite")
    log(f"phase 20d: the transcription path on the {WH_LUT_LAYERS} + {WH_LUT_LAYERS}-layer W1A3 "
        f"tree: a prefill with 2 x {cfg.frontend_seq} bf16 frames launched lut_stream_gemm "
        f"{lp['lut_stream_gemm']} (tensor cores {lp['lut_stream_gemm_tc']}, lookup "
        f"{lp['lut_stream_gemm_lookup']}), canonicalize {lp['lut_stream_gemm_canon']}, "
        f"flash_attention {lp['flash_attention']} (tensor cores {lp['flash_attention_tc']}); a "
        f"decode step lut_stream_gemm {ld['lut_stream_gemm']} (tensor cores "
        f"{ld['lut_stream_gemm_tc']}), canonicalize {ld['lut_stream_gemm_canon']}")
    out["d"] = dict(serve=dres, transcription_prefill=lp, transcription_decode=ld)
    del lparams, lc, lframes, llg, llg2
    torch.cuda.empty_cache()
    lap("20d")

    # --- 20e: the kernels at whisper's shapes ------------------------------
    rows_b = 4 * cfg.frontend_seq
    log(f"phase 20e: {cfg.name}'s {len(shapes)} distinct applied projection shapes (K, F) "
        f"{shapes}, B = 4 and 4 x {cfg.frontend_seq} (the encoder's rows), bf16 x [{smi}]:")
    rows, rel, abs_err = phase_kernel_times(torch, dev, cfg, hw.H100_SXM, bs=(4, rows_b),
                                            iters=(10, 3, 3), label="phase 20e", shapes=shapes)
    srows, sabs = phase_stream_times(torch, dev, cfg, hw.H100_SXM, smi, shapes=shapes,
                                     label="phase 20e", bs=(4, rows_b))
    frows, fabs = whisper_flash(torch, dev, cfg, hw.H100_SXM, smi)
    out["e"] = dict(shapes=shapes, rows_b=rows_b, dequant_rows=rows, dequant_rel=rel,
                    dequant_abs=abs_err, stream_rows=srows, stream_abs=sabs, flash_rows=frows,
                    flash_abs=fabs)
    lap("20e")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 20: {out['seconds']:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
        + ")")
    return out


# ---------------------------------------------------------------------------
# Phase 21: internvl2-1b whole (the stub vision frontend) served, and trained
# at full width (repro_torch.train, repro_torch.data, run_supervised)
# ---------------------------------------------------------------------------

VLM = "internvl2-1b"
VL_TEXT = 128                 # 21a: the cache-free forward's tokens after the 256 patches
VL_PROMPT = 32                # 21a: the prefill's tokens after the patches
VL_DECODE = 64                # 21a: greedy decode steps after it
VL_MAX_SEQ = 512              # 21a: the caches (256 + 32 + 64 positions used)
VL_SERVE_LAYERS = 6           # 21a: depth (of 24), to keep the script in its time limit
                              # (21e trains all 24)
VL_CUT_LAYERS = 2             # 21b: the f32 copy, card vs CPU
VL_LUT_LAYERS = 4             # 21c: the W1A3 copy
VL_TRAIN_BATCH = 4            # 21e: B, text tokens a row (after 256 patches), steps, and the
VL_TRAIN_SEQ = 512            # supervisor's checkpoint period and injected failure
VL_TRAIN_STEPS = 10
VL_CKPT_EVERY = 4
VL_FAIL_AT = 6
VL_TRAIN_LR = 5e-4            # 21e: AdamW, warmed up over 3 steps, on the learnable stream
VL_TRAIN_WARMUP = 3           # (PatternLM): a 10-step run whose loss must fall
TOL_RESTART = 1e-6            # 21e: the reference's restart tolerance (tests/test_fault_tolerance.py)


def train_bound_ms(params, cfg, b, s, card):
    """The least time of one training step on the card: the operations of
    forward + backward at the bf16 peak (6 x the multiply-adds' 2 FLOPs'
    worth: the units' matrices over all B x (P + S) positions, the LM head
    over the B x S text positions, ``frontend_proj`` over the B x P patches,
    and the causal attention's two products over its visible pairs, x 3 for
    the backward), no recomputation counted.  Returns ``(ms, flops)``."""
    p = cfg.frontend_seq
    length = p + s
    from repro_torch import tree

    n_seg = sum(t.numel() for t in tree.tensors(params["segments"]) if t.ndim == 3)
    head = params["lm_head"]["w"] if "lm_head" in params else params["embed"]
    flops = 6 * (n_seg * b * length + head.numel() * b * s
                 + params["frontend_proj"]["w"].numel() * b * p)
    pairs = length * (length + 1) // 2
    flops += 3 * 4 * cfg.hd * pairs * cfg.n_heads * b * cfg.n_layers
    return flops / card.peak_flops_bf16 * 1e3, flops


def timed_ckpt():
    """Wrap ``repro_torch.ckpt.checkpoint``'s ``save`` and ``restore`` (what
    ``run_supervised`` calls) to record each call's seconds and bytes;
    returns ``(records, undo)``."""
    from repro_torch import tree
    from repro_torch.ckpt import checkpoint as ckpt

    records = {"save": [], "restore": []}
    save, restore = ckpt.save, ckpt.restore

    def nbytes(state):
        return sum(t.numel() * t.element_size()
                   for t in tree.tensors(state.params) + tree.tensors(state.opt)
                   + [state.step])

    def timed_save(base, step, state, **kw):
        t0 = time.perf_counter()
        out = save(base, step, state, **kw)
        records["save"].append((time.perf_counter() - t0, nbytes(state)))
        return out

    def timed_restore(*a, **kw):
        import torch

        t0 = time.perf_counter()
        out = restore(*a, **kw)
        torch.cuda.synchronize()
        records["restore"].append((time.perf_counter() - t0, nbytes(out)))
        return out

    ckpt.save, ckpt.restore = timed_save, timed_restore

    def undo():
        ckpt.save, ckpt.restore = save, restore

    return records, undo


def phase_vlm_train(torch, dev, smi):
    """Phase 21: internvl2-1b (24 layers, d_model 896, 14 / 2 heads of 64,
    d_ff 4864, vocab 151664; the stub vision frontend's 256 patches of 1024,
    projected by the dense ``frontend_proj`` and prepended to the tokens) at
    its published widths.

    21a, served: :data:`VL_SERVE_LAYERS` of its 24 layers, W4A4 ``pallas``
    prepared, bf16, ``attn_impl="flash"``.  A cache-free forward over 4 x
    (256 + 128) positions: ``lut_dequant_gemm`` (7 a layer) and
    ``flash_attention`` (one a layer; head dim 64, causal, over 384
    positions) launches, all on the tensor cores;
    ``Model.prefill(prefix_embeds=)`` over 4 x (256 + 32) (the caches'
    first 288 positions), then 64 greedy decode steps at offsets from 288
    (7 ``lut_dequant_gemm`` a layer a step, no flash: the cached attention);
    ``ServeEngine`` text only, as the reference serves (its ``Request``
    carries no patches): 8 requests of 16-128 tokens, 32 new each, one host
    sync a wave.  21b: a 2-layer f32 copy, card against CPU, prefill against
    prefill + decode steps and against the cache-free forward, within 1e-4 x
    max |logit|.  21c: a W1A3 p=4 copy cut to 4 layers, calibrated, served
    (``lut_canon`` and ``lut_stream_gemm`` on the tensor cores; scan ==
    loop == chunked).  21d: the applied shapes through phases 2 and 6's
    sweeps at B = 4 and 4 x 384, and ``flash_attention`` at the forward's
    shape against its plain version and ``scaled_dot_product_attention``.

    21e, trained: f32 parameters, bf16 compute, ``attn_impl="xla"`` (the
    kernels have no backward), each unit checkpointed, the chunked head
    (vocab 151664, 512 text positions: two chunks of 256), AdamW; B = 4
    rows of 256 patches + 512 tokens from the learnable counter-based stream.
    10 steps under ``run_supervised`` saving every 4 steps with a failure
    injected at step 6 (restored from step 4), beside a clean run of the same
    10 steps: the loss finite and falling, the parameters moved, the steps
    after the restart and the final state equal to the clean run's within
    the reference's rtol 1e-6, no kernel launched, and a ``"flash"`` config
    refusing to train.  Step time on CUDA events, tokens/s, the share of the
    bound (:func:`train_bound_ms`), the optimizer's time, the checkpoint's
    save and restore seconds and GB/s, peak memory."""
    import numpy as np

    from repro_torch import hw
    from repro_torch.configs import get_config
    from repro_torch.core import LutLinearSpec
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.serve.serving import ServeEngine

    t_phase = time.perf_counter()
    laps = {}

    def lap(what):
        laps[what] = time.perf_counter() - t_phase - sum(laps.values())

    cfg = dataclasses.replace(get_config(VLM), attn_impl="flash", n_layers=VL_SERVE_LAYERS)
    P = cfg.frontend_seq
    out = {"laps_s": laps}
    want_fwd = 7 * cfg.n_layers

    # --- 21a: served, VL_SERVE_LAYERS layers ---------------------------------
    model = build_model(cfg)
    before_gc, base = held_before_build(torch, dev, "phase 21a")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.prepare(model.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"), seed=0,
                                                device=dev), n_hint=4)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    per_fwd, by_path = applied_projections(params)
    shapes = projection_shapes(params)
    check(per_fwd == want_fwd and isinstance(params["frontend_proj"], dict),
          f"phase 21a: {per_fwd} applied projections a forward (want {want_fwd}); "
          f"frontend_proj must stay dense")
    log(f"phase 21a: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} x "
        f"{cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab_size} layers {transformer.segments(cfg)}, "
        f"patches {P} x {cfg.frontend_dim}, W4A4 pallas, bf16, attn_impl=flash, built + "
        f"prepared in {build_s:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on the "
        f"card; {per_fwd} applied projections a forward")
    patches = whisper_frames(torch, dev, cfg, 4, seed=0)        # f32: cast by the model
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, VL_TEXT)).astype(np.int32)).to(dev)
    reset_launches()
    (flg, _), first_fwd_ms = once_ms(
        torch, lambda: model.forward(params, toks, prefix_embeds=patches))
    fc = read_launches()
    check(fc["lut_dequant_gemm"] == fc["lut_dequant_gemm_tc"] == want_fwd
          and fc["flash_attention"] == fc["flash_attention_tc"] == cfg.n_layers
          and fc["lut_stream_gemm"] == 0,
          f"phase 21a: the forward with patches launched {fc}; want {want_fwd} lut_dequant_gemm "
          f"and {cfg.n_layers} flash_attention, all on the tensor cores")
    check(flg.shape == (4, P + VL_TEXT, cfg.vocab_size) and bool(torch.isfinite(flg).all()),
          f"phase 21a: forward logits {tuple(flg.shape)} or not finite")
    del flg
    fwd = lambda: model.forward(params, toks, prefix_embeds=patches,          # noqa: E731
                                last_token_only=True)
    fwd_ms = time_ms(torch, lambda i: fwd(), 3)
    caches = model.init_cache(4, VL_MAX_SEQ, torch.bfloat16, device=dev)
    ptoks = toks[:, :VL_PROMPT]
    reset_launches()
    (lg, _), first_prefill_ms = once_ms(
        torch, lambda: model.prefill(params, ptoks, caches, prefix_embeds=patches))
    pc = read_launches()
    k0 = caches[0]["s0_D"]["k"]
    check(pc["lut_dequant_gemm"] == pc["lut_dequant_gemm_tc"] == want_fwd
          and pc["flash_attention"] == 0 and lg.shape == (4, 1, cfg.vocab_size)
          and bool(k0[:, :, P + VL_PROMPT - 1].any()) and not bool(k0[:, :, P + VL_PROMPT:].any()),
          f"phase 21a: the prefill with patches launched {pc} (want {want_fwd} lut_dequant_gemm on "
          f"the tensor cores, no flash: the cached attention) or filled other than {P} + "
          f"{VL_PROMPT} positions")
    tok = lg[:, -1:].argmax(-1).to(torch.int32)
    gen_toks = [tok]
    reset_launches()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(VL_DECODE):
        lg, _ = model.decode_step(params, tok, caches, P + VL_PROMPT + i)
        tok = lg[:, -1:].argmax(-1).to(torch.int32)
        gen_toks.append(tok)
    end.record()
    torch.cuda.synchronize()
    dc = read_launches()
    loop_ms = start.elapsed_time(end)
    out_toks = torch.cat(gen_toks, dim=1).cpu()
    check(dc["lut_dequant_gemm"] == dc["lut_dequant_gemm_tc"] == want_fwd * VL_DECODE
          and dc["flash_attention"] == 0 and dc["lut_stream_gemm"] == 0
          and bool(torch.isfinite(lg).all())
          and bool(((out_toks >= 0) & (out_toks < cfg.vocab_size)).all()),
          f"phase 21a: {VL_DECODE} decode steps launched {dc}; want {want_fwd} lut_dequant_gemm a "
          f"step on the tensor cores, no flash; finite logits")
    digest = zlib.crc32(json.dumps(out_toks.tolist()).encode())
    pos_t = P + VL_PROMPT + VL_DECODE
    prefill = lambda: model.prefill(params, ptoks, caches, prefix_embeds=patches)  # noqa: E731
    step = lambda: model.decode_step(params, tok, caches, pos_t)                   # noqa: E731
    prefill_ms = time_ms(torch, lambda i: prefill(), 3)
    step_ms = time_ms(torch, lambda i: step(), 5)
    log(f"phase 21a [{smi}]: the cache-free forward over 4 x ({P} patches + {VL_TEXT} tokens): "
        f"{fc['lut_dequant_gemm']} lut_dequant_gemm launches (tensor cores "
        f"{fc['lut_dequant_gemm_tc']}), {fc['flash_attention']} flash_attention (hd {cfg.hd}, "
        f"causal, tensor cores {fc['flash_attention_tc']}); {fwd_ms:.2f} ms (first "
        f"{first_fwd_ms:.2f}, last-position head); prefill of 4 x ({P} + {VL_PROMPT}) "
        f"{prefill_ms:.2f} ms (first {first_prefill_ms:.2f}); {VL_DECODE} greedy decode steps at "
        f"offsets from {P + VL_PROMPT}: {dc['lut_dequant_gemm']} lut_dequant_gemm launches (= "
        f"{want_fwd} x {VL_DECODE}), {loop_ms:.1f} ms ({4 * VL_DECODE / loop_ms * 1e3:.1f} "
        f"tok/s), a step at {pos_t} {step_ms:.2f} ms; tokens crc32 {digest:08x}")
    fprof = region_breakdown(torch, fwd, 1, fwd_ms, kernel="lut_dequant_gemm", card=smi,
                             what=f"the forward over 4 x ({P} + {VL_TEXT})", labels=())
    out["a"] = dict(launches_forward=fc, launches_prefill=pc, launches_decode=dc,
                    per_forward=per_fwd, forward_ms=fwd_ms, first_forward_ms=first_fwd_ms,
                    prefill_ms=prefill_ms, first_prefill_ms=first_prefill_ms, step_ms=step_ms,
                    decode_steps=VL_DECODE, loop_ms=loop_ms, tok_s=4 * VL_DECODE / loop_ms * 1e3,
                    tokens_crc32=digest, build_s=build_s, forward_profile=fprof,
                    held_before_gb=base / 1e9, held_before_gc_gb=before_gc / 1e9)
    del caches, prefill, step, fwd, k0, lg
    torch.cuda.empty_cache()
    eng = ServeEngine(model, params, batch=4, max_seq=VL_MAX_SEQ, decode="scan", device=dev)
    lens, reqs = bucket_led_requests(cfg)
    eng.generate([type(reqs[0])(prompt=reqs[0].prompt[:16], max_new_tokens=2)])   # warmup
    torch.cuda.synchronize()
    outs, wall, records, counts, sync_warnings = counted_generate(torch, eng, reqs)
    prefills, steps, launches = check_served(cfg, eng, outs, DS_NEW, records, counts,
                                             sync_warnings, kernel="lut_dequant_gemm",
                                             what="phase 21a serve")
    check(launches == want_fwd * (prefills + steps) and eng.host_syncs == len(records),
          f"phase 21a serve: {launches} launches, {eng.host_syncs} host syncs over "
          f"{len(records)} waves")
    sdigest = zlib.crc32(json.dumps([list(map(int, o)) for o in outs]).encode())
    n_served = sum(len(o) for o in outs)
    log(f"phase 21a [{smi}]: ServeEngine(batch=4, max_seq={VL_MAX_SEQ}) served {len(reqs)} "
        f"requests text only (prompt lengths {lens.tolist()}), {n_served} tokens in {wall:.3f} s "
        f"({n_served / wall:.1f} tok/s); {len(records)} waves, {prefills} prefills, {steps} "
        f"decode steps, {eng.host_syncs} host syncs (one a wave); {launches} lut_dequant_gemm "
        f"launches (= {per_fwd} x {prefills + steps}, all on the tensor cores); sync-debug "
        f"warnings {len(sync_warnings)}; tokens crc32 {sdigest:08x}")
    out["a"]["serve"] = dict(launches=launches, launches_tc=counts["lut_dequant_gemm_tc"],
                             prefills=prefills, decode_steps=steps, host_syncs=eng.host_syncs,
                             waves=len(records), wall_s=wall, tokens=n_served,
                             tok_s=n_served / wall, tokens_crc32=sdigest)
    del eng, params, patches
    torch.cuda.empty_cache()
    lap("21a")

    # --- 21b: a 2-layer f32 copy against the CPU and against its forward -----
    out["b"] = card_vs_cpu(torch, dev, cfg, VL_CUT_LAYERS, smi, what="phase 21b")
    lap("21b")

    # --- 21c: W1A3 lut at 4 layers ------------------------------------------
    out["c"] = lut_cut_serve(torch, dev, cfg, VL_LUT_LAYERS, reqs, smi, what="phase 21c",
                             want_per=7 * VL_LUT_LAYERS, drivers=("loop", "chunked"),
                             max_seq=VL_MAX_SEQ)
    lap("21c")

    # --- 21d: the kernels at internvl2-1b's shapes -------------------------
    rows_b = 4 * (P + VL_TEXT)
    log(f"phase 21d: {cfg.name}'s {len(shapes)} distinct applied projection shapes (K, F) "
        f"{shapes}, B = 4 and 4 x ({P} + {VL_TEXT}), bf16 x [{smi}]:")
    rows, rel, abs_err = phase_kernel_times(torch, dev, cfg, hw.H100_SXM, bs=(4, rows_b),
                                            iters=(10, 3, 3), label="phase 21d", shapes=shapes)
    srows, sabs = phase_stream_times(torch, dev, cfg, hw.H100_SXM, smi, shapes=shapes,
                                     label="phase 21d", bs=(4, rows_b))
    frows, fabs = whisper_flash(torch, dev, cfg, hw.H100_SXM, smi, s=P + VL_TEXT, causal=True,
                                f32=False, what="phase 21d",
                                shape=f"the VLM forward's shape ({P} patches + {VL_TEXT} tokens)")
    out["d"] = dict(shapes=shapes, rows_b=rows_b, dequant_rows=rows, dequant_rel=rel,
                    dequant_abs=abs_err, stream_rows=srows, stream_abs=sabs, flash_rows=frows,
                    flash_abs=fabs)
    lap("21d")

    # --- 21e: training at full width -----------------------------------------
    out["e"] = vlm_train(torch, dev, smi)
    lap("21e")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 21: {out['seconds']:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
        + ")")
    return out


def vlm_train(torch, dev, smi):
    """Phase 21e (see :func:`phase_vlm_train`)."""
    import shutil

    import numpy as np

    from repro_torch import hw, tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, PatternLM, to_device
    from repro_torch.ft import supervisor as sup
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg = get_config(VLM)
    check(cfg.attn_impl == "xla" and cfg.dtype == "bfloat16", f"phase 21e: {cfg.name} config")
    model = build_model(cfg)
    P, B, S = cfg.frontend_seq, VL_TRAIN_BATCH, VL_TRAIN_SEQ
    data = PatternLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                prefix_seq=P, prefix_dim=cfg.frontend_dim))
    ocfg = opt.AdamWConfig(lr=VL_TRAIN_LR, warmup_steps=VL_TRAIN_WARMUP)
    step_fn = ts.make_train_step(model, ocfg, remat=True)
    batch_at = lambda i: to_device(data.batch_at(i), dev)                     # noqa: E731
    init = lambda d: ts.init_train_state(model, 0, device=d)                   # noqa: E731
    root = ROOT / "build" / "vlm_train"
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    # The clean run: the train step in a plain loop, each step on CUDA events.
    t0 = time.perf_counter()
    state = init(dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    first_params = state.params
    n_params = sum(t.numel() for t in tree.tensors(state.params))
    state_bytes = sum(t.numel() * t.element_size() for t in
                      tree.tensors(state.params) + tree.tensors(state.opt)) + 4
    reset_launches()
    clean_losses, step_ms = {}, []
    for i in range(VL_TRAIN_STEPS):
        batch = batch_at(i)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step_fn(state, batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        clean_losses[i + 1] = float(m["loss"])
    launched = read_launches()
    check(all(n == 0 for n in launched.values()),
          f"phase 21e: training launched a kernel: {launched} (it runs plain torch autograd)")
    clean = state
    losses = [clean_losses[i] for i in range(1, VL_TRAIN_STEPS + 1)]
    moved = max(float((a - b).abs().max()) for a, b in zip(tree.tensors(first_params),
                                                             tree.tensors(clean.params)))
    del first_params
    check(all(np.isfinite(losses)) and losses[-1] < losses[0]
          and np.mean(losses[-3:]) < np.mean(losses[:3]) and moved > 0,
          f"phase 21e: losses {losses} must be finite and fall; parameters moved by {moved}")
    peak_gb = (torch.cuda.max_memory_allocated(dev) - held) / 1e9

    # The optimizer alone, on one step's gradients.
    (_l, _x), grads = ts.value_and_grad(ts.make_loss_fn(model, remat=True), clean.params,
                                        batch_at(VL_TRAIN_STEPS))
    opt_ms = time_ms(torch, lambda i: opt.apply_updates(clean.params, grads, clean.opt, ocfg), 3)
    del grads

    # The supervised run: saved every 4 steps, killed at step 6, restored from step 4.
    records, undo = timed_ckpt()
    sup_losses = {}
    try:
        t0 = time.perf_counter()
        faulty, restarts = sup.run_supervised(
            cfg=sup.SupervisorConfig(ckpt_dir=str(root / "ckpt"), ckpt_every=VL_CKPT_EVERY),
            init_state_fn=init, train_step_fn=step_fn, batch_at=batch_at,
            n_steps=VL_TRAIN_STEPS,
            injector=sup.FailureInjector(fail_at_steps=(VL_FAIL_AT,)),
            on_metrics=lambda s, m: sup_losses.__setitem__(s, float(m["loss"])), device=dev)
        torch.cuda.synchronize()
        sup_s = time.perf_counter() - t0
    finally:
        undo()
    restored_at = (VL_FAIL_AT // VL_CKPT_EVERY) * VL_CKPT_EVERY
    check(restarts == 1 and len(records["restore"]) == 1 and len(records["save"]) == 3
          and int(faulty.step) == VL_TRAIN_STEPS,
          f"phase 21e: {restarts} restarts, {len(records['save'])} saves, "
          f"{len(records['restore'])} restores, step {int(faulty.step)}")
    after = range(restored_at + 1, VL_TRAIN_STEPS + 1)
    loss_rel = max(abs(sup_losses[s] - clean_losses[s]) / abs(clean_losses[s]) for s in after)
    worst, bit_equal = 0.0, True
    for a, b in zip(tree.tensors(faulty.params) + tree.tensors(faulty.opt),
                    tree.tensors(clean.params) + tree.tensors(clean.opt)):
        if not torch.equal(a, b):
            bit_equal = False
            d = ((a.float() - b.float()).abs() - TOL_RESTART * b.float().abs()).max().item()
            worst = max(worst, d)
    check(loss_rel <= TOL_RESTART and worst <= TOL_RESTART,
          f"phase 21e: after the restart the losses differ from the clean run's by {loss_rel:.3e} "
          f"(relative) and the state by {worst:.3e} beyond rtol {TOL_RESTART}, atol "
          f"{TOL_RESTART}")
    del faulty
    torch.cuda.empty_cache()

    # The kernels have no backward: a "flash" config refuses to train.
    fmodel = build_model(dataclasses.replace(cfg, attn_impl="flash"))
    try:
        ts.make_train_step(fmodel, ocfg, remat=True)(clean, batch_at(0))
        refused = None
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and "no backward" in refused,
          f"phase 21e: training under attn_impl='flash' did not refuse: {refused}")
    del clean
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    bound_ms, flops = train_bound_ms(model.init(0, device="meta"), cfg, B, S, hw.H100_SXM)
    steady = float(np.mean(step_ms[1:]))
    save_s = [s for s, _n in records["save"]]
    restore_s, restore_b = records["restore"][0]
    res = dict(
        batch=B, text_seq=S, patches=P, steps=VL_TRAIN_STEPS, params=n_params,
        state_bytes=state_bytes, init_s=init_s, losses=losses, moved=moved,
        step_ms=step_ms, steady_step_ms=steady, first_step_ms=step_ms[0],
        text_tok_s=B * S / steady * 1e3, positions_s=B * (P + S) / steady * 1e3,
        bound_ms=bound_ms, bound_by="operations", flops=flops, bound_fraction=bound_ms / steady,
        achieved_tflops=flops / (steady * 1e-3) / 1e12, optimizer_ms=opt_ms, peak_gb=peak_gb,
        held_before_gb=held / 1e9, save_s=save_s, save_gb_s=[n / s / 1e9 for s, n in
                                                             records["save"]],
        restore_s=restore_s, restore_gb_s=restore_b / restore_s / 1e9, supervised_s=sup_s,
        restarts=restarts, restored_at=restored_at, restart_loss_rel_err=loss_rel,
        restart_state_excess=worst, restart_bit_equal=bit_equal, flash_refused=(refused or "")[:200])
    log(f"phase 21e [{smi}]: {cfg.name} trained at full width ({n_params:,} f32 parameters, "
        f"bf16 compute, each unit checkpointed, chunked head, AdamW; B={B} x ({P} patches + "
        f"{S} tokens)): losses {[round(x, 4) for x in losses]}; step {steady:.1f} ms (first "
        f"{step_ms[0]:.1f}) = {B * S / steady * 1e3:.0f} text tok/s, "
        f"{B * (P + S) / steady * 1e3:.0f} positions/s, {flops / (steady * 1e-3) / 1e12:.1f} "
        f"TFLOP/s, {bound_ms / steady:.3f} of the bound {bound_ms:.2f} ms (6 N tokens + "
        f"attention at the bf16 peak); optimizer {opt_ms:.2f} ms; peak memory {peak_gb:.2f} GB "
        f"above the {held / 1e9:.2f} GB held before; state {state_bytes / 1e9:.2f} GB saved in "
        f"{', '.join(f'{s:.2f}' for s in save_s)} s "
        f"({', '.join(f'{g:.2f}' for g in res['save_gb_s'])} GB/s), restored in "
        f"{restore_s:.2f} s ({res['restore_gb_s']:.2f} GB/s, the file cache warm); the run "
        f"killed at step {VL_FAIL_AT} and restored from step {restored_at} ({sup_s:.1f} s "
        f"supervised): losses after the restart within {loss_rel:.3e} of the clean run's, the "
        f"final state {'bit-equal' if bit_equal else f'within rtol {TOL_RESTART} (excess {worst:.3e})'}"
        f"; no kernel launched; attn_impl='flash' refuses: {(refused or '')[:80]!r}")
    return res


# ---------------------------------------------------------------------------
# Phase 22: the distribution layer (repro_torch.dist): sharded serving
# ---------------------------------------------------------------------------

DIST_TPS = (2, 4, 8)          # 22b: the TP sizes each projection is cut for
DIST_BS = (4, 4 * 128)        # 22b: rows a call (decode, prefill)
DIST_ITERS = 10               # 22b: timed calls a shard (device time)
DIST_NEW = 16                 # 22a: new tokens a request
DIST_EP_TP = 4                # 22c: the TP size of the expert-parallel layer
DIST_EP_ROWS = (4, 32)        # 22c: B x S tokens through the MoE layer
TOL_DIST_EP = 1e-5            # 22c: the ranks' outputs summed vs the unsharded layer (f32),
                              # relative to max |y|: each token's expert outputs added in
                              # another association


def dist_at(dist_r, mode):
    """Phase 22b's numbers of one mode for the kernels line: per TP size and
    N, the 7 projections' unsharded device ms and their slowest shards'."""
    rows = [r for r in dist_r["b"]["rows"] if r["mode"] == mode]
    return {"at": f"phase 22b: stablelm-12b's 7 projections cut over tp {DIST_TPS} (each "
                  f"rank's shard, W1A3 p=4 lut or W4A4 pallas, bf16 x, prepared), device time, "
                  f"warm L2 (lut: apply_linear, the quantizer + lut_canon + lut_stream_gemm; "
                  f"pallas: the lut_dequant_gemm kernel), the 7 projections summed: full_ms / "
                  f"full_bound_ms the unsharded layer, max_shard_ms the slowest shard of each "
                  f"projection, bound_ms a shard's bound",
            **{f"tp{tp}_n{b}": {
                key: sum(r[key] for r in rows if (r["tp"], r["B"]) == (tp, b))
                for key in ("full_ms", "full_bound_ms", "max_shard_ms", "bound_ms")}
               for tp in DIST_TPS for b in DIST_BS},
            "max_rel_err": max(r["rel_err"] for r in rows)}


def phase_dist(torch, dev, smi):
    """Phase 22: the distribution layer on the card (one H100, so one rank:
    the multi-rank semantics are the CPU tests' 4-rank gloo worlds).

    22a: an NCCL world of 1 (``init_process_group("nccl", store=HashStore())``,
    ``init_device_mesh("cuda", (1, 1), ("data", "model"))``): stablelm-12b
    at published widths cut to :data:`LIVE_LAYERS` layers, W1A3 p=4 lut
    calibrated, cut with ``shard_tree`` (world 1: every leaf whole),
    prepared, and served by ``ServeEngine(ctx=)``: 8 requests of 16-64
    tokens, 16 new each; the tokens equal the same tree served without a
    ctx in this run, the kernel launches equal the applied projections x
    (prefills + steps), one host sync a wave (``set_sync_debug_mode``: the
    wave's token matrix all-gathered over dp by NCCL before it, no other
    synchronizing call).  22d in the same world, on CUDA tensors:
    ``compressed_psum`` within ``scale / 2`` of its input, ``pipeline_apply``
    with one stage equal to ``stage_fn``.  The group is destroyed at the end.

    22b: every rank's shard at full width, at tp 2, 4 and 8 (cut in this
    process with ``shard_tree(coords=)``): stablelm-12b's 7 applied
    projections in W1A3 p=4 ``lut`` and W4A4 ``pallas`` (bf16 x), each shard
    prepared and run through its kernels at N = 4 and 4 x 128, the outputs
    concatenated in rank order: ``lut`` bit-equal to the unsharded layer,
    ``pallas`` within 1e-4 x max |y| (the kernel's f32 output: its K slices
    follow F, and a bf16 rounding of two f32 sums an ulp apart is 2^-8 of
    the value); each shard's route and device ms beside the unsharded
    layer's.

    22c: one MoE layer of deepseek-v2-lite-16b (64 experts top-6, 2 shared,
    published widths, W4A4 experts, f32) under expert parallelism at tp 4:
    each rank's 16 local experts (its ``shard_tree`` cut) dispatched and
    summed in rank order, against the unsharded layer at dropless capacity
    (``capacity_factor`` 64), within 1e-5 x max |y|; each rank's expert
    dequant device ms."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import dist as rd
    from repro_torch.configs import get_config
    from repro_torch.core import LutLinearSpec
    from repro_torch.core.calibrate import calibrate_tree
    from repro_torch.dist.runtime import rows_of
    from repro_torch.launch.mesh import make_stage_mesh
    from repro_torch.models.model import build_model, prepare_params
    from repro_torch.serve.serving import ServeEngine

    held_before_build(torch, dev, "phase 22")
    out = {}
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        ctx = rd.ShardCtx(mesh)
        cfg = dataclasses.replace(get_config("stablelm-12b"), n_layers=LIVE_LAYERS)
        model = build_model(cfg)
        raw = model.init_quantized(LutLinearSpec(mode="lut", **LUT_SPEC), seed=0, device=dev)
        cal = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
                               ).to(dev)
        with torch.no_grad():
            raw = calibrate_tree(lambda probed: model.forward(probed, cal)[0], raw)
        local = prepare_params(rd.shard_tree(raw, rd.param_specs(cfg, raw, ctx), ctx), n_hint=4)
        del raw
        check(rows_of(4, ctx) == slice(0, 4) and ctx.dp_group() is not None,
              "22a: a (1, 1) mesh holds every row and has a dp group")
        _lens, reqs = serve_requests(cfg, 64, DIST_NEW)
        served = {}
        for name, c in (("ctx", ctx), ("plain", None)):
            eng = ServeEngine(model, local, batch=4, max_seq=256, ctx=c, device=dev)
            eng.generate([dataclasses.replace(reqs[0], max_new_tokens=2)])      # warmup
            torch.cuda.synchronize()
            outs, wall, records, counts, sync_warnings = counted_generate(torch, eng, reqs)
            prefills, steps, launches = check_served(
                cfg, eng, outs, DIST_NEW, records, counts, sync_warnings,
                kernel="lut_stream_gemm", what=f"phase 22a ({name})")
            check(counts["lut_stream_gemm_tc"] == launches == counts["lut_stream_gemm_canon"],
                  f"22a ({name}): lut_stream_gemm {counts}: every GEMM on the tensor cores, "
                  f"one canonicalize a projection")
            n_tok = sum(len(o) for o in outs)
            served[name] = dict(outs=outs, launches=launches, prefills=prefills,
                                decode_steps=steps, host_syncs=eng.host_syncs,
                                waves=len(records), wall_s=wall, tok_s=n_tok / wall,
                                tokens_crc32=zlib.crc32(json.dumps(outs).encode()))
            del eng
        check(served["ctx"]["outs"] == served["plain"]["outs"],
              "22a: ServeEngine(ctx=) tokens differ from the same tree served without a ctx")
        out["a"] = {k: {kk: v for kk, v in s.items() if kk != "outs"} for k, s in served.items()}
        log(f"phase 22a [{smi}]: NCCL world of 1, mesh (data 1, model 1); stablelm-12b "
            f"{LIVE_LAYERS} layers W1A3 p=4 lut calibrated, cut by shard_tree and prepared; "
            f"ServeEngine(ctx=) == ServeEngine() tokens (crc32 "
            f"{served['ctx']['tokens_crc32']:08x}); with ctx {served['ctx']['launches']} "
            f"lut_stream_gemm launches ({served['ctx']['prefills']} prefills + "
            f"{served['ctx']['decode_steps']} steps), {served['ctx']['host_syncs']} host syncs = "
            f"waves, {served['ctx']['tok_s']:.1f} tok/s (without: {served['plain']['tok_s']:.1f})")
        del local

        # 22d: the collectives at world 1 over NCCL, on the card.
        gen = torch.Generator(device=dev).manual_seed(22)
        v = torch.randn((4096,), generator=gen, device=dev) * 3.0
        got = rd.compressed_psum(v.clone(), group=ctx.dp_group())
        scale = v.abs().max() / 127.0
        psum_err = (got - v).abs().max().item()
        # One f32 rounding of code x scale beside the code's own rounding.
        check(psum_err <= scale.item() / 2 + v.abs().max().item() * 2.0**-23,
              f"22d: compressed_psum {psum_err:.3e} from its input, more than scale / 2 "
              f"{scale.item() / 2:.3e}")
        stage = make_stage_mesh(1)
        ws = torch.randn((1, 256, 256), generator=gen, device=dev) * 0.06
        xs = torch.randn((6, 8, 256), generator=gen, device=dev)
        stage_fn = lambda w, x: torch.tanh(x @ w)  # noqa: E731
        check(torch.equal(rd.pipeline_apply(stage_fn, ws, xs, stage),
                          torch.stack([stage_fn(ws[0], x) for x in xs])),
              "22d: pipeline_apply with one stage != stage_fn")
        out["d"] = dict(psum_abs_err=psum_err, psum_half_scale=scale.item() / 2)
        log(f"phase 22d: compressed_psum over NCCL (world 1) {psum_err:.3e} from its input "
            f"(scale / 2 = {scale.item() / 2:.3e}); pipeline_apply, one stage == stage_fn")
    finally:
        dist.destroy_process_group()
    out["a_d_s"] = time.perf_counter() - t0
    out["b"] = dist_shards(torch, dev, smi)
    out["c"] = dist_expert_parallel(torch, dev, smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 22: passed in {out['seconds']:.1f} s")
    return out


def dist_shards(torch, dev, smi):
    """22b (:func:`phase_dist`): returns the rows, one per (mode, projection,
    tp, N) — the unsharded layer's device ms, each shard's, and the route."""
    from repro_torch import dist as rd
    from repro_torch.configs import get_config
    from repro_torch.core import LutLinearSpec, apply_linear, quantize_linear
    from repro_torch.core.prepared import prepare_linear
    from repro_torch.kernels import lut_dequant_gemm as dq
    from repro_torch.kernels import lut_stream_gemm as ss
    from repro_torch.kernels import ops

    cfg = get_config("stablelm-12b")
    gen = torch.Generator(device=dev).manual_seed(23)

    def run(leaf, x):
        """The projection as the path runs it: lut through ``apply_linear``
        (quantizer, lut_canon, lut_stream_gemm; integer exact, so its bf16
        output is bit-comparable), pallas through its kernel's f32 output."""
        if leaf.spec.mode == "lut":
            return apply_linear(leaf, x)
        return ops.lut_dequant_gemm(x, leaf.codes, leaf.scale, bw=leaf.spec.bw, k=leaf.k,
                                    grid_kind=leaf.spec.w_kind)

    specs = {"lut": LutLinearSpec(mode="lut", **LUT_SPEC),
             "pallas": LutLinearSpec(bw=4, ba=4, mode="pallas")}
    rows, worst_rel = [], 0.0
    for mode, spec in specs.items():
        for name, (k, f) in layer_shapes(cfg).items():
            w = torch.randn((k, f), generator=gen, device=dev)
            q = quantize_linear(w, spec)
            del w
            full = prepare_linear(q, n_hint=4)
            xs = {b: torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
                  for b in DIST_BS}
            want = {b: run(full, x) for b, x in xs.items()}
            full_ms = {b: device_ms(torch, lambda i, x=x: run(full, x), DIST_ITERS)
                       for b, x in xs.items()}
            for tp in DIST_TPS:
                ctx = rd.ShardCtx(rd.AxisMesh((1, tp), ("data", "model")))
                sp = rd.param_specs(cfg, {name: q}, ctx)
                shards = [prepare_linear(rd.shard_tree({name: q}, sp, ctx,
                                                       coords={"data": 0, "model": r})[name],
                                         n_hint=4) for r in range(tp)]
                check(all(s.f == f // tp for s in shards), f"22b {name}: {f} rows over tp {tp}")
                for b, x in xs.items():
                    before = (ss.launches_tc, dq.launches_tc)
                    got = torch.cat([run(s, x) for s in shards], dim=-1)
                    tc = (ss.launches_tc - before[0], dq.launches_tc - before[1])
                    check(tc == ((tp, 0) if mode == "lut" else (0, tp)),
                          f"22b {mode} {name} tp {tp} N={b}: tensor-core launches {tc}")
                    if mode == "lut":
                        check(torch.equal(got, want[b]),
                              f"22b lut {name} tp {tp} N={b}: shards != the unsharded layer")
                        rel = 0.0
                    else:
                        rel = ((got.float() - want[b].float()).abs().max()
                               / want[b].float().abs().max()).item()
                        check(rel <= TOL_REL, f"22b pallas {name} tp {tp} N={b}: rel err "
                                              f"{rel:.3e} > {TOL_REL}")
                    worst_rel = max(worst_rel, rel)
                    ms = [device_ms(torch, lambda i, s=s, x=x: run(s, x), DIST_ITERS)
                          for s in shards]
                    rows.append(dict(mode=mode, proj=name, K=k, F=f, tp=tp, B=b,
                                     route="tc", full_ms=full_ms[b], shard_ms=ms,
                                     max_shard_ms=max(ms), rel_err=rel,
                                     bound_ms=dist_bound_ms(spec, b, k, f // tp),
                                     full_bound_ms=dist_bound_ms(spec, b, k, f)))
            del q, full
    for mode in specs:
        for tp in DIST_TPS:
            for b in DIST_BS:
                rs = [r for r in rows if (r["mode"], r["tp"], r["B"]) == (mode, tp, b)]
                full = sum(r["full_ms"] for r in rs)
                slow = sum(r["max_shard_ms"] for r in rs)
                bound = sum(r["bound_ms"] for r in rs)
                log(f"phase 22b [{smi}]: {mode} tp {tp} N={b}: the 7 projections' unsharded "
                    f"{full:.4f} ms (bound {sum(r['full_bound_ms'] for r in rs):.4f}), slowest "
                    f"shard each {slow:.4f} ms (bound {bound:.4f}; {full / slow:.2f}x faster a "
                    f"rank; all on the tensor cores): "
                    + ", ".join(f"{r['proj']} {r['full_ms']:.4f} -> "
                                f"{'/'.join(f'{m:.4f}' for m in r['shard_ms'])}" for r in rs))
    log(f"phase 22b: lut shards bit-equal to the unsharded layer, pallas within "
        f"{worst_rel:.3e} x max |y| (tol {TOL_REL}), at tp {DIST_TPS}, N {DIST_BS}")
    return dict(rows=rows, worst_rel=worst_rel)


def dist_bound_ms(spec, b, k, f):
    """The least time of one projection of ``f`` output rows as 22b times
    it: pallas, the kernel (:func:`bound_s`, bf16 x); lut, the
    canonicalization and the tensor-core GEMM (:func:`canon_bound_s` +
    :func:`stream_tc_bound_s`; the activation quantizer's few bytes aside)."""
    from repro_torch import hw

    card = hw.H100_SXM
    if spec.mode == "pallas":
        return bound_s(b, k, f, spec.bw, 2, card)[0] * 1e3
    g, r = -(-k // spec.p), 2 ** (spec.bw * spec.p)
    return (canon_bound_s(k, b, g, r, card)[0] + stream_tc_bound_s(f, g, b, r, card)[0]) * 1e3


def dist_expert_parallel(torch, dev, smi):
    """22c (:func:`phase_dist`)."""
    from repro_torch import dist as rd
    from repro_torch.configs import get_config
    from repro_torch.core import LutLinearSpec
    from repro_torch.models import moe
    from repro_torch.models.model import maybe_dequant, quantize_model

    cfg = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, dtype="float32",
                              moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    e = cfg.moe
    gen = torch.Generator(device=dev).manual_seed(24)
    p = quantize_model({"moe": moe.moe_init(cfg, gen, device=dev)}, cfg,
                       LutLinearSpec(bw=4, ba=4, mode="pallas"))
    x = torch.randn(DIST_EP_ROWS + (cfg.d_model,), generator=gen, device=dev)
    with torch.no_grad():
        want, _ = moe.moe_apply(p["moe"], x, cfg)
        xt = x.reshape(-1, cfg.d_model)
        gates, eidx, _aux = moe._route(xt, p["moe"]["router"]["w"], cfg)
        ctx = rd.ShardCtx(rd.AxisMesh((1, DIST_EP_TP), ("data", "model")))
        sp = rd.param_specs(cfg, p, ctx)
        el = e.n_experts // DIST_EP_TP
        y, ranks = None, []
        for r in range(DIST_EP_TP):
            local = rd.shard_tree(p, sp, ctx, coords={"data": 0, "model": r})["moe"]
            check(local["w_gate"].codes.shape[0] == el, f"22c: rank {r} holds "
                  f"{local['w_gate'].codes.shape[0]} experts, want {el}")
            experts = [maybe_dequant(local[n], x.dtype) for n in ("w_gate", "w_up", "w_down")]
            part = moe._dispatch_compute(xt, gates, eidx, *experts, e_first=r * el,
                                         e_total=e.n_experts, capacity_factor=e.capacity_factor,
                                         act_kind=cfg.ffn_act)
            y = part if y is None else y + part
            ranks.append(device_ms(torch, lambda i, lc=local: [
                maybe_dequant(lc[n], x.dtype) for n in ("w_gate", "w_up", "w_down")], 5))
            del local, experts
        from repro_torch.models import ffn

        y = (y + ffn.ffn_apply(p["moe"]["shared"], x, cfg).reshape(y.shape)).reshape(want.shape)
        full_ms = device_ms(torch, lambda i: [maybe_dequant(p["moe"][n], x.dtype)
                                              for n in ("w_gate", "w_up", "w_down")], 5)
    rel = ((y - want).abs().max() / want.abs().max()).item()
    check(rel <= TOL_DIST_EP, f"22c: EP at tp {DIST_EP_TP} {rel:.3e} from the unsharded layer")
    log(f"phase 22c [{smi}]: deepseek-v2-lite-16b MoE layer ({e.n_experts} experts top-"
        f"{e.top_k}, W4A4, f32, {DIST_EP_ROWS[0]} x {DIST_EP_ROWS[1]} tokens, dropless) under "
        f"EP at tp {DIST_EP_TP}: the ranks' outputs summed {rel:.3e} x max |y| from the "
        f"unsharded layer (tol {TOL_DIST_EP}); expert dequant a rank "
        f"{', '.join(f'{m:.3f}' for m in ranks)} ms, unsharded {full_ms:.3f} ms (device time)")
    return dict(rel_err=rel, rank_dequant_ms=ranks, full_dequant_ms=full_ms)


# ---------------------------------------------------------------------------
# Phase 23: sharded training (repro_torch.dist + repro_torch.train)
# ---------------------------------------------------------------------------

DT_STEPS = 3                  # 23a: steps with the ctx and without, from one seed
DT_ARCH = "chatglm3-6b"       # 23b: published widths, cut to DT_LAYERS layers, f32
DT_LAYERS = 2                 #      (~0.94 G parameters: both ranks' states < 60 GB)
DT_B, DT_S = 2, 256           # 23b: rows and tokens a row of the step's batch
DT_MESHES = ((1, 2), (2, 1))  # 23b: (data, model) meshes of the world of 2
TOL_DT_GRAD = 1e-5            # 23b: a rank's gradient shards vs the local step's, x the
                              # leaf's max |g| (f32 sums over dp and TP partials in another
                              # order; the CPU worlds measure 1.2e-6 .. 3.7e-5, the last
                              # rwkv6's time_mix/u, an ill-conditioned sum)
DT_TIMEOUT_S = 300            # 23b: the two ranks' join (the ranks take ~70 s)


def phase_dist_train(torch, dev, smi):
    """Phase 23: sharded training on the card (one H100).

    23a: an NCCL world of 1 (a ``(data 1, model 1)`` mesh, as 22a builds
    it): internvl2-1b at full width with phase 21e's batch (B = 4 x (256
    patches + 512 tokens), f32 parameters, bf16 compute, each unit
    checkpointed), :data:`DT_STEPS` steps of ``make_train_step(ctx=)``
    bit-equal to as many without a ctx in this run, no kernel launched; the
    stepped state saved with ``save(shardings=)``, its files byte-equal to a
    plain ``save`` of it, and ``restore(shardings=)`` bit-equal to it; step
    ms on CUDA events both ways, save / restore GB/s on the host clock (the
    file cache warm), peak memory.

    23b: a world of 2 sharing the one card: two spawned processes, the gloo
    backend, every tensor on ``cuda:0`` (gloo takes CUDA tensors for
    all_gather, all_reduce SUM / MAX, reduce_scatter and barrier: the
    collectives of this path).  chatglm3-6b at published widths cut to
    :data:`DT_LAYERS` layers, f32: one FSDP + TP step on ``(data 1, model
    2)`` and one on ``(data 2, model 1)``, every rank's gradient shards held
    to the same slices of the local step's gradient on the global batch
    (each rank computes it on the card) within :data:`TOL_DT_GRAD` x the
    leaf's max |g|; then the state
    saved from ``(1, 2)`` and restored on ``(2, 1)``, bit-equal to its
    ``(2, 1)`` shards."""
    out = {}
    t0 = time.perf_counter()
    out["a"] = dist_train_one(torch, dev, smi)
    out["b"] = dist_train_two(torch, dev, smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 23: passed in {out['seconds']:.1f} s")
    return out


def same_bytes(a, b, chunk=1 << 26) -> bool:
    """Whether two files hold the same bytes (read in 64 MB chunks:
    ``filecmp``'s 8 KB reads took 27 s for two 7.57 GB checkpoints)."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(chunk)
            if x != fb.read(chunk):
                return False
            if not x:
                return True


def dist_train_one(torch, dev, smi):
    """23a (:func:`phase_dist_train`)."""
    import shutil

    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import dist as rd
    from repro_torch import tree
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, PatternLM, to_device
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    held_before_build(torch, dev, "phase 23")
    t0 = time.perf_counter()
    root = ROOT / "build" / "dist_train"
    shutil.rmtree(root, ignore_errors=True)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        ctx = rd.ShardCtx(mesh, fsdp=True)
        cfg = get_config(VLM)
        model = build_model(cfg)
        P, B, S = cfg.frontend_seq, VL_TRAIN_BATCH, VL_TRAIN_SEQ
        data = PatternLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                    prefix_seq=P, prefix_dim=cfg.frontend_dim))
        ocfg = opt.AdamWConfig(lr=VL_TRAIN_LR, warmup_steps=VL_TRAIN_WARMUP)
        shardings = rd.to_shardings(ts.train_state_specs(cfg, ctx), mesh)
        steps = {"ctx": ts.make_train_step(model, ocfg, ctx=ctx, remat=True),
                 "plain": ts.make_train_step(model, ocfg, remat=True)}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        states = {"plain": ts.init_train_state(model, 0, device=dev)}
        states["ctx"] = ckpt.place(ts.init_train_state(model, 0, device=dev), shardings)
        losses = {name: [] for name in steps}
        step_ms = {name: [] for name in steps}
        reset_launches()
        for i in range(DT_STEPS):      # the two runs' steps in turns, each first in turn
            batch = to_device(data.batch_at(i), dev)
            for name in (("plain", "ctx") if i % 2 else ("ctx", "plain")):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                states[name], m = steps[name](states[name], batch)
                end.record()
                torch.cuda.synchronize()
                step_ms[name].append(start.elapsed_time(end))
                losses[name].append(float(m["loss"]))
        launched = read_launches()
        check(all(n == 0 for n in launched.values()),
              f"23a: training launched a kernel: {launched}")
        peak_gb = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
        grad_norm = float(m["grad_norm"])
        a = states.pop("ctx")
        leaves = lambda st: ckpt._flatten(st, [])                                # noqa: E731
        check(losses["ctx"] == losses["plain"]
              and all(x.dtype == y.dtype and torch.equal(x, y)
                      for x, y in zip(leaves(a), leaves(states["plain"]))),
              f"23a: {DT_STEPS} steps of make_train_step(ctx=) on a (1, 1) mesh differ from "
              f"the steps without a ctx: losses {losses['ctx']} vs {losses['plain']}")
        del states
        steps_s = time.perf_counter() - t0
        n_bytes = sum(t.numel() * t.element_size() for t in leaves(a))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ckpt.save(str(root / "sharded"), DT_STEPS, a, shardings=shardings)
        save_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        ckpt.save(str(root / "plain"), DT_STEPS, a)
        plain_save_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        step_dir = f"step_{DT_STEPS:09d}"
        names = sorted(os.listdir(root / "plain" / step_dir))
        check(names == sorted(os.listdir(root / "sharded" / step_dir))
              and all(same_bytes(root / "plain" / step_dir / n, root / "sharded" / step_dir / n)
                      for n in names),
              "23a: the sharded save's files differ from the plain save's")
        compare_s = time.perf_counter() - t1
        like = ts.init_train_state(model, 0, device="meta")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = ckpt.restore(str(root / "sharded"), DT_STEPS, like, shardings=shardings,
                            device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        check(all(x.dtype == y.dtype and torch.equal(x, y)
                  for x, y in zip(leaves(back), leaves(a))),
              "23a: restore(shardings=) differs from the saved state")
        del a, back
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    res = dict(
        arch=VLM, batch=B, text_seq=S, patches=P, steps=DT_STEPS,
        losses=losses["ctx"], grad_norm=grad_norm,
        step_ms_ctx=step_ms["ctx"], step_ms_plain=step_ms["plain"],
        steady_ms_ctx=float(np.mean(step_ms["ctx"][1:])),
        steady_ms_plain=float(np.mean(step_ms["plain"][1:])),
        peak_gb=peak_gb, steps_s=steps_s, state_bytes=n_bytes, save_s=save_s,
        save_gb_s=n_bytes / save_s / 1e9, compare_s=compare_s, plain_save_s=plain_save_s, plain_save_gb_s=n_bytes / plain_save_s / 1e9,
        restore_s=restore_s, restore_gb_s=n_bytes / restore_s / 1e9,
        seconds=time.perf_counter() - t0)
    log(f"phase 23a [{smi}]: NCCL world of 1, mesh (data 1, model 1), FSDP on; {VLM} at full "
        f"width trained {DT_STEPS} steps (B={B} x ({P} + {S}), f32 parameters, bf16 compute): "
        f"make_train_step(ctx=) bit-equal to the plain step (losses {res['losses']}), no "
        f"kernel launched; step {res['steady_ms_ctx']:.1f} ms with the ctx, "
        f"{res['steady_ms_plain']:.1f} without (first {res['step_ms_ctx'][0]:.1f} / "
        f"{res['step_ms_plain'][0]:.1f}; the steps in turns); peak {peak_gb:.2f} GB with both "
        f"states held ({steps_s:.1f} s to here); the sharded save of {n_bytes / 1e9:.2f} GB "
        f"byte-equal to the plain save, {save_s:.2f} s ({res['save_gb_s']:.2f} GB/s; plain "
        f"{plain_save_s:.2f} s; the files compared in {compare_s:.2f} s); restore(shardings=) bit-equal, {restore_s:.2f} s "
        f"({res['restore_gb_s']:.2f} GB/s, the file cache warm); {res['seconds']:.1f} s")
    return res


def dist_train_two(torch, dev, smi, *, device="cuda", smoke=False):
    """23b (:func:`phase_dist_train`): spawns the two ranks
    (:func:`dist_train_rank`) and reads their results; every process it
    starts is joined or stopped.  ``device`` / ``smoke`` are for a CPU
    rehearsal of the control flow (``"cpu"``, smoke widths)."""
    import multiprocessing as mp
    import pickle
    import shutil

    t0 = time.perf_counter()
    root = ROOT / "build" / "dist_train2"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    src = sys.path[0]
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=dist_train_rank, args=(r, src, str(root), device, smoke))
             for r in range(2)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(DT_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    results = []
    for r, p in enumerate(procs):
        path = root / f"rank{r}.pkl"
        results.append(pickle.loads(path.read_bytes()) if path.exists() else
                       {"error": f"rank {r} wrote nothing (exit code {p.exitcode})"})
    shutil.rmtree(root, ignore_errors=True)
    errors = [res["error"] for res in results if "error" in res]
    check(not errors, f"23b: {errors}")
    r0 = results[0]
    for key, mesh in zip(("a", "b"), DT_MESHES):
        worst = max(res[key]["grad_rel"] for res in results)
        check(worst <= TOL_DT_GRAD, f"23b {mesh}: a gradient shard {worst:.3e} x its leaf's max "
                                    f"|g| from the local step's (tol {TOL_DT_GRAD}; "
                                    f"{r0[key]['grad_path']})")
    check(all(res["restored_equal"] for res in results),
          "23b: the (1, 2) save restored on (2, 1) differs from the (2, 1) shards")
    res = dict(ranks=results, seconds=time.perf_counter() - t0)
    log(f"phase 23b [{smi}]: a gloo world of 2 on one card, {DT_ARCH} at published widths, "
        f"{DT_LAYERS} layers, f32, B={DT_B} x {DT_S}: the local step's gradient "
        f"{r0['local_ms']:.1f} ms (rank 0; its first call in the process "
        f"{r0['local_ms_runs'][0]:.1f}); " + "; ".join(
            f"{mesh}: grads within {max(x[k]['grad_rel'] for x in results):.3e} x leaf max of "
            f"the local step ({r0[k]['grad_path']}), loss {r0[k]['loss']:.6f} (local "
            f"{r0['local_loss']:.6f}), grads {r0[k]['grads_ms']:.1f} ms + update "
            f"{r0[k]['update_ms']:.1f} ms, peak {max(x[k]['peak_gb'] for x in results):.2f} GB "
            f"a rank" for k, mesh in zip(("a", "b"), DT_MESHES))
        + f"; the initial state saved from (1, 2) ({r0['state_bytes'] / 1e9:.2f} GB, "
          f"{r0['save_s']:.2f} s) and restored on (2, 1) ({max(x['restore_s'] for x in results):.2f}"
          f" s), bit-equal to its (2, 1) shards; {res['seconds']:.1f} s with the processes' "
          f"start; rank 0's seconds by stage "
          + ", ".join(f"{k} {v:.1f}" for k, v in r0["laps"].items()))
    return res


def dist_train_rank(rank, src, root, device, smoke):
    """One rank of 23b: writes ``<root>/rank<r>.pkl`` (its numbers, or the
    traceback, which fails the phase in the parent)."""
    import pickle
    import traceback

    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    res = {}
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"), 2),
                                rank=rank, world_size=2)
        try:
            res = dist_train_shared(torch, torch.device(device, 0) if device == "cuda"
                                    else torch.device(device), rank, root, smoke)
        finally:
            dist.destroy_process_group()
    except BaseException:                   # reported: the parent fails the phase
        res = {"error": f"rank {rank}: {traceback.format_exc()}"}
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def dist_train_shared(torch, dev, rank, root, smoke):
    """23b's body on one rank (:func:`phase_dist_train`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import dist as rd
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.dist.runtime import ShardedRun, rows_of
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak(reset=False):
        if not cuda:
            return 0.0
        if reset:
            torch.cuda.reset_peak_memory_stats(dev)
        return torch.cuda.max_memory_allocated(dev) / 1e9

    cfg = dataclasses.replace(get_config(DT_ARCH, smoke=smoke), n_layers=DT_LAYERS,
                              dtype="float32")
    model = build_model(cfg)
    ocfg = opt.AdamWConfig(lr=1e-3)
    gen = torch.Generator(device=dev).manual_seed(23)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (DT_B, DT_S + 1), generator=gen,
                                     device=dev)}
    laps, t_lap = {}, [time.perf_counter()]

    def lap(what):
        sync()
        now = time.perf_counter()
        laps[what] = now - t_lap[0]
        t_lap[0] = now

    whole = ts.init_train_state(model, 0, device=dev)
    lap("init")
    out = {"laps": laps}
    # The local step's gradient on the global batch, on each rank (twice: the
    # first call in a process loads its kernels, ~9 s, the two ranks together).
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        (loss0, _x), g0 = ts.make_grads_fn(model, remat=True)(whole.params, batch)
        sync()
        out.setdefault("local_ms_runs", []).append((time.perf_counter() - t0) * 1e3)
    out.update(local_ms=out["local_ms_runs"][-1], local_loss=float(loss0))
    lap("local")
    meshes = [init_device_mesh(dev.type, shape, mesh_dim_names=("data", "model"))
              for shape in DT_MESHES]
    ctxs = [rd.ShardCtx(m, fsdp=True) for m in meshes]
    specs = [ts.train_state_specs(cfg, c) for c in ctxs]
    shards = [rd.shard_tree(whole, sp, c) for sp, c in zip(specs, ctxs)]
    del whole
    lap("meshes")
    for key, ctx, sp, local in zip(("a", "b"), ctxs, specs, shards):
        peak(reset=True)
        lbatch = {k: v[rows_of(DT_B, ctx)] for k, v in batch.items()}
        sync()
        t0 = time.perf_counter()
        (loss, _x), grads = ts.make_grads_fn(model, ctx=ctx, remat=True)(local.params, lbatch)
        sync()
        t1 = time.perf_counter()
        new_p, _o, m = opt.apply_updates(local.params, grads, local.opt, ocfg,
                                         run=ShardedRun(cfg, local.params, ctx))
        sync()
        t2 = time.perf_counter()
        del new_p, _o
        worst, where = 0.0, ""
        for i, (g, want, whole_g) in enumerate(zip(
                ckpt._flatten(grads, []), ckpt._flatten(rd.shard_tree(g0, sp.params, ctx), []),
                ckpt._flatten(g0, []))):
            err = float((g - want).abs().max()) / max(float(whole_g.abs().max()), 1e-30)
            if err > worst:
                worst, where = err, i
        del grads
        lap(f"{key} step + compare")
        out[key] = dict(loss=float(loss), grad_norm=float(m["grad_norm"]),
                        grads_ms=(t1 - t0) * 1e3, update_ms=(t2 - t1) * 1e3, peak_gb=peak(),
                        grad_rel=worst, grad_path=f"leaf {where}")
    del g0
    # The initial state saved from (1, 2), restored on (2, 1).
    like = ts.init_train_state(model, 0, device="meta")
    sync()
    t0 = time.perf_counter()
    ckpt.save(os.path.join(root, "ckpt"), 0, shards[0],
              shardings=rd.to_shardings(specs[0], ctxs[0].mesh))
    out["save_s"] = time.perf_counter() - t0
    lap("save")
    out["state_bytes"] = sum(t.numel() * t.element_size() for t in ckpt._flatten(like, []))
    t0 = time.perf_counter()
    back = ckpt.restore(os.path.join(root, "ckpt"), 0, like, device=dev,
                        shardings=rd.to_shardings(specs[1], ctxs[1].mesh))
    sync()
    out["restore_s"] = time.perf_counter() - t0
    out["restored_equal"] = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in
                                zip(ckpt._flatten(back, []), ckpt._flatten(shards[1], [])))
    lap("restore")
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# Phase 24: seq_shard — the caches cut along the sequence on the TP axis, and
# the context-parallel attention over the shards
# ---------------------------------------------------------------------------

SQ_T = 524288                 # 24a: the reference's long_500k decode shape (B 1, 524288
                              # positions: src/repro/launch/dryrun.py SHAPES)
SQ_QPOS = 300000              # 24a: the decode query's position: at tp 4 the last shard,
                              # [393216, 524288), holds no valid key
SQ_TPS = (2, 4)               # 24a: the sequence shards
SQ_ITERS = 3                  # 24a: timed calls (device time)
TOL_SQ_ATTN = 2e-4            # 24a: the shards combined vs the unsharded attention, x max |y|
                              # (the f32 attention tolerance: the sums' order changes)
SQ_ID_T = 8192                # 24a: the replay check's cache (tp 2: 4096 positions a shard)
SQ_ID_S = 64                  # 24a: its prefill's rows, at positions 4100 .. 4163 - pad
SQ_MAX = 8192                 # 24b: max_seq: each of the 2 ranks holds 4096 positions
SQ_LONG = 4100                # 24b: the long prompt (> 4096: keys on both ranks)
SQ_TF = 8                     # 24b: teacher-forced decode steps after its prefill
SQ_NEW = 8                    # 24b: new tokens a request
SQ_SHORT = (40, 24, 56)       # 24b: the short prompts (their keys all on rank 0)
TOL_SQ_SERVE = 2.0**-6        # 24b: sequence-sharded vs unsharded teacher-forced logits
                              # (bf16), x max |logit|: see phase_seq_shard
SQ_TIMEOUT_S = 400            # 24b: the two ranks' join


def phase_seq_shard(torch, dev, smi):
    """Phase 24: ``seq_shard`` on the card (one H100): the caches cut along the
    sequence on the TP axis, and the context-parallel attention over them.

    24a, one process: zamba2-7b's shared attention at the reference's
    ``long_500k`` decode shape (B 1, T = :data:`SQ_T`, 32 heads of 112, a
    bf16 cache from a seed, one f32 decode query at :data:`SQ_QPOS`): the
    cache split into tp = 2 and 4 shards (views), each shard's partials
    computed by ``attention._attend_cache_shards`` and combined by
    ``runtime.combine`` — the function the collective path combines
    all-gathered partials with — against the unsharded
    ``_attend_cache_invariant``, within :data:`TOL_SQ_ATTN` x max |y| and
    finite (at tp 4 the last shard holds no valid key).  Device time of the
    unsharded call and of each shard's local work (its partials alone), each
    shard's bytes as a share of the card, peak memory.  Then the replay
    identity over tp 2 shards (:data:`SQ_ID_T`): a row decoded alone equals
    the same row among :data:`SQ_ID_S` prefill rows with the same pad, bit
    for bit (asserted); behind another pad (the keys at other buffer
    positions, so other shard boundaries) the rows that differ are counted
    (reported).

    24b, a gloo world of 2 sharing the card (two spawned processes, every
    tensor on ``cuda:0``, as 23b): zamba2-7b at published widths cut to one
    ``"MMMMMS"`` unit, W4A4 ``pallas`` prepared, bf16, each rank its
    ``shard_tree`` cut (a (1, 2) mesh, ``seq_shard=True``), ``max_seq``
    :data:`SQ_MAX` (4096 positions a rank).  A prefill of :data:`SQ_LONG`
    tokens (keys on both ranks) and :data:`SQ_TF` teacher-forced decode
    steps, held to the same tree run whole by rank 0 without a ctx within
    :data:`TOL_SQ_SERVE` x max |logit|.  Why that bound: the two runs
    differ in the order of f32 sums (the attention's combine over the
    shards, the projections' K slices, which follow F) and so in a bf16
    rounding here and there: an element of the residual stream that moves
    by one bf16 ulp (2^-8 of itself) moves a logit by about 2^-8 of its
    share; 2^-6 of the largest logit allows four such ulps at the top.
    Then ``ServeEngine(ctx=)`` on the long prompt and :data:`SQ_SHORT`
    (whose keys all sit on rank 0), ``prompt_bucket=1`` (the long prompt's
    bucket would be 8184 positions of Mamba2 recurrence): exact token
    counts, one host sync a wave (the engine's count: gloo's own staging of
    CUDA tensors synchronizes on its threads), and ``lut_dequant_gemm``
    launched per rank the applied projections x (prefills + steps) times, all
    on the tensor cores (asserted); whether the tokens equal rank 0's
    unsharded serve (reported), tok/s and each rank's cache bytes.  The same
    teacher-forced run on the mesh without ``seq_shard`` (the projections'
    and the head's shards, the attention replicated) gives the distance that
    sharding the projections alone makes (reported beside the bound)."""
    out = {}
    t0 = time.perf_counter()
    out["a"] = seq_attention(torch, dev, smi)
    out["b"] = seq_serve_two(torch, dev, smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 24: passed in {out['seconds']:.1f} s")
    return out


def seq_attention(torch, dev, smi):
    """24a (:func:`phase_seq_shard`)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.runtime import combine
    from repro_torch.models import attention

    cfg = get_config(ZAMBA)
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kw = dict(window=None, softcap_val=cfg.attn_logit_softcap, bf16_operands=cfg.attend_bf16)
    gen = torch.Generator(device=dev).manual_seed(24)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kc = torch.randn((1, SQ_T, hkv, hd), generator=gen, device=dev, dtype=torch.bfloat16)
    vc = torch.randn((1, SQ_T, hkv, hd), generator=gen, device=dev, dtype=torch.bfloat16)
    q = torch.randn((1, 1, h, hd), generator=gen, device=dev)
    pos = torch.full((1, 1), SQ_QPOS, device=dev)
    cache_gb = (kc.numel() + vc.numel()) * kc.element_size() / 1e9
    y = attention._attend_cache_invariant(q, kc, vc, pos, pad_len=None, **kw)
    whole_ms = time_ms(torch, lambda i: attention._attend_cache_invariant(
        q, kc, vc, pos, pad_len=None, **kw), SQ_ITERS)
    peak_whole = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    check(torch.isfinite(y).all().item(), "24a: the unsharded attention is not finite")
    ymax = y.abs().max().item()
    rows = []
    for tp in SQ_TPS:
        n = SQ_T // tp
        ks, vs, los = list(kc.split(n, 1)), list(vc.split(n, 1)), [r * n for r in range(tp)]
        torch.cuda.reset_peak_memory_stats(dev)
        got = attention._attend_cache_shards(q, ks, vs, los, pos, pad_len=None, reduce=combine,
                                             **kw)
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        err = (got - y).abs().max().item() / ymax
        check(torch.isfinite(got).all().item() and err <= TOL_SQ_ATTN,
              f"24a tp {tp}: the combined shards {err:.3e} x max |y| from the unsharded "
              f"attention (tol {TOL_SQ_ATTN})")
        shard_ms = [time_ms(torch, lambda i, r=r: attention._attend_cache_shards(
            q, [ks[r]], [vs[r]], [los[r]], pos, pad_len=None,
            reduce=lambda parts, op: parts[0], **kw), SQ_ITERS) for r in range(tp)]
        valid = [max(0, min(SQ_QPOS + 1, lo + n) - lo) for lo in los]
        rows.append(dict(tp=tp, rel_err=err, shard_ms=shard_ms, max_shard_ms=max(shard_ms),
                         shard_gb=cache_gb / tp, shard_share=cache_gb / tp / 80.0,
                         valid_keys=valid, peak_gb=peak))
        del got
    layers_gb = cache_gb * 13        # zamba2-7b's 13 "S" sublayers, each its own K / V
    ident = seq_replay_identity(torch, dev, cfg, kw)
    res = dict(whole_ms=whole_ms, cache_gb=cache_gb, peak_whole_gb=peak_whole, rows=rows,
               model_cache_gb=layers_gb, identity=ident)
    log(f"phase 24a [{smi}]: zamba2-7b's shared attention at the long_500k decode shape (B 1, "
        f"T {SQ_T}, {h} heads of {hd}, bf16 cache {cache_gb:.2f} GB, f32 query at {SQ_QPOS}): "
        f"unsharded {whole_ms:.3f} ms (device), peak {peak_whole:.2f} GB; " + "; ".join(
            f"tp {r['tp']}: combined within {r['rel_err']:.3e} x max |y|, shards "
            f"{', '.join(f'{m:.3f}' for m in r['shard_ms'])} ms (slowest {r['max_shard_ms']:.3f}"
            f" = {r['max_shard_ms'] / whole_ms:.3f} of unsharded), {r['shard_gb']:.2f} GB a "
            f"shard ({100 * r['shard_share']:.2f}% of 80 GB), valid keys {r['valid_keys']}, peak "
            f"{r['peak_gb']:.2f} GB" for r in rows)
        + f"; the model's 13 shared-attention caches at this T: {layers_gb:.1f} GB whole, "
          f"{layers_gb / 2:.1f} / {layers_gb / 4:.1f} GB a rank at tp 2 / 4; replay: a row "
          f"alone == among {SQ_ID_S} prefill rows with its pad (bit-equal), behind another "
          f"pad {ident['moved_rows_differ']} of {ident['rows']} rows differ (max "
          f"{ident['moved_rel']:.3e} x max |y|)")
    del kc, vc
    return res


def seq_replay_identity(torch, dev, cfg, kw):
    """24a's replay check over tp 2 shards of a :data:`SQ_ID_T` cache in one
    process: the last prefill row alone (a decode step) against it among
    :data:`SQ_ID_S` rows, the same pad (asserted bit-equal); behind another
    pad, the rows that differ (counted)."""
    from repro_torch.dist.runtime import combine
    from repro_torch.models import attention

    gen = torch.Generator(device=dev).manual_seed(241)
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, t, n = 2, SQ_ID_T, SQ_ID_T // 2
    kc = torch.randn((b, t, hkv, hd), generator=gen, device=dev, dtype=torch.bfloat16)
    vc = torch.randn((b, t, hkv, hd), generator=gen, device=dev, dtype=torch.bfloat16)
    q = torch.randn((b, SQ_ID_S, h, hd), generator=gen, device=dev, dtype=torch.bfloat16)
    pad = torch.tensor([0, 37], device=dev)
    positions = 4100 + torch.arange(SQ_ID_S, device=dev)[None] - pad[:, None]

    def attend(qq, kk, vv, pp, pad_len):
        return attention._attend_cache_shards(qq, list(kk.split(n, 1)), list(vv.split(n, 1)),
                                              [0, n], pp, pad_len=pad_len, reduce=combine, **kw)

    together = attend(q, kc, vc, positions, pad)
    alone = attend(q[:, -1:], kc, vc, positions[:, -1:], pad)
    check(torch.equal(alone, together[:, -1:]),
          "24a: a row decoded alone differs from the same row among the prefill's rows "
          "(the same pad)")
    pad2 = torch.tensor([5, 0], device=dev)
    idx = (torch.arange(t, device=dev)[None] - pad2[:, None] + pad[:, None]) % t
    rows = torch.arange(b, device=dev)[:, None]
    moved = attend(q, kc[rows, idx], vc[rows, idx], positions, pad2)
    differ = (moved != together).flatten(2).any(-1)
    return dict(rows=differ.numel(), moved_rows_differ=int(differ.sum().item()),
                moved_rel=((moved.float() - together.float()).abs().max()
                           / together.float().abs().max()).item())


def seq_serve_two(torch, dev, smi, *, device="cuda", smoke=False):
    """24b (:func:`phase_seq_shard`): spawns the two ranks
    (:func:`seq_serve_rank`) and reads their results; every process it
    starts is joined or stopped.  ``device`` / ``smoke`` are for a CPU
    rehearsal of the control flow (``"cpu"``, smoke widths)."""
    import multiprocessing as mp
    import pickle
    import shutil

    t0 = time.perf_counter()
    root = ROOT / "build" / "seq_shard2"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=seq_serve_rank, args=(r, sys.path[0], str(root), device,
                                                         smoke)) for r in range(2)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(SQ_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    results = []
    for r, p in enumerate(procs):
        path = root / f"rank{r}.pkl"
        results.append(pickle.loads(path.read_bytes()) if path.exists() else
                       {"error": f"rank {r} wrote nothing (exit code {p.exitcode})"})
    shutil.rmtree(root, ignore_errors=True)
    errors = [res["error"] for res in results if "error" in res]
    check(not errors, f"24b: {errors}")
    r0 = results[0]
    check(r0["tf_rel"] <= TOL_SQ_SERVE,
          f"24b: the sequence-sharded teacher-forced logits {r0['tf_rel']:.3e} x max |logit| "
          f"from the unsharded run (tol {TOL_SQ_SERVE})")
    for r, res in enumerate(results):
        check(res["host_syncs"] == res["waves"],
              f"24b rank {r}: host_syncs {res['host_syncs']} != waves {res['waves']}")
        check(res["launches"] == res["want_launches"] == res["launches_tc"],
              f"24b rank {r}: lut_dequant_gemm launches {res['launches']} (tensor cores "
              f"{res['launches_tc']}) != {res['per_forward']} x ({res['prefills']} prefills + "
              f"{res['steps']} steps) = {res['want_launches']}")
        check(res["other_launches"] == 0, f"24b rank {r}: another kernel launched")
    check(results[0]["tokens"] == results[1]["tokens"], "24b: the ranks' tokens differ")
    res = dict(ranks=results, seconds=time.perf_counter() - t0)
    log(f"phase 24b [{smi}]: a gloo world of 2 on one card, mesh (1, 2), seq_shard; zamba2-7b "
        f"published widths, one 'MMMMMS' unit, W4A4 pallas, bf16, max_seq {SQ_MAX} (4096 "
        f"positions a rank): prefill {SQ_LONG} + {SQ_TF} teacher-forced steps within "
        f"{r0['tf_rel']:.3e} x max |logit| of rank 0's unsharded run (tol {TOL_SQ_SERVE}; the "
        f"prefill's last row {r0['tf_rel_prefill']:.3e}; the same mesh without seq_shard "
        f"{r0['tf_rel_tp']:.3e}), the prefill sharded {r0['tf_prefill_ms']:.1f} ms, without "
        f"seq_shard {r0['tf_prefill_tp_ms']:.1f}, unsharded {r0['tf_prefill_plain_ms']:.1f} "
        f"(host clock); ServeEngine(ctx=): "
        f"{r0['n_tokens']} tokens in {r0['wall_s']:.2f} s ({r0['tok_s']:.1f} tok/s; unsharded "
        f"{r0['plain_tok_s']:.1f}), tokens {'==' if r0['tokens_equal'] else '!='} the unsharded "
        f"serve's, {r0['host_syncs']} host syncs = waves, {r0['launches']} lut_dequant_gemm "
        f"launches a rank ({r0['per_forward']} x ({r0['prefills']} + {r0['steps']})), all on "
        f"the tensor cores; cache bytes a rank: attention K/V "
        + ", ".join(f"{x['kv_bytes'] / 1e6:.1f} MB" for x in results)
        + f" (unsharded {r0['plain_kv_bytes'] / 1e6:.1f} MB), Mamba2 state "
        + ", ".join(f"{x['state_bytes'] / 1e6:.1f} MB" for x in results)
        + f"; {res['seconds']:.1f} s with the processes' start; rank 0's seconds by stage "
        + ", ".join(f"{k} {v:.1f}" for k, v in r0["laps"].items()))
    return res


def seq_serve_rank(rank, src, root, device, smoke):
    """One rank of 24b: writes ``<root>/rank<r>.pkl`` (its numbers, or the
    traceback, which fails the phase in the parent)."""
    import pickle
    import traceback

    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    res = {}
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"), 2),
                                rank=rank, world_size=2)
        try:
            res = seq_serve_shared(torch, torch.device(device, 0) if device == "cuda"
                                   else torch.device(device), rank, smoke)
        finally:
            dist.destroy_process_group()
    except BaseException:                   # reported: the parent fails the phase
        res = {"error": f"rank {rank}: {traceback.format_exc()}"}
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def seq_serve_shared(torch, dev, rank, smoke):
    """24b's body on one rank (:func:`phase_seq_shard`)."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import dist as rd
    from repro_torch.configs import get_config
    from repro_torch.core import LutLinearSpec
    from repro_torch.dist import runtime
    from repro_torch.models.model import build_model, prepare_params
    from repro_torch.serve.serving import Request, ServeEngine

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    laps, t_lap = {}, [time.perf_counter()]

    def lap(what):
        sync()
        now = time.perf_counter()
        laps[what] = now - t_lap[0]
        t_lap[0] = now

    cfg = dataclasses.replace(get_config(ZAMBA, smoke=smoke), n_layers=ZB_LUT_LAYERS)
    model = build_model(cfg)
    mesh = init_device_mesh(dev.type, (1, 2), mesh_dim_names=("data", "model"))
    ctx = rd.ShardCtx(mesh, seq_shard=True)
    raw = model.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"), seed=0, device=dev)
    local = prepare_params(rd.shard_tree(raw, rd.param_specs(cfg, raw, ctx), ctx), n_hint=4)
    plain = prepare_params(raw, n_hint=4) if rank == 0 else None
    del raw
    out = {"laps": laps}
    lap("build")

    # Teacher-forced: a prefill of SQ_LONG tokens and SQ_TF steps, sharded and
    # (rank 0) whole.
    toks = torch.from_numpy(np.random.default_rng(24).integers(
        0, cfg.vocab_size, (1, SQ_LONG + SQ_TF))).to(dev)

    def teacher_forced(tree_, c):
        caches = model.init_cache(1, SQ_MAX, device=dev) if c is None else \
            runtime.local_cache(cfg, 1, SQ_MAX, torch.bfloat16, c, dev)
        sync()
        t0 = time.perf_counter()
        lg, caches = model.prefill(tree_, toks[:, :SQ_LONG], caches, ctx=c, max_seq=SQ_MAX)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        outs = [lg]
        for t in range(SQ_TF):
            lg, caches = model.decode_step(tree_, toks[:, SQ_LONG + t : SQ_LONG + t + 1], caches,
                                           SQ_LONG + t, ctx=c, max_seq=SQ_MAX)
            outs.append(lg)
        return torch.cat(outs, 1).float(), ms

    with torch.no_grad():
        got, out["tf_prefill_ms"] = teacher_forced(local, ctx)
        lap("teacher-forced sharded")
        # The same mesh without seq_shard: the projections' and the head's
        # shards alone, the attention replicated.
        tp_only, out["tf_prefill_tp_ms"] = teacher_forced(
            local, dataclasses.replace(ctx, seq_shard=False))
        lap("teacher-forced tp only")
        if rank == 0:
            want, out["tf_prefill_plain_ms"] = teacher_forced(plain, None)
            scale = want.abs().max()
            out["tf_rel"] = ((got - want).abs().max() / scale).item()
            out["tf_rel_prefill"] = ((got[:, 0] - want[:, 0]).abs().max() / scale).item()
            out["tf_rel_tp"] = ((tp_only - want).abs().max() / scale).item()
            lap("teacher-forced whole")
        dist.barrier()

        rng = np.random.default_rng(25)
        reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                        max_new_tokens=SQ_NEW) for n in (SQ_LONG,) + SQ_SHORT]
        eng = ServeEngine(model, local, batch=2, max_seq=SQ_MAX, prompt_bucket=1, ctx=ctx,
                          device=dev)
        kv, state = cache_bytes(eng._new_cache())
        # No set_sync_debug_mode here: gloo stages every CUDA tensor through
        # the host with synchronizing copies on its own threads (~1530 a rank
        # in this serve), so the engine's own count is the check.
        records = []
        eng.on_wave = records.append
        reset_launches()
        sync()
        t0 = time.perf_counter()
        outs = eng.generate(reqs)
        sync()
        wall, counts = time.perf_counter() - t0, read_launches()
        lap("serve sharded")
        per, _ = applied_projections(local)
        prefills = sum(1 for r in records if r.admitted)
        steps = sum(r.steps for r in records)
        n_tok = sum(len(o) for o in outs)
        check(all(len(o) == SQ_NEW for o in outs), f"24b rank {rank}: token counts "
                                                   f"{[len(o) for o in outs]}")
        out.update(tokens=outs, n_tokens=n_tok, wall_s=wall, tok_s=n_tok / wall,
                   host_syncs=eng.host_syncs, waves=len(records), prefills=prefills,
                   steps=steps, per_forward=per,
                   want_launches=per * (prefills + steps) if cuda else 0,
                   launches=counts["lut_dequant_gemm"],
                   launches_tc=counts["lut_dequant_gemm_tc"],
                   other_launches=sum(n for k, n in counts.items()
                                      if not k.startswith("lut_dequant_gemm")),
                   kv_bytes=kv, state_bytes=state)
        del eng
        if rank == 0:
            peng = ServeEngine(model, plain, batch=2, max_seq=SQ_MAX, prompt_bucket=1,
                               device=dev)
            out["plain_kv_bytes"] = cache_bytes(peng._new_cache())[0]
            t0 = time.perf_counter()
            plain_outs = peng.generate(reqs)
            sync()
            out["plain_tok_s"] = sum(len(o) for o in plain_outs) / (time.perf_counter() - t0)
            out["tokens_equal"] = plain_outs == outs
            lap("serve whole")
        dist.barrier()
    return out


# ---------------------------------------------------------------------------
# Phase 25: the device-less dry-run and its roofline, beside a real step
# ---------------------------------------------------------------------------

DRY_CELLS = (("stablelm-12b", "decode_32k"), ("stablelm-12b", "prefill_32k"),
             ("zamba2-7b", "long_500k"))
DRY_DIR = ROOT / "build" / "dryrun_torch"   # git-ignored: 25a's artifacts
DRY_JOBS = 6                  # 25a: ranks traced at a time, each in a spawned process
DRY_STEPS = {"decode": ("decode", 4, 256),  # 25b: kind, rows, positions (a decode's caches
             "prefill": ("prefill", 4, 128)}  # hold them and it writes the last)
DRY_ITERS = 5                 # 25b: timed steps a kind (CUDA events)


def phase_dryrun(torch, dev, smi):
    """Phase 25: the dry-run (``repro_torch.launch.dryrun``) and its roofline.

    25a, on the host (no card): the dry-run's own entry (``run_cells``) on
    the single-pod mesh for :data:`DRY_CELLS` — rank 0 and the last rank of
    each, in fake worlds of 256 ranks, :data:`DRY_JOBS` traces at a time in
    spawned processes started before 25b and joined after its builds and
    checks (so 25b's timed steps run on a quiet host).  Each cell must be
    ``traced``; its status, trace seconds, the rank's counts and the three
    roofline terms (``repro_torch.launch.roofline``: derived, not measured)
    are printed.

    25b, on the card: stablelm-12b at published widths cut to
    :data:`N_LAYERS` layers, W4A4 ``dequant`` (the dry-run's
    ``QUANT_SPEC``), a world of one, no ctx: each step of :data:`DRY_STEPS`
    is counted on ``meta`` by the dry-run's ``count_step``, then the same
    tree, caches and inputs are built on the card (``build_cell``) and the
    same step runs there.  Asserted: the count's ``argument_size_in_bytes``
    equals the bytes of the tensors the real step receives, and the growth
    of ``memory_allocated()`` from building them equals the caching
    allocator's blocks that hold them (``memory_snapshot``: a block rounds
    its tensor up to 512 B, and a large one keeps a segment's remainder under
    1 MiB); its ``flops`` equal ``FlopCounterMode`` around the real step,
    exactly.  Printed: the count's ``temp_size_in_bytes`` beside the rise of
    ``max_memory_allocated()`` during the real step (after a warm-up step),
    and the step's time on CUDA events beside its bound ``max(flops / 989
    TFLOP/s, (argument + output bytes) / 3.35 TB/s)``."""
    import threading
    import traceback

    import torch.distributed as dist

    check(not (dist.is_available() and dist.is_initialized()),
          "phase 25: an earlier phase left a default process group")
    t0 = time.perf_counter()
    host: dict = {}

    def run_host():
        from repro_torch.launch import dryrun

        try:
            host["recs"] = dryrun.run_cells([(a, shape, "single", True, "")
                                             for a, shape in DRY_CELLS],
                                            results_dir=str(DRY_DIR), jobs=DRY_JOBS)
        except Exception:                   # reported: the phase fails below
            host["error"] = traceback.format_exc()[-3000:]
        host["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=run_host)
    thread.start()
    try:
        cells = {name: dryrun_card_build(torch, dev, smi, name) for name in DRY_STEPS}
    finally:
        thread.join()
    out = {"a": dryrun_host_report(host, smi)}
    out["b"] = {name: dryrun_card_time(torch, smi, name, **c) for name, c in cells.items()}
    del cells
    gc.collect()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 25: passed in {out['seconds']:.1f} s (25a {host['seconds']:.1f} s beside 25b's "
        f"builds)")
    return out


def dryrun_host_report(host, smi):
    """25a's cells: each must be traced; prints their counts and roofline terms."""
    from repro_torch.launch import roofline

    check("error" not in host, f"25a: the dry-run raised {host.get('error')}")
    rows = []
    for rec in host["recs"]:
        what = f"{rec['arch']} {rec['shape']}"
        check(rec["status"] == "traced",
              f"25a: {what} {rec['status']}: {rec.get('error')} {rec.get('traceback', '')[-1500:]}")
        full, t = rec["full_analysis"], roofline.cell_terms(rec)
        row = {"cell": what, "status": rec["status"], "t_trace_s": rec["t_trace_s"],
               "last_rank_t_trace_s": rec["last_rank"]["t_trace_s"],
               "argument_bytes_differ": rec["argument_bytes_differ"],
               "recurrence_scaled": rec["recurrence_scaled"],
               **{k: full[k] for k in ("flops", "bytes_accessed", "argument_size_in_bytes",
                                       "output_size_in_bytes", "temp_size_in_bytes",
                                       "collective_bytes_by_axis")},
               **{k: t[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                                    "collective_links", "roofline_fraction")}}
        rows.append(row)
        log(f"phase 25a [{smi}]: {what} on the (16, 16) mesh, rank 0 of 256: {rec['status']} in "
            f"{rec['t_trace_s']:.1f} s (the last rank {row['last_rank_t_trace_s']:.1f} s, "
            f"argument bytes {'differ' if row['argument_bytes_differ'] else 'equal'}); counted "
            f"(from shapes, not measured): {full['flops']:.4e} matmul FLOPs, "
            f"{full['bytes_accessed']:.4e} B unfused, arguments "
            f"{full['argument_size_in_bytes'] / 1e9:.3f} GB, outputs "
            f"{full['output_size_in_bytes'] / 1e9:.3f} GB, temp peak "
            f"{full['temp_size_in_bytes'] / 1e9:.3f} GB, collectives "
            + ", ".join(f"{a} {b / 1e6:.2f} MB" for a, b in full["collective_bytes_by_axis"].items())
            + f"; roofline terms ({roofline.LABEL}): compute {t['t_compute_s'] * 1e3:.3f} ms, "
            f"memory {t['t_memory_s'] * 1e3:.3f} ms, collective {t['t_collective_s'] * 1e3:.3f} ms "
            f"({', '.join(f'{a} over {k}' for a, k in t['collective_links'].items())}), "
            f"{t['dominant']}-bound, roofline fraction {t['roofline_fraction']:.4f}")
    return {"cells": rows, "seconds": host["seconds"]}


def dryrun_card_build(torch, dev, smi, name, *, n_layers=N_LAYERS, smoke=False):
    """25b's count and build of one step (:func:`phase_dryrun`): the count on
    ``meta``, the same cell on ``dev``, the argument bytes and the FLOPs
    checked.  ``smoke`` (a CPU rehearsal) takes the smoke config."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    kind, rows, seq = DRY_STEPS[name]
    cfg = dataclasses.replace(get_config("stablelm-12b", smoke=smoke), n_layers=n_layers)
    t0 = time.perf_counter()
    counted = dryrun.count_step(dryrun.build_cell(cfg, kind, rows, seq, device="meta"))
    t_count = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cell = dryrun.build_cell(cfg, kind, rows, seq, device=dev)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    tensors = {id(t): t for t in tree.tensors(list(cell.args()))}
    arg_bytes = dryrun.tensor_bytes(*cell.args())
    want = counted["argument_size_in_bytes"]
    check(arg_bytes == want,
          f"25b {name}: the real step receives {arg_bytes} B of tensors, the count says {want}")
    # The caching allocator rounds a block up to 512 B, and a large block keeps the
    # remainder of its segment when that is under 1 MiB: the blocks that hold the
    # step's tensors, read from the allocator, must add up to the growth.
    blocks = {b["address"]: b["size"] for seg in torch.cuda.memory_snapshot()
              for b in seg["blocks"] if b["state"] == "active_allocated"}
    ptrs = {t.untyped_storage().data_ptr() for t in tensors.values() if t.numel()}
    check(ptrs <= set(blocks), f"25b {name}: {len(ptrs - set(blocks))} of the step's tensors "
                               f"start no block of the caching allocator")
    held = sum(blocks.get(p, 0) for p in ptrs)
    check(held == grown,
          f"25b {name}: building the step's {len(tensors)} tensors ({arg_bytes} B) grew "
          f"memory_allocated() by {grown} B; the allocator's blocks holding them: {held} B")
    slack = max((blocks.get(t.untyped_storage().data_ptr(), 0) - t.untyped_storage().nbytes()
                 for t in tensors.values() if t.numel()), default=0)
    cell.step()                            # warm: the library handles and workspaces
    torch.cuda.synchronize()
    with FlopCounterMode(display=False) as fc:
        cell.step()
    real_flops = fc.get_total_flops()
    check(real_flops == counted["flops"],
          f"25b {name}: FlopCounterMode around the real step {real_flops} != the count "
          f"{counted['flops']:.0f}")
    log(f"phase 25b [{smi}]: stablelm-12b at published widths, {n_layers} layers, W4A4 dequant, "
        f"{name} {rows} x {seq}: the count on meta ({t_count:.1f} s) and the real step on "
        f"{dev.type} agree: {arg_bytes} B of arguments in {len(tensors)} tensors (building them "
        f"grew memory_allocated() by {grown} B = the allocator's blocks holding them; the "
        f"largest rounding of one {slack} B), {real_flops} matmul FLOPs (FlopCounterMode around "
        f"the real step)")
    return {"cell": cell, "counted": counted, "arg_bytes": arg_bytes, "grown": grown,
            "n_tensors": len(tensors), "flops": real_flops}


def dryrun_card_time(torch, smi, name, *, cell, counted, arg_bytes, grown, n_tensors, flops):
    """25b's measurements of one step: its peak memory rise beside the count's
    temp peak, and its time beside the bound (printed, not asserted)."""
    from repro_torch import hw
    from repro_torch.launch import dryrun

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out_bytes = dryrun.tensor_bytes(cell.step())
    torch.cuda.synchronize()
    peak_rise = torch.cuda.max_memory_allocated() - base
    ms = time_ms(torch, lambda _i: cell.step(), DRY_ITERS)
    card = hw.H100_SXM
    t_ops, t_bytes = flops / card.peak_flops_bf16, (arg_bytes + out_bytes) / card.hbm_bandwidth
    bound_ms = max(t_ops, t_bytes) * 1e3
    temp = counted["temp_size_in_bytes"]
    res = {"arg_bytes": arg_bytes, "grown_bytes": grown, "n_tensors": n_tensors, "flops": flops,
           "output_bytes": out_bytes, "counted_output_bytes": counted["output_size_in_bytes"],
           "temp_size_in_bytes": temp, "peak_rise_bytes": peak_rise,
           "temp_over_peak_rise": temp / peak_rise if peak_rise else None,
           "ms": ms, "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "share_of_bound": bound_ms / ms}
    kind, rows, seq = DRY_STEPS[name]
    log(f"phase 25b [{smi}]: {name} {rows} x {seq}: the count's temp peak {temp / 1e6:.1f} MB "
        f"beside the real step's max_memory_allocated() rise {peak_rise / 1e6:.1f} MB (ratio "
        f"{res['temp_over_peak_rise']:.3f}); the step {ms:.3f} ms on CUDA events ({DRY_ITERS} "
        f"steps) beside its bound {bound_ms:.4f} ms ({res['bound_by']}: {flops:.4e} FLOPs at "
        f"989 TFLOP/s, {(arg_bytes + out_bytes) / 1e9:.3f} GB at 3.35 TB/s), "
        f"{res['share_of_bound']:.4f} of it")
    return res


# ---------------------------------------------------------------------------
# Phase 26: plans, prepared checkpoints and live ops over the MoE + MLA,
# recurrent and encoder-decoder trees
# ---------------------------------------------------------------------------

PF_DIR = ROOT / "build" / "plans_families"   # git-ignored; removed at the end of the phase
PF_FAMILIES = ((DEEPSEEK, DS_LUT_LAYERS), (ZAMBA, ZB_LUT_LAYERS), (RWKV, RW_LUT_LAYERS),
               (WHISPER, WH_LUT_LAYERS))     # the depths of 17c, 18b, 19b and 20d
PF_BUDGET = 64 << 20          # the analytic plans: on each family some applied projections at
                              # p <= 5 (the tensor cores), some at p = 6-7 (the lookup route),
                              # some raw at p = 1
PF_SWAP_BUDGET = 256 << 20    # deepseek's second plan, the hot-swap's target
PF_MAX_SEQ = 128              # ServeEngine(batch=4, max_seq=PF_MAX_SEQ)
PF_NEW = (4, 12)              # new tokens a request, from default_rng(26)
PF_KILL_WAVE = 1              # the LiveServer's injected failure (whisper, zamba2)


def pf_requests(cfg):
    """Phase 26's 8 requests: prompts of 16-64 tokens, the first of each
    group of 4 exactly 64 (a bucket), and budgets of 4-12 new tokens, from
    ``default_rng(26)``: several waves, rows in flight at every wave."""
    import numpy as np

    from repro_torch.serve.serving import Request

    rng = np.random.default_rng(26)
    lens = rng.integers(16, 65, 8)
    lens[0] = lens[4] = 64
    news = rng.integers(PF_NEW[0], PF_NEW[1] + 1, 8)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=int(m)) for n, m in zip(lens, news)]


def log_pf_plan(what, plan, params):
    """The plan's choices, one line a leaf, applied or not (the reference's
    planner prices every leaf as applied: ROADMAP Queue 3)."""
    routes = plan_routes(plan)
    applied = applied_projections(params)[1]
    log(f"{what}: {plan.total_bytes:,} B of a {plan.budget_bytes:,} B budget "
        f"({plan.table_bytes:,} B shared tables), {len(plan.layers)} leaves")
    for path, lp in plan.layers.items():
        t = f"measured {lp.measured_us:.1f} us, " if lp.measured_us is not None else ""
        log(f"    {'/'.join(path.split('/')[-3:]):<28} p={lp.p} prepared={int(lp.prepared)} "
            f"route={routes[path]:<6} x{lp.stack:<4} {lp.capacity_bytes:>12,} B  {t}"
            f"{'applied x' + str(applied[path][0]) if path in applied else 'decoded or not run'}")


def pf_serve(torch, dev, model, tree, plan, reqs, want, *, what, both_routes=True):
    """``reqs`` served through ``ServeEngine(tree, plan=plan)`` (batch 4,
    max_seq PF_MAX_SEQ), counted and checked by :func:`counted_plan_serve`:
    none on the CUDA cores and, with ``both_routes`` (an analytic plan at
    PF_BUDGET; a measured plan may choose otherwise), some applied
    projections on each sm90 route.  Returns (the engine, the result)."""
    from repro_torch.serve.serving import ServeEngine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine(model, tree, batch=4, max_seq=PF_MAX_SEQ, decode="scan", plan=plan,
                      device=dev)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    out, records = counted_plan_serve(torch, eng, plan, reqs, want, what=what)
    per = out["per_forward"]
    check(per["cuda_core"] == 0 and (not both_routes or per["tc"] > 0 and per["lookup"] > 0),
          f"{what}: applied projections by route {per}: the plan must put projections on both "
          f"sm90 routes of lut_stream_gemm and none on the CUDA cores")
    out.update(apply_s=apply_s, waves=len(records), total_bytes=plan.total_bytes,
               table_bytes=plan.table_bytes)
    log(f"{what}: the unplanned serve's tokens (crc32 {out['tokens_crc32']:08x}), "
        f"{out['tokens']} in {out['wall_s']:.3f} s ({out['tok_s']:.1f} tok/s), {len(records)} "
        f"waves, {out['host_syncs']} host syncs; lut_stream_gemm {out['launches']} launches = "
        f"({per['tc']} tensor-core + {per['lookup']} lookup projections a forward) x "
        f"({out['prefills']} prefills + {out['decode_steps']} decode steps): "
        f"{out['launches_tc']} tensor cores, {out['launches_lookup']} lookup; lut_canon "
        f"{out['launches_canon']}; plan applied in {apply_s:.2f} s, "
        f"{out['prepared_bytes']:,} B checked by verify_capacity")
    return eng, out


def pf_checkpoint(torch, dev, model, params, plan, reqs, want, *, arch, what, smi):
    """The planned tree saved with ``save_prepared``, restored onto the card
    with ``restore_prepared`` (the packs rebuilt, the fingerprint checked),
    and served again: the same tokens.  Returns GB and seconds."""
    import shutil

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.serve.serving import ServeEngine
    from repro_torch.tune import verify_capacity

    ckdir = str(PF_DIR / arch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_dir = ckpt.save_prepared(ckdir, 0, params)
    save_s = time.perf_counter() - t0
    files = sorted(n for n in os.listdir(step_dir) if n.endswith(".npy"))
    disk = sum(npy_payload_bytes(os.path.join(step_dir, n)) for n in files)
    t0 = time.perf_counter()
    restored = ckpt.restore_prepared(ckdir, 0, device=dev, expect_fingerprint=plan.fingerprint)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    verify_capacity(restored, plan)
    t0 = time.perf_counter()
    got = ServeEngine(model, restored, batch=4, max_seq=PF_MAX_SEQ, device=dev).generate(reqs)
    serve_s = time.perf_counter() - t0
    check(got == want, f"{what}: the restored tree serves other tokens")
    del restored
    shutil.rmtree(ckdir, ignore_errors=True)
    log(f"{what} [{smi}]: save_prepared {len(files)} leaf files, {disk / 1e9:.3f} GB in "
        f"{save_s:.2f} s; restore_prepared onto the card {restore_s:.2f} s (the files just "
        f"written: read from the page cache); the restored tree served the same tokens in "
        f"{serve_s:.2f} s")
    return dict(leaves=len(files), gb=disk / 1e9, save_s=save_s, restore_s=restore_s,
                serve_s=serve_s)


def pf_family(torch, dev, smi, arch, n_layers):
    """One family of phase 26 (see :func:`phase_plans_families`)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import LutLinearSpec
    from repro_torch.core.calibrate import calibrate_tree
    from repro_torch.ft.supervisor import FailureInjector
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model, prepare_params
    from repro_torch.serve.ops import LiveServer
    from repro_torch.serve.serving import ServeEngine
    from repro_torch.tune import Measurer, plan_model
    from repro_torch.tune.planner import apply_plan

    what = f"phase 26 {arch}"
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers, **(
        dict(encoder_layers=n_layers) if cfg.is_encdec else {}))
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = model.init_quantized(LutLinearSpec(mode="lut", **LUT_SPEC), seed=0, device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
                            .astype(np.int32)).to(dev)
    if cfg.is_encdec:
        frames = whisper_frames(torch, dev, cfg, 2, seed=1, dtype=torch.bfloat16)
        calibrated = calibrate_tree(
            lambda probed: model.forward(probed, toks, prefix_embeds=frames)[0], raw)
    else:
        calibrated = calibrate_tree(lambda probed: model.forward(probed, toks)[0], raw)
    del raw
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reqs = pf_requests(cfg)
    t0 = time.perf_counter()
    eng = ServeEngine(model, prepare_params(calibrated, n_hint=4), batch=4, max_seq=PF_MAX_SEQ,
                      device=dev)
    want = eng.generate(reqs)
    del eng
    unplanned_s = time.perf_counter() - t0
    check([len(o) for o in want] == [r.max_new_tokens for r in reqs],
          f"{what}: the unplanned serve's token counts {[len(o) for o in want]}")
    log(f"{what} [{smi}]: {cfg.n_layers} layers {transformer.segments(cfg)}"
        + (f" + {cfg.encoder_layers} encoder layers" if cfg.is_encdec else "")
        + f" at published widths, W1A3 lut, bf16, initialized, quantized and calibrated in "
        f"{build_s:.1f} s; the unplanned serve (every leaf prepared at p = 4) in "
        f"{unplanned_s:.1f} s: {sum(map(len, want))} tokens")
    out = dict(n_layers=n_layers, build_s=build_s, unplanned_s=unplanned_s,
               tokens=sum(map(len, want)))

    t0 = time.perf_counter()
    plan = plan_model(calibrated, lut_budget_bytes=PF_BUDGET, n_hint=4, measure=False)
    out["plan_s"] = time.perf_counter() - t0
    eng, out["serve"] = pf_serve(torch, dev, model, calibrated, plan, reqs, want,
                                 what=f"{what}: the {PF_BUDGET >> 20} MiB analytic plan")
    log_pf_plan(f"{what}: the {PF_BUDGET >> 20} MiB analytic plan (planned in "
                f"{out['plan_s']:.2f} s)", plan, eng.params)
    out["checkpoint"] = pf_checkpoint(torch, dev, model, eng.params, plan, reqs, want,
                                      arch=arch, what=f"{what}: checkpoint", smi=smi)
    planned = eng.params
    del eng

    if arch == DEEPSEEK:
        meas = Measurer(cache={})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mplan = plan_model(calibrated, lut_budget_bytes=PF_BUDGET, n_hint=4, measure=True,
                           measurer=meas)
        torch.cuda.synchronize()
        mplan_s = time.perf_counter() - t0
        expert = {path: lp.measured_us for path, lp in mplan.layers.items()
                  if path.endswith("moe/w_gate")}
        check(expert and all(us is not None and us > 0 for us in expert.values()),
              f"{what}: the measured plan timed no expert stack: {expert}")
        meng, mserved = pf_serve(torch, dev, model, calibrated, mplan, reqs, want,
                                 what=f"{what}: the {PF_BUDGET >> 20} MiB measured plan",
                                 both_routes=False)
        log_pf_plan(f"{what}: the {PF_BUDGET >> 20} MiB plan measured on the card (planned in "
                    f"{mplan_s:.1f} s, {meas.misses} candidates timed on a unit slice)",
                    mplan, meng.params)
        del meng
        out["measured"] = dict(plan_s=mplan_s, candidates_measured=meas.misses,
                               expert_stack_us=expert, **mserved)

        # The hot-swap: plan A's tree serving, plan B's staged at wave 0 and
        # installed at the wave boundary that follows.
        plan_b = plan_model(calibrated, lut_budget_bytes=PF_SWAP_BUDGET, n_hint=4, measure=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree_b = apply_plan(calibrated, plan_b, n_hint=4)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        eng = ServeEngine(model, planned, batch=4, max_seq=PF_MAX_SEQ, device=dev)
        swap = {}

        def on_wave(rec):
            if rec.wave == 0:
                t1 = time.perf_counter()
                eng.request_swap(tree_b)
                swap["request_s"] = time.perf_counter() - t1

        eng.on_wave = on_wave
        t0 = time.perf_counter()
        got = eng.generate(reqs)
        swap_serve_s = time.perf_counter() - t0
        eng.on_wave = None
        check(got == want and eng.swaps == 1 and eng.last_swap_wave == 1
              and eng.params is tree_b,
              f"{what}: the hot-swap to the {PF_SWAP_BUDGET >> 20} MiB plan: tokens equal "
              f"{got == want}, swaps {eng.swaps}, flip at wave {eng.last_swap_wave} (want 1)")
        out["swap"] = dict(stage_s=stage_s, request_s=swap["request_s"], serve_s=swap_serve_s,
                           flip_wave=eng.last_swap_wave, total_bytes_b=plan_b.total_bytes)
        log(f"{what} [{smi}]: hot-swap from the {PF_BUDGET >> 20} MiB plan to the "
            f"{PF_SWAP_BUDGET >> 20} MiB plan ({plan_b.total_bytes:,} B): staged in "
            f"{stage_s:.2f} s, requested at wave 0 (drift check {swap['request_s']:.3f} s), "
            f"flipped at wave {eng.last_swap_wave}; the serve across it {swap_serve_s:.2f} s, "
            f"the unplanned serve's tokens, no request dropped")
        del eng, tree_b

    if arch in (ZAMBA, WHISPER):
        os.makedirs(PF_DIR, exist_ok=True)
        srv = LiveServer(lambda: ServeEngine(model, planned, batch=4, max_seq=PF_MAX_SEQ,
                                             device=dev),
                         log_path=str(PF_DIR / f"{arch}.jsonl"),
                         injector=FailureInjector(fail_at_waves=(PF_KILL_WAVE,)))
        t0 = time.perf_counter()
        got = srv.serve(reqs)
        torch.cuda.synchronize()
        live_s = time.perf_counter() - t0
        differ = sum(a != b for o, w in zip(got, want) for a, b in zip(o, w))
        check(srv.restarts == 1, f"{what}: {srv.restarts} restarts, want 1")
        check(len(got) == len(reqs) and [len(o) for o in got] == [r.max_new_tokens for r in reqs],
              f"{what}: kill + replay token counts {[len(o) for o in got]}")
        if cfg.is_encdec:
            # full caches, no MoE: the replay's prefill computes each row as
            # the clean serve's decode steps did (the replay identity)
            check(got == want, f"{what}: kill + replay gave {differ} other tokens than the "
                               f"clean serve")
        out["kill_replay"] = dict(restarts=srv.restarts, seconds=live_s, tokens_differing=differ,
                                  identity_asserted=cfg.is_encdec)
        log(f"{what} [{smi}]: LiveServer killed at wave {PF_KILL_WAVE}, restarted and replayed "
            f"in {live_s:.2f} s: 0 requests dropped, each its budget, {differ} of "
            f"{sum(map(len, want))} tokens other than the clean serve's"
            + (" (the identity, asserted)" if cfg.is_encdec else
               " (the pads of the replay's prefill pass through the recurrent state: not the "
               "clean serve's computation, so not asserted)"))
    del planned, calibrated
    torch.cuda.empty_cache()
    return out


def phase_plans_families(torch, dev, smi):
    """Phase 26: plans, prepared checkpoints and live ops over the trees the
    autotuner once refused: deepseek-v2-lite-16b at 4 layers (MoE expert
    stacks and MLA's ``W_kup`` / ``W_vup``, decoded, not applied), zamba2-7b
    at 6 (the shared block, one leaf applied per ``"S"`` sublayer),
    rwkv6-3b at 4 and whisper-large-v3 at 4 + 4 (the encoder and the cross
    ``wk`` / ``wv``, not run under ``ServeEngine``), at published widths,
    W1A3 ``lut``, calibrated (whisper's through frames), bf16.  Each family:
    an analytic plan at PF_BUDGET served through ``ServeEngine(plan=)`` with
    the tokens of the unplanned serve and ``lut_stream_gemm``'s launches
    counted per route from the plan (:func:`pf_serve`); the planned tree
    through ``save_prepared`` / ``restore_prepared`` and served again.
    deepseek: a plan measured on the card (``Measurer`` times each
    candidate on a unit slice, an expert stack's too), served, and a
    mid-serve hot-swap to the PF_SWAP_BUDGET plan.  zamba2 and whisper: a
    ``LiveServer`` killed at wave PF_KILL_WAVE and replayed: no request
    dropped, each its budget; whisper's tokens the clean serve's (its caches
    are all full caches), zamba2's counted where they differ (its left pads
    pass through the state, and the replay prefills behind other pads)."""
    import shutil

    shutil.rmtree(PF_DIR, ignore_errors=True)
    results = {}
    try:
        for arch, n_layers in PF_FAMILIES:
            t0 = time.perf_counter()
            results[arch] = pf_family(torch, dev, smi, arch, n_layers)
            results[arch]["seconds"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(PF_DIR, ignore_errors=True)
    log(f"phase 26 [{smi}]: " + ", ".join(f"{a} {r['seconds']:.1f} s" for a, r in results.items()))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=("tc_cp_async", "gemma2_serve", "live_ops", "obs",
                                        "deepseek", "zamba2", "rwkv", "whisper", "vlm_train",
                                        "dist", "dist_train", "seq_shard", "dryrun",
                                        "plans_families"),
                    help="after the build, run this phase alone and print its result as one "
                         "JSON line (phase 6's cp.async repeats, phase 14, 15, 16, 17, 18, 19, "
                         "20, 21, 22, 23, 24, 25 or 26)")
    ap.add_argument("--src", type=pathlib.Path, default=ROOT / "src",
                    help="the directory holding the repro_torch whose kernels are built and "
                         "driven (default: this checkout's): run two trees in turns in one "
                         "call to compare their kernels on one card")
    args = ap.parse_args(argv)
    # torch.compile (the flex_attention yardstick of phase 10) caches what it
    # builds; keep that inside the checkout's git-ignored build directory.
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "torchinductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (args.src / "repro_torch").is_dir():
        print(f"chip_smoke: {args.src}/repro_torch not found: run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from repro_torch import hw
    from repro_torch.configs import get_config
    from repro_torch.core import LutLinearSpec
    from repro_torch.kernels import build

    t_all = time.perf_counter()
    try:
        # One nvcc per source, all started together.
        with concurrent.futures.ThreadPoolExecutor(len(build.SOURCES)) as pool:
            for lib in pool.map(build.load, build.SOURCES):
                check(lib is not None, "kernel library did not load")
        for name in build.SOURCES:
            info = build.build_info[name]
            regs = sorted({ln.split("info    : ")[-1] for ln in info["log"].splitlines()
                           if "registers" in ln})
            log(f"phase 1: built {name}.cu in {info['seconds']:.1f} s "
                f"(nvcc, sm_90a): {'; '.join(regs)}")
            if name.endswith("_sm90"):
                log(f"phase 1: {name}: ptxas warning C7518 (wgmma serialized) "
                    f"{'PRESENT' if 'C7518' in info['log'] else 'absent'}; "
                    f"{wgmma_waits(info['path'])}")
        cfg = get_config("stablelm-12b")
        alone = {"tc_cp_async": lambda: phase_tc_cp_async(torch, dev, cfg, hw.H100_SXM, smi),
                 "gemma2_serve": lambda: phase_gemma2_serve(torch, dev, smi),
                 "live_ops": lambda: phase_live_ops(torch, dev, cfg, smi),
                 "obs": lambda: phase_obs(torch, dev, cfg, smi),
                 "deepseek": lambda: phase_deepseek(torch, dev, smi),
                 "zamba2": lambda: phase_zamba2(torch, dev, smi),
                 "rwkv": lambda: phase_rwkv(torch, dev, smi),
                 "whisper": lambda: phase_whisper(torch, dev, smi),
                 "vlm_train": lambda: phase_vlm_train(torch, dev, smi),
                 "dist": lambda: phase_dist(torch, dev, smi),
                 "dist_train": lambda: phase_dist_train(torch, dev, smi),
                 "seq_shard": lambda: phase_seq_shard(torch, dev, smi),
                 "dryrun": lambda: phase_dryrun(torch, dev, smi),
                 "plans_families": lambda: phase_plans_families(torch, dev, smi)}
        if args.phase:
            result = alone[args.phase]()
            print(json.dumps({"phase": args.phase, "src": str(args.src), "card": smi,
                              "seconds": time.perf_counter() - t_all, "result": result},
                             default=str))
            return 0
        laps = [("1 builds", time.perf_counter() - t_all)]

        def lap(what):
            laps.append((what, time.perf_counter() - t_all - sum(t for _w, t in laps)))

        flash_abs = phase_flash_kernel(torch, dev)
        lap("9 flash kernel")
        frows = phase_flash_times(torch, dev, hw.H100_SXM, smi)
        lap("10 flash times")
        fwd = phase_gemma2_forward(torch, dev, smi)
        lap("11 gemma2 forward")
        grows, g_rel, g_abs = phase_kernel_times(
            torch, dev, get_config("gemma2-2b"), hw.H100_SXM,
            bs=(4, 4 * GEMMA_BUCKET, FLASH_SEQ), iters=(5, 3, 3), label="phase 12")
        lap("12 gemma2 shapes")
        phase_stream_kernel(torch, dev)
        lap("6 stream kernel")
        srows, stream_abs = phase_stream_times(torch, dev, cfg, hw.H100_SXM, smi)
        lap("6 stream times")
        cprows = alone["tc_cp_async"]()
        lap("6 cp.async")
        lrows, lookup_abs = phase_lookup_times(torch, dev, cfg, hw.H100_SXM, smi)
        lap("6 lookup times")
        phase_lut_layer(torch, dev, cfg)
        lap("7 lut layer")
        lserve = phase_serve(torch, dev, cfg, smi, phase=8,
                             spec=LutLinearSpec(mode="lut", **LUT_SPEC),
                             kernel="lut_stream_gemm", max_prompt=64, max_new=16,
                             calibrate=True, iters=(2, 5))
        lap("8 lut serve")
        planned = phase_planned_serve(torch, dev, cfg, smi)
        lap("13 planned serve")
        worst_rel, worst_abs = phase_kernel(torch, dev)
        lap("2 kernel sweep")
        phase_row_invariance(torch, dev)
        lap("2 row invariance")
        rows, rel2, abs2 = phase_kernel_times(torch, dev, cfg, hw.H100_SXM)
        lap("2 stablelm shapes")
        worst_rel, worst_abs = max(worst_rel, rel2, g_rel), max(worst_abs, abs2, g_abs)
        serve = phase_serve(torch, dev, cfg, smi, phase=3,
                            spec=LutLinearSpec(bw=4, ba=4, mode="pallas"),
                            kernel="lut_dequant_gemm", max_prompt=96, max_new=32)
        lap("3 pallas serve")
        cpu_rel, lut_cpu_rel = phase_cpu_and_loop(torch, dev, cfg)
        lap("4-5 cpu and loop")
        gserve = alone["gemma2_serve"]()
        lap("14 gemma2 serve")
        live = phase_live_ops(torch, dev, cfg, smi)
        lap("15 live ops")
        obs = phase_obs(torch, dev, cfg, smi, live["ref"])
        lap("16 obs")
        deepseek = alone["deepseek"]()
        lap("17 deepseek")
        zamba2 = alone["zamba2"]()
        lap("18 zamba2")
        rwkv = alone["rwkv"]()
        lap("19 rwkv")
        whisper = alone["whisper"]()
        lap("20 whisper")
        vlm = alone["vlm_train"]()
        lap("21 vlm + training")
        dist_r = alone["dist"]()
        lap("22 dist")
        dist_train = alone["dist_train"]()
        lap("23 dist train")
        seq_shard = alone["seq_shard"]()
        lap("24 seq shard")
        dry = alone["dryrun"]()
        lap("25 dryrun")
        pf = alone["plans_families"]()
        lap("26 plans families")
        worst_rel = max(worst_rel, deepseek["e"]["dequant_rel"], zamba2["d"]["dequant_rel"],
                        rwkv["d"]["dequant_rel"], whisper["e"]["dequant_rel"],
                        vlm["d"]["dequant_rel"])
        worst_abs = max(worst_abs, deepseek["e"]["dequant_abs"], zamba2["d"]["dequant_abs"],
                        rwkv["d"]["dequant_abs"], whisper["e"]["dequant_abs"],
                        vlm["d"]["dequant_abs"])
        stream_abs = max(stream_abs, deepseek["e"]["stream_abs"], zamba2["d"]["stream_abs"],
                         rwkv["d"]["stream_abs"], whisper["e"]["stream_abs"],
                         vlm["d"]["stream_abs"])
        flash_abs = max(flash_abs, whisper["e"]["flash_abs"], vlm["d"]["flash_abs"])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s; seconds by phase: "
        + ", ".join(f"{what} {t:.1f}" for what, t in laps))

    def layer_sum(rs, b, key):
        return sum(r[key] for r in rs if r["B"] == b)

    def bound_by(rs, b):
        return "bytes" if all(r["bound_by"] == "bytes" for r in rs if r["B"] == b) else \
            "operations" if all(r["bound_by"] == "operations" for r in rs if r["B"] == b) else "mixed"

    def times(rs, b, at):
        out = {"at": at, "ms": layer_sum(rs, b, "ms"), "plain_ms": layer_sum(rs, b, "plain_ms"),
               "bound_ms": layer_sum(rs, b, "bound_ms"), "bound_by": bound_by(rs, b),
               "library_ms": layer_sum(rs, b, "library_ms")}
        if all("library_bf16_ms" in r for r in rs):
            out["library_bf16_ms"] = layer_sum(rs, b, "library_bf16_ms")
        return out

    def stream_times(rs, b, at):
        return {**times(rs, b, at), "lookup_bound_ms": layer_sum(rs, b, "lookup_bound_ms"),
                "cuda_core_ms": layer_sum(rs, b, "cuda_core_ms")}

    def lookup_times(p, b, at):
        rs = [r for r in lrows if r["p"] == p and r["B"] == b]
        libs = [r["library_ms"] for r in rs]
        return {"at": at, "ms": layer_sum(rs, b, "ms"), "plain_ms": layer_sum(rs, b, "plain_ms"),
                "bound_ms": layer_sum(rs, b, "bound_ms"), "bound_by": bound_by(rs, b),
                "library_ms": None if None in libs else sum(libs),
                "library_ms_by_projection": {r["proj"]: r["library_ms"] for r in rs},
                "cuda_core_ms": layer_sum(rs, b, "cuda_core_ms"),
                "canon_ms": layer_sum(rs, b, "canon_ms"),
                "canon_bound_ms": layer_sum(rs, b, "canon_bound_ms")}

    def ds_at(what):
        return (f"phase 17e: deepseek-v2-lite-16b's distinct applied projection shapes, once each "
                f"({', '.join(deepseek['e']['shapes'])}), {what} (device time)")

    def zb_at(what):
        return (f"phase 18d: zamba2-7b's distinct applied projection shapes, once each "
                f"({', '.join(zamba2['d']['shapes'])}), {what} (device time)")

    def rw_at(what):
        return (f"phase 19d: rwkv6-3b's distinct applied projection shapes, once each "
                f"({', '.join(rwkv['d']['shapes'])}), {what} (device time)")

    def wh_at(what):
        return (f"phase 20e: whisper-large-v3's distinct applied projection shapes, once each "
                f"({', '.join(whisper['e']['shapes'])}), {what} (device time)")

    wh_rows = whisper["e"]["rows_b"]

    def vl_at(what):
        return (f"phase 21d: internvl2-1b's distinct applied projection shapes, once each "
                f"({', '.join(vlm['d']['shapes'])}), {what} (device time)")

    vl_rows = vlm["d"]["rows_b"]

    def canon_times(rs, b, at):
        return {"at": at, "ms": layer_sum(rs, b, "canon_ms"),
                "plain_ms": layer_sum(rs, b, "canon_plain_ms"),
                "bound_ms": layer_sum(rs, b, "canon_bound_ms"), "bound_by": "bytes",
                "library_ms": None}

    def pf_launches(keys):
        """Phase 26's asserted launches per family and plan."""
        out = {"at": f"phase 26: deepseek-v2-lite-16b / zamba2-7b / rwkv6-3b / whisper-large-v3 "
                     f"at {DS_LUT_LAYERS} / {ZB_LUT_LAYERS} / {RW_LUT_LAYERS} / "
                     f"{WH_LUT_LAYERS} + {WH_LUT_LAYERS} layers, W1A3 lut calibrated, bf16, "
                     f"ServeEngine(plan=) under the {PF_BUDGET >> 20} MiB analytic plan "
                     f"(deepseek: and the measured one), counted per route from the plan"}
        for arch, r in pf.items():
            runs = {"analytic": r["serve"], **({"measured": r["measured"]} if "measured" in r
                                               else {})}
            out[arch] = {name: {k: run[k] for k in keys} for name, run in runs.items()}
        return out

    kernels = {"kernels": [{
        "name": "lut_dequant_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lut_dequant_gemm_sm90.cu",
        "cuda_core_source": "src/repro_torch/kernels/csrc/lut_dequant_gemm.cu",
        "replaces": "src/repro/kernels/lut_dequant_gemm.py:79",
        "tpu": "src/repro/kernels/lut_dequant_gemm.py::lut_dequant_gemm",
        "launches": serve["launches"],
        "launches_tc": serve["launches_tc"],
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        **times(rows, 4, "one decode step of one stablelm-12b layer: its 7 projections at "
                         "B=4, W4, bf16 x (device time; library_bf16_ms: bf16 torch.matmul "
                         "on the bf16 grid values x scale, bf16 output)"),
        "prefill": times(rows, 512, "one layer's 7 projections at B=4x128, W4, bf16 x"),
        "gemma2_forward": {
            **times(grows, FLASH_SEQ, f"one gemma2-2b layer's 7 projections at B=1x{FLASH_SEQ}, "
                                      f"W4, bf16 x"),
            "launches": fwd["lut_dequant_gemm_launches"],
            "launches_tc": fwd["lut_dequant_gemm_launches_tc"],
            "ms_in_forward": fwd["lut_dequant_gemm_profiled_ms"]},
        "gemma2_serve": {
            "at": f"phase 14b: gemma2-2b, {GEMMA_SERVE_LAYERS} layers, W4A4 pallas, bf16, "
                  f"ServeEngine(batch=4, "
                  f"max_seq={GEMMA_SERVE_SEQ}), {GEMMA_REQUESTS} requests of 3072-4096 prompt "
                  f"tokens, {GEMMA_NEW} new each; prefill_ms at 4 x 4096 and step_ms on CUDA "
                  f"events, busy from torch.profiler, the rest on the host clock",
            **{name: {key: r[key] for key in GEMMA_SERVE_KEYS}
               for name, r in (("serve_profile", gserve["serve_profile"]),
                               ("baseline", gserve["baseline"]))},
            "decode": times(grows, 4, "one gemma2-2b layer's 7 projections at B=4, W4, bf16 x"),
            "prefill": times(grows, 4 * GEMMA_BUCKET, f"one gemma2-2b layer's 7 projections at "
                                                      f"B=4x{GEMMA_BUCKET}, W4, bf16 x"),
            "token_agreement": gserve["token_agreement"],
            "semantics": gserve["semantics"], "answers": gserve["answers"]},
        "card_vs_cpu_rel_err": cpu_rel,
        "deepseek": {
            "at": f"phase 17a: deepseek-v2-lite-16b, {DS_SERVE_LAYERS} layers, W4A4 pallas, "
                  f"bf16, "
                  f"ServeEngine(batch=4, max_seq={DS_MAX_SEQ}), 8 requests of 16-{DS_PROMPT} "
                  f"prompt tokens, {DS_NEW} new each; prefill_ms at 4 x {DS_PROMPT} and step_ms "
                  f"on CUDA events, profiles from torch.profiler, the rest on the host clock",
            **deepseek["a"],
            "mla_chunked": deepseek["b"], "card_vs_cpu_rel_err": deepseek["d"]["rel_err"],
            "decode": times(deepseek["e"]["dequant_rows"], 4, ds_at("B=4, W4, bf16 x")),
            "prefill": times(deepseek["e"]["dequant_rows"], 4 * DS_PROMPT,
                             ds_at(f"B=4x{DS_PROMPT}, W4, bf16 x"))},
        "zamba2": {
            "at": f"phase 18a: zamba2-7b, {ZB_SERVE_LAYERS} layers, W4A4 pallas, bf16, "
                  f"ServeEngine(batch=4, max_seq={DS_MAX_SEQ}), 8 requests of 16-{DS_PROMPT} "
                  f"prompt tokens, {DS_NEW} new each; prefill_ms at 4 x {DS_PROMPT} and step_ms "
                  f"on CUDA events, profiles from torch.profiler, the rest on the host clock",
            **zamba2["a"], "card_vs_cpu_rel_err": zamba2["c"]["rel_err"],
            "prefill_vs_decode_rel_err": zamba2["c"]["prefill_vs_decode_rel_err"],
            "decode": times(zamba2["d"]["dequant_rows"], 4, zb_at("B=4, W4, bf16 x")),
            "prefill": times(zamba2["d"]["dequant_rows"], 4 * DS_PROMPT,
                             zb_at(f"B=4x{DS_PROMPT}, W4, bf16 x"))},
        "rwkv": {
            "at": f"phase 19a: rwkv6-3b, {RW_SERVE_LAYERS} layers, W4A4 pallas, bf16, "
                  f"ServeEngine(batch=4, max_seq={DS_MAX_SEQ}), 8 requests of 16-{DS_PROMPT} "
                  f"prompt tokens, {DS_NEW} new each; prefill_ms at 4 x {DS_PROMPT} and step_ms "
                  f"on CUDA events, profiles from torch.profiler, the rest on the host clock",
            **rwkv["a"], "card_vs_cpu_rel_err": rwkv["c"]["rel_err"],
            "prefill_vs_decode_rel_err": rwkv["c"]["prefill_vs_decode_rel_err"],
            "decode": times(rwkv["d"]["dequant_rows"], 4, rw_at("B=4, W4, bf16 x")),
            "prefill": times(rwkv["d"]["dequant_rows"], 4 * DS_PROMPT,
                             rw_at(f"B=4x{DS_PROMPT}, W4, bf16 x"))},
        "whisper": {
            "at": f"phase 20a: whisper-large-v3, {WH_SERVE_LAYERS} + {WH_SERVE_LAYERS} layers, "
                  f"W4A4 pallas, bf16, "
                  f"attn_impl=flash, bf16 caches at max_seq {WH_MAX_SEQ}: a {WH_PROMPT}-token "
                  f"prefill over 4 x 1500 bf16 frames, then {WH_DECODE} greedy decode steps "
                  f"(CUDA events; profiles from torch.profiler); 20b ServeEngine(batch=4, "
                  f"max_seq={WH_MAX_SEQ}) text only; 20c card vs CPU at 2 + 2 layers f32",
            "launches": whisper["a"]["launches_prefill"]["lut_dequant_gemm"]
            + whisper["a"]["launches_decode"]["lut_dequant_gemm"],
            **whisper["a"], "serve": whisper["b"], "routes_f32_frames": whisper["c"]["routes"],
            "card_vs_cpu_rel_err": whisper["c"]["rel_err"],
            "prefill_vs_decode_rel_err": whisper["c"]["prefill_vs_decode_rel_err"],
            "decode": times(whisper["e"]["dequant_rows"], 4, wh_at("B=4, W4, bf16 x")),
            "prefill": times(whisper["e"]["dequant_rows"], wh_rows,
                             wh_at(f"B={wh_rows} (the encoder's 4 x 1500 rows), W4, bf16 x"))},
        "vlm": {
            "at": f"phase 21a: internvl2-1b, {VL_SERVE_LAYERS} layers, W4A4 pallas, bf16, "
                  f"attn_impl=flash: "
                  f"the cache-free forward over 4 x (256 patches + {VL_TEXT} tokens), a prefill "
                  f"of 4 x (256 + {VL_PROMPT}) and {VL_DECODE} greedy decode steps (CUDA events), "
                  f"ServeEngine(batch=4, max_seq={VL_MAX_SEQ}) text only; 21b card vs CPU at "
                  f"2 layers f32",
            "launches": vlm["a"]["launches_forward"]["lut_dequant_gemm"]
            + vlm["a"]["launches_prefill"]["lut_dequant_gemm"]
            + vlm["a"]["launches_decode"]["lut_dequant_gemm"],
            **{k: vlm["a"][k] for k in ("launches_forward", "launches_prefill", "launches_decode",
                                        "forward_ms", "prefill_ms", "step_ms", "tok_s",
                                        "serve")},
            "card_vs_cpu_rel_err": vlm["b"]["rel_err"],
            "prefill_vs_decode_rel_err": vlm["b"]["prefill_vs_decode_rel_err"],
            "decode_vs_forward_rel_err": vlm["b"]["decode_vs_forward_rel_err"],
            "decode": times(vlm["d"]["dequant_rows"], 4, vl_at("B=4, W4, bf16 x")),
            "prefill": times(vlm["d"]["dequant_rows"], vl_rows,
                             vl_at(f"B={vl_rows} (the forward's 4 x 384 rows), W4, bf16 x"))},
        "dist": dist_at(dist_r, "pallas"),
        "seq_shard": {
            "at": f"phase 24b: zamba2-7b at published widths, one 'MMMMMS' unit, W4A4 pallas, "
                  f"bf16, ServeEngine(ctx=) on a gloo world of 2 sharing the card, mesh (1, 2), "
                  f"seq_shard, max_seq {SQ_MAX}: each rank's launches (its F-shards)",
            "launches": [r["launches"] for r in seq_shard["b"]["ranks"]],
            "launches_tc": [r["launches_tc"] for r in seq_shard["b"]["ranks"]]},
        "ok": True,
    }, {
        "name": "lut_stream_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lut_stream_gemm_sm90.cu",
        "cuda_core_source": "src/repro_torch/kernels/csrc/lut_stream_gemm.cu",
        "replaces": "src/repro/kernels/lut_stream_gemm.py:96",
        "tpu": "src/repro/kernels/lut_stream_gemm.py::lut_stream_gemm",
        "launches": lserve["launches"],
        "launches_tc": lserve["launches_tc"],
        "max_abs_err": stream_abs,
        **stream_times(srows, 4, "one decode step of one stablelm-12b layer: its 7 projections "
                                 "at N=4, W1A3 p=4, the int8 tensor-core route (device time; "
                                 "bound: 2*M*G*R*N at the int8 peak or the bytes; "
                                 "lookup_bound_ms: M*G*N lookups at the f32 rate; library: the "
                                 "one-hot [M, G*R] f32 torch.matmul; cuda_core_ms: the CUDA-core "
                                 "kernel on the same inputs)"),
        "prefill": stream_times(srows, 512, "one layer's 7 projections at N=4x128, W1A3 p=4"),
        "cp_async": {"at": "stablelm-12b w_down at W1A3 p=5 (wpacked by cp.async: 4G % 16 != 0), "
                           "device time", "rows": cprows},
        "serve": {"decode_step": lserve["decode_profile"], "prefill": lserve["prefill_profile"],
                  "prefill_ms": lserve["prefill_ms"], "step_ms": lserve["step_ms"]},
        "card_vs_cpu_rel_err": lut_cpu_rel,
        "deepseek": {
            "at": f"phase 17c: deepseek-v2-lite-16b at full width, depth cut to "
                  f"{DS_LUT_LAYERS} layers, W1A3 p=4 lut calibrated + prepared, phase 17a's "
                  f"requests",
            **deepseek["c"],
            "decode": stream_times(deepseek["e"]["stream_rows"], 4, ds_at("N=4, W1A3 p=4")),
            "prefill": stream_times(deepseek["e"]["stream_rows"], 4 * DS_PROMPT,
                                    ds_at(f"N=4x{DS_PROMPT}, W1A3 p=4"))},
        "zamba2": {
            "at": f"phase 18b: zamba2-7b at full width, depth cut to {ZB_LUT_LAYERS} layers (one "
                  f"'MMMMMS' unit), W1A3 p=4 lut calibrated + prepared, phase 18a's requests",
            **zamba2["b"],
            "decode": stream_times(zamba2["d"]["stream_rows"], 4, zb_at("N=4, W1A3 p=4")),
            "prefill": stream_times(zamba2["d"]["stream_rows"], 4 * DS_PROMPT,
                                    zb_at(f"N=4x{DS_PROMPT}, W1A3 p=4"))},
        "rwkv": {
            "at": f"phase 19b: rwkv6-3b at full width, depth cut to {RW_LUT_LAYERS} layers, "
                  f"W1A3 p=4 lut calibrated + prepared, phase 19a's requests",
            **rwkv["b"],
            "decode": stream_times(rwkv["d"]["stream_rows"], 4, rw_at("N=4, W1A3 p=4")),
            "prefill": stream_times(rwkv["d"]["stream_rows"], 4 * DS_PROMPT,
                                    rw_at(f"N=4x{DS_PROMPT}, W1A3 p=4"))},
        "whisper": {
            "at": f"phase 20d: whisper-large-v3 at full width, depth cut to {WH_LUT_LAYERS} + "
                  f"{WH_LUT_LAYERS} layers, W1A3 p=4 lut calibrated with frames + prepared, "
                  f"phase 20b's requests, and its transcription path",
            **whisper["d"]["serve"],
            "transcription_prefill": whisper["d"]["transcription_prefill"],
            "transcription_decode": whisper["d"]["transcription_decode"],
            "decode": stream_times(whisper["e"]["stream_rows"], 4, wh_at("N=4, W1A3 p=4")),
            "prefill": stream_times(whisper["e"]["stream_rows"], wh_rows,
                                    wh_at(f"N={wh_rows}, W1A3 p=4"))},
        "vlm": {
            "at": f"phase 21c: internvl2-1b at full width, depth cut to {VL_LUT_LAYERS} layers, "
                  f"W1A3 p=4 lut calibrated + prepared, phase 21a's requests",
            **vlm["c"],
            "decode": stream_times(vlm["d"]["stream_rows"], 4, vl_at("N=4, W1A3 p=4")),
            "prefill": stream_times(vlm["d"]["stream_rows"], vl_rows,
                                    vl_at(f"N={vl_rows}, W1A3 p=4"))},
        "planned_serve": {
            "at": "phase 13: stablelm-12b W1A3 lut served through ServeEngine(plan=) on phase "
                  "8's requests; launches by route from the counters, times on the host clock",
            **{name: {key: r[key] for key in PLANNED_KEYS if key in r}
               for name, r in planned.items()},
            "candidates": planned["measured_16GiB"]["candidates"]},
        "plans_families": pf_launches(("launches", "launches_tc", "launches_lookup")),
        "live_ops": {
            "at": f"phase 15: phase 8's model at full width, {LIVE_LAYERS} layers; a: phase 8's "
                  f"requests served from the restored prepared checkpoint; b: the LiveServer "
                  f"serve killed at 3 waves (all attempts); c: the serve across the hot-swap to "
                  f"the 16 GiB plan",
            **{k: {key: live[k][key] for key in ("launches", "launches_tc", "launches_lookup")
                   if key in live[k]} for k in ("a", "b", "c")},
            "restore_s": live["a"]["restore_s"], "restore_gb_s": live["a"]["restore_gb_s"],
            "prepare_s": live["a"]["prepare_s"], "save_s": live["a"]["save_s"],
            "restart_to_first_token_s": live["b"]["restart_to_first_token_s"],
            "stage_s": live["c"]["stage_s"], "flip_wave": live["c"]["flip_wave"],
            "step_with_stage_ms": live["c"]["step_with_stage_ms"],
            "step_quiet_ms": live["c"]["step_quiet_ms"], "chaos": live["d"]},
        "dist": {**dist_at(dist_r, "lut"), "serve_ctx": dist_r["a"]["ctx"],
                 "serve_plain": dist_r["a"]["plain"]},
        "ok": True,
    }, {
        "name": "lut_stream_gemm_lookup",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lut_stream_lookup_sm90.cu",
        "replaces": "src/repro/kernels/lut_stream_gemm.py:96",
        "tpu": "src/repro/kernels/lut_stream_gemm.py::lut_stream_gemm (packs with b_o == 1 and "
               "32 < R <= 256)",
        "launches": planned["analytic_16GiB"]["launches_lookup"],
        "max_abs_err": lookup_abs,
        **lookup_times(7, 4, "one decode step of one stablelm-12b layer: its 7 projections at "
                             "N=4, W1A3 p=7 (the 16 GiB plan's w_up / w_gate), the lookup route "
                             "(device time; bound: the bytes of wpacked, the slices and the "
                             "output, or M*G*N lookup-adds at the f32 rate; library: the one-hot "
                             "[M, G*R] f32 torch.matmul; cuda_core_ms: the CUDA-core "
                             "kernel on the same inputs)"),
        "prefill": lookup_times(7, 512, "one layer's 7 projections at N=4x128, W1A3 p=7"),
        "by_p": {p: {"decode": lookup_times(p, 4, f"N=4, W1A3 p={p}"),
                     "prefill": lookup_times(p, 512, f"N=4x128, W1A3 p={p}")}
                 for p in LOOKUP_PS},
        "planned_serve": {name: {"launches": r["launches_lookup"]} for name, r in planned.items()},
        "live_ops": {"c": {"launches": live["c"]["launches_lookup"]}},
        "plans_families": pf_launches(("launches_lookup",)),
        "ok": True,
    }, {
        "name": "lut_stream_gemm_canon",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lut_canon.cu",
        "replaces": "src/repro/core/multiset.py:139",
        "tpu": "XLA in the reference (multiset.canonicalize, multiset_rank, perm_id; no "
               "pallas_call), plus the compose step of src/repro/kernels/lut_stream_gemm.py:45",
        "launches": lserve["launches_canon"],
        "max_abs_err": 0,
        **canon_times(srows, 4, "one decode step of one stablelm-12b layer: its 7 projections' "
                                "canonicalize + compose at N=4, W1A3 p=4 (device time; plain: "
                                "the torch chain of argsort, gather, rank, Lehmer id)"),
        "prefill": canon_times(srows, 512, "one layer's 7 projections at N=4x128"),
        "planned_serve": {name: {"launches": r["launches_canon"]} for name, r in planned.items()},
        "live_ops": {k: {"launches": live[k]["launches_canon"]} for k in ("a", "b", "c")},
        "plans_families": pf_launches(("launches_canon",)),
        "deepseek": {
            "launches": deepseek["c"]["launches_canon"],
            "decode": canon_times(deepseek["e"]["stream_rows"], 4, ds_at("N=4, W1A3 p=4")),
            "prefill": canon_times(deepseek["e"]["stream_rows"], 4 * DS_PROMPT,
                                   ds_at(f"N=4x{DS_PROMPT}, W1A3 p=4"))},
        "zamba2": {
            "launches": zamba2["b"]["launches_canon"],
            "decode": canon_times(zamba2["d"]["stream_rows"], 4, zb_at("N=4, W1A3 p=4")),
            "prefill": canon_times(zamba2["d"]["stream_rows"], 4 * DS_PROMPT,
                                   zb_at(f"N=4x{DS_PROMPT}, W1A3 p=4"))},
        "rwkv": {
            "launches": rwkv["b"]["launches_canon"],
            "decode": canon_times(rwkv["d"]["stream_rows"], 4, rw_at("N=4, W1A3 p=4")),
            "prefill": canon_times(rwkv["d"]["stream_rows"], 4 * DS_PROMPT,
                                   rw_at(f"N=4x{DS_PROMPT}, W1A3 p=4"))},
        "whisper": {
            "launches": whisper["d"]["serve"]["launches_canon"],
            "decode": canon_times(whisper["e"]["stream_rows"], 4, wh_at("N=4, W1A3 p=4")),
            "prefill": canon_times(whisper["e"]["stream_rows"], wh_rows,
                                   wh_at(f"N={wh_rows}, W1A3 p=4"))},
        "vlm": {
            "launches": vlm["c"]["launches_canon"],
            "decode": canon_times(vlm["d"]["stream_rows"], 4, vl_at("N=4, W1A3 p=4")),
            "prefill": canon_times(vlm["d"]["stream_rows"], vl_rows,
                                   vl_at(f"N={vl_rows}, W1A3 p=4"))},
        "ok": True,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "cuda_core_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:109",
        "tpu": "src/repro/kernels/flash_attention.py::flash_attention",
        "launches": fwd["launches"],
        "max_abs_err": flash_abs,
        **flash_forward_times(frows, get_config("gemma2-2b"), fwd),
        "shapes": frows,
        "forward": fwd,
        "rwkv": {"launches": rwkv["a"]["flash_attention_launches"],
                 "at": "phase 19a: rwkv6-3b has no attention (asserted: no launch)"},
        "whisper": {
            "at": f"phase 20a: whisper-large-v3's encoder, causal=False, B=4, S=T=1500, 20 heads "
                  f"of 64: launches in the prefill with frames (bf16: the tensor cores) and in "
                  f"{WH_DECODE} decode steps (none); 20e the kernel at that shape, bf16 and f32, "
                  f"beside scaled_dot_product_attention(is_causal=False)",
            "launches": whisper["a"]["launches_prefill"]["flash_attention"],
            "launches_tc": whisper["a"]["launches_prefill"]["flash_attention_tc"],
            "launches_decode": whisper["a"]["launches_decode"]["flash_attention"],
            "encoder_ms_in_prefill": (whisper["a"]["prefill_profile"] or {}).get("flash_ms"),
            **{k: whisper["e"]["flash_rows"][0][k] for k in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library")},
            "shapes": whisper["e"]["flash_rows"]},
        "vlm": {
            "at": f"phase 21a: internvl2-1b's cache-free forward, causal, B=4, S=T=256+{VL_TEXT}, "
                  f"14 / 2 heads of 64 (bf16: the tensor cores); 21d the kernel at that shape "
                  f"beside scaled_dot_product_attention(is_causal=True); none in training "
                  f"(attn_impl=xla: the kernel has no backward)",
            "launches": vlm["a"]["launches_forward"]["flash_attention"],
            "launches_tc": vlm["a"]["launches_forward"]["flash_attention_tc"],
            **{k: vlm["d"]["flash_rows"][0][k] for k in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library")},
            "shapes": vlm["d"]["flash_rows"]},
        "ok": True,
    }]}
    print(json.dumps({"phase": "obs", "card": smi, "result": obs}, default=str))
    print(json.dumps({"phase": "deepseek", "card": smi, "result": deepseek}, default=str))
    print(json.dumps({"phase": "zamba2", "card": smi, "result": zamba2}, default=str))
    print(json.dumps({"phase": "rwkv", "card": smi, "result": rwkv}, default=str))
    print(json.dumps({"phase": "whisper", "card": smi, "result": whisper}, default=str))
    print(json.dumps({"phase": "vlm_train", "card": smi, "result": vlm}, default=str))
    print(json.dumps({"phase": "dist", "card": smi, "result": dist_r}, default=str))
    print(json.dumps({"phase": "dist_train", "card": smi, "result": dist_train}, default=str))
    print(json.dumps({"phase": "seq_shard", "card": smi, "result": seq_shard}, default=str))
    print(json.dumps({"phase": "dryrun", "card": smi, "result": dry}, default=str))
    print(json.dumps({"phase": "plans_families", "card": smi, "result": pf}, default=str))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
