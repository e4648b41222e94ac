#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every kernel of the port's serve path from the sources in the
checkout, holds each against its plain PyTorch version on the card, serves
stablelm-12b at its published full widths through the port's own entry
points (W4A4, ``mode="pallas"``, prepared, continuous batching), and checks
the card against the CPU and the continuous driver against the per-token
loop.  Any failed phase exits non-zero.  It imports no JAX and nothing of the
JAX package.  The second-to-last line is a JSON object describing each kernel
(launches on the serve path, error, times beside its bound); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
N_LAYERS = 40                 # serve depth of phase 3 (stablelm-12b has 40)
TOL_REL = 1e-4                # kernel vs plain: f32 sums in another order, K <= 13824
TOL_CPU = 1e-3                # card vs CPU logits, relative to max |logit|


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


def log_breakdown(what, by_name, wall_ms):
    """Print the device time of one call by kernel, beside its wall time:
    busy share, the packed-code kernel's share, the largest other kernels."""
    if by_name is None:
        log(f"  {what}: device time by kernel not measured (the profiler saw no device time)")
        return

    def total(keep):
        picked = [v for name, v in by_name.items() if keep("lut_dequant_gemm" in name)]
        return sum(ms for ms, _n in picked), sum(n for _ms, n in picked)

    busy, launches = total(lambda ours: True)
    ours_ms, ours_n = total(lambda ours: ours)
    log(f"  {what}: device busy {busy:.2f} of {wall_ms:.2f} ms (idle share "
        f"{1 - busy / wall_ms:.3f}), {launches:.0f} kernel launches; lut_dequant_gemm "
        f"{ours_ms:.2f} ms in {ours_n:.0f} launches ({ours_ms / busy:.3f} of busy); other "
        f"kernels {busy - ours_ms:.2f} ms in {launches - ours_n:.0f} launches, largest:")
    others = sorted(((ms, n, name) for name, (ms, n) in by_name.items()
                     if "lut_dequant_gemm" not in name), reverse=True)
    for ms, n, name in others[:6]:
        log(f"    {ms:8.3f} ms {n:5.0f} x  {name[:90]}")


def phase_kernel(torch, dev):
    from repro_torch.core.api import LutLinearSpec, quantize_linear
    from repro_torch.kernels import lut_dequant_gemm as dq
    from repro_torch.kernels import ref
    from repro_torch.core.quantize import QuantSpec

    gen = torch.Generator(device=dev).manual_seed(1)
    grids = [(1, "int"), (2, "int"), (4, "int"), (8, "int"), (2, "fp"), (4, "fp"), (8, "fp")]
    shapes = [(32, 16), (64, 48), (129, 200), (256, 96),                    # unit-test shapes
              (5120, 5120), (5120, 1280), (5120, 13824), (13824, 5120),     # full width
              (1001, 300)]                                                  # ragged K
    worst_rel = worst_abs = 0.0
    n_cases = 0
    for bw, kind in grids:
        for k, f in shapes:
            w = torch.randn((k, f), generator=gen, device=dev)
            q = quantize_linear(w, LutLinearSpec(bw=bw, w_kind=kind))
            del w
            g = QuantSpec(bw, kind).grid()
            for b in (1, 4, 37, 256):
                x32 = torch.randn((b, k), generator=gen, device=dev)
                for x in (x32, x32.to(torch.bfloat16)):
                    y = dq.lut_dequant_gemm(x, q.codes, q.scale, bw=bw, k=k, grid_values=g)
                    y_plain = ref.lut_dequant_gemm_ref(x, q.codes, q.scale, bw=bw, k=k, grid=g)
                    diff = (y - y_plain).abs().max().item()
                    rel = diff / max(y_plain.abs().max().item(), 1e-30)
                    check(rel <= TOL_REL, f"kernel vs plain: bw={bw} {kind} B={b} K={k} "
                                          f"F={f} {x.dtype}: rel err {rel:.3e} > {TOL_REL}")
                    worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, diff)
                    n_cases += 1
                    if b == 37:
                        alone = torch.cat([
                            dq.lut_dequant_gemm(x[i : i + 1], q.codes, q.scale, bw=bw, k=k,
                                                grid_values=g) for i in range(b)])
                        check(torch.equal(alone, y),
                              f"row alone != row in a batch of 37: bw={bw} {kind} K={k} F={f}")
    torch.cuda.synchronize()
    log(f"phase 2: {n_cases} kernel-vs-plain cases + per-row invariance at B=37 passed; "
        f"worst rel err {worst_rel:.3e}, worst abs err {worst_abs:.3e} (tol {TOL_REL})")
    return worst_rel, worst_abs


def phase_kernel_times(torch, dev, cfg, card):
    """Kernel, plain-version and library times at the serve path's shapes:
    decode (B = 4) and the largest prefill (B = 4 x 128), W4, bf16 x; the
    kernel is held against its plain version at each of them too."""
    from repro_torch.core.api import LutLinearSpec, dequantize_weights, quantize_linear
    from repro_torch.kernels import lut_dequant_gemm as dq
    from repro_torch.kernels import ref
    from repro_torch.core.quantize import QuantSpec

    gen = torch.Generator(device=dev).manual_seed(2)
    g = QuantSpec(4, "int").grid()
    rows = []
    worst_rel = worst_abs = 0.0
    for name, (k, f) in layer_shapes(cfg).items():
        w = torch.randn((k, f), generator=gen, device=dev)
        q = quantize_linear(w, LutLinearSpec(bw=4))
        w_t = dequantize_weights(q).T.contiguous()          # [F, K] f32, pre-decoded
        del w
        # Rotate over enough copies of the codes that they overflow the 50 MB
        # L2: the serve path reads each layer's codes cold.
        n_copies = max(1, math.ceil(200e6 / q.codes.numel()))
        codes = [q.codes.clone() for _ in range(n_copies)]
        for b in (4, 4 * 128):
            x = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
            x32 = x.float()
            y = dq.lut_dequant_gemm(x, q.codes, q.scale, bw=4, k=k, grid_values=g)
            y_plain = ref.lut_dequant_gemm_ref(x, q.codes, q.scale, bw=4, k=k, grid=g)
            diff = (y - y_plain).abs().max().item()
            rel = diff / max(y_plain.abs().max().item(), 1e-30)
            check(rel <= TOL_REL, f"kernel vs plain at {name} B={b}: rel err {rel:.3e}")
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, diff)
            kern = time_ms(torch, lambda i: dq.lut_dequant_gemm(
                x, codes[i % n_copies], q.scale, bw=4, k=k, grid_values=g), 20)
            plain = time_ms(torch, lambda i: ref.lut_dequant_gemm_ref(
                x, codes[i % n_copies], q.scale, bw=4, k=k, grid=g), 5)
            lib = time_ms(torch, lambda i: torch.matmul(x32, w_t.T), 5)
            bnd, by = bound_s(b, k, f, 4, 2, card)
            rows.append(dict(proj=name, B=b, K=k, F=f, ms=kern, plain_ms=plain,
                             library_ms=lib, bound_ms=bnd * 1e3, bound_by=by))
            log(f"  {name:6s} B={b:4d} K={k:5d} F={f:5d}: kernel {kern:.4f} ms, plain "
                f"{plain:.4f} ms, torch.matmul(f32 decoded) {lib:.4f} ms, bound "
                f"{bnd*1e3:.4f} ms ({by})")
        del codes, w_t, q
    log(f"phase 2: the serve path's shapes (B=4 and 512) agree with the plain version; "
        f"worst rel err {worst_rel:.3e}, worst abs err {worst_abs:.3e}")
    return rows, worst_rel, worst_abs


# ---------------------------------------------------------------------------
# Phase 3: full-width serve
# ---------------------------------------------------------------------------


def phase_serve(torch, dev, cfg):
    from repro_torch.core import LutLinearSpec
    from repro_torch.kernels import lut_dequant_gemm as dq
    from repro_torch.models.model import build_model
    from repro_torch.serve.serving import Request, ServeEngine
    import numpy as np

    if cfg.n_layers != N_LAYERS:
        log(f"phase 3: depth cut from {cfg.n_layers} to {N_LAYERS} layers")
        cfg = dataclasses.replace(cfg, n_layers=N_LAYERS)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_quantized(LutLinearSpec(bw=4, ba=4, mode="pallas"), seed=0, device=dev)
    params = model.prepare(params, n_hint=4)
    torch.cuda.synchronize()
    log(f"phase 3: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"hd={cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab_size} layers={cfg.n_layers}, "
        f"W4A4 pallas, prepared in {time.perf_counter()-t0:.1f}s; "
        f"{torch.cuda.memory_allocated(dev)/1e9:.2f} GB on the card")
    eng = ServeEngine(model, params, batch=4, max_seq=256, decode="scan", device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 97, 8)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=32) for n in lens]
    eng.generate([Request(prompt=reqs[0].prompt[:16], max_new_tokens=2)])   # warmup
    torch.cuda.synchronize()

    records = []
    eng.on_wave = records.append
    eng.host_syncs = 0
    dq.launches = 0
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
    launches = dq.launches
    sync_warnings = [str(w.message) for w in caught
                     if "called a synchronizing CUDA operation" in str(w.message)]

    check(all(len(o) == 32 for o in outs), f"token counts {[len(o) for o in outs]} != 32 each")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o), "token outside [0, vocab)")
    check(eng.host_syncs == len(records),
          f"host_syncs {eng.host_syncs} != waves {len(records)}")
    prefills = sum(1 for r in records if r.admitted)
    steps = sum(r.steps for r in records)
    want = 7 * cfg.n_layers * (prefills + steps)
    check(launches == want, f"kernel launches {launches} != 7 x {cfg.n_layers} x "
                            f"({prefills} prefills + {steps} decode steps) = {want}")
    check(len(sync_warnings) == eng.host_syncs,
          f"{len(sync_warnings)} synchronizing calls in the serve loop, expected only the "
          f"{eng.host_syncs} token fetches: {sorted(set(sync_warnings))[:3]}")
    n_tok = sum(len(o) for o in outs)
    log(f"phase 3: served {len(reqs)} requests (prompt lengths {lens.tolist()}), {n_tok} "
        f"tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s end to end, prefill included); "
        f"{len(records)} waves, {prefills} prefills, {steps} decode steps, "
        f"{eng.host_syncs} host syncs, {launches} kernel launches "
        f"(= 7 x {cfg.n_layers} x {prefills + steps}); sync-debug warnings "
        f"{len(sync_warnings)} (all token fetches); admissions {eng.admissions}")

    # Steady-state times, outside the counted run.
    caches = eng._new_cache()
    toks = torch.randint(0, cfg.vocab_size, (4, 128), device=dev, dtype=torch.int32)
    pad = torch.zeros((4,), dtype=torch.int32, device=dev)
    prefill_ms = time_ms(torch, lambda i: model.prefill(params, toks, caches, pad_len=pad), 3)
    tok = toks[:, -1:]
    pos = torch.full((4,), 128, dtype=torch.int32, device=dev)
    step_ms = time_ms(torch, lambda i: model.decode_step(params, tok, caches, pos, pad_len=pad), 10)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"phase 3: prefill B=4 x 128 tokens {prefill_ms:.2f} ms; decode step B=4 "
        f"{step_ms:.2f} ms ({4e3 / step_ms:.1f} tok/s); peak memory {peak/1e9:.2f} GB")
    log("phase 3: where the device time goes (torch.profiler; wall time from the "
        "unprofiled runs above):")
    log_breakdown("prefill B=4 x 128", device_time_by_kernel(
        torch, lambda: model.prefill(params, toks, caches, pad_len=pad), 2), prefill_ms)
    log_breakdown("decode step B=4", device_time_by_kernel(
        torch, lambda: model.decode_step(params, tok, caches, pos, pad_len=pad), 5), step_ms)
    del eng, params, caches
    torch.cuda.empty_cache()
    return dict(launches=launches, wall_s=wall, tokens=n_tok, prefill_ms=prefill_ms,
                step_ms=step_ms, peak_gb=peak / 1e9, waves=len(records))


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
    return err / scale


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT}/src/repro_torch not found: run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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
    from repro_torch.kernels import build

    t_all = time.perf_counter()
    try:
        build.load("lut_dequant_gemm")
        info = build.build_info["lut_dequant_gemm"]
        regs = sorted({ln.split("info    : ")[-1] for ln in info["log"].splitlines()
                       if "registers" in ln})
        log(f"phase 1: built lut_dequant_gemm.cu in {info['seconds']:.1f} s "
            f"(nvcc, sm_90a): {'; '.join(regs)}")
        cfg = get_config("stablelm-12b")
        worst_rel, worst_abs = phase_kernel(torch, dev)
        rows, rel2, abs2 = phase_kernel_times(torch, dev, cfg, hw.H100_SXM)
        worst_rel, worst_abs = max(worst_rel, rel2), max(worst_abs, abs2)
        serve = phase_serve(torch, dev, cfg)
        cpu_rel = phase_cpu_and_loop(torch, dev, cfg)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")

    def layer_sum(b, key):
        return sum(r[key] for r in rows if r["B"] == b)

    dec_bound = layer_sum(4, "bound_ms")
    pre_bound = layer_sum(512, "bound_ms")
    kernels = {"kernels": [{
        "name": "lut_dequant_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lut_dequant_gemm.cu",
        "replaces": "src/repro/kernels/lut_dequant_gemm.py:79",
        "tpu": "src/repro/kernels/lut_dequant_gemm.py::lut_dequant_gemm",
        "launches": serve["launches"],
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "at": "one decode step of one stablelm-12b layer: its 7 projections at B=4, W4, bf16 x",
        "ms": layer_sum(4, "ms"),
        "plain_ms": layer_sum(4, "plain_ms"),
        "bound_ms": dec_bound,
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows if r["B"] == 4)
                    else "operations",
        "library_ms": layer_sum(4, "library_ms"),
        "prefill": {
            "at": "one layer's 7 projections at B=4x128, W4, bf16 x",
            "ms": layer_sum(512, "ms"), "plain_ms": layer_sum(512, "plain_ms"),
            "bound_ms": pre_bound,
            "bound_by": "operations" if all(r["bound_by"] == "operations"
                                            for r in rows if r["B"] == 512) else "bytes",
            "library_ms": layer_sum(512, "library_ms"),
        },
        "card_vs_cpu_rel_err": cpu_rel,
        "ok": True,
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
