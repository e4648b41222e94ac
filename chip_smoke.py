#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every kernel of the port's serve paths from the sources in the
checkout (one ``nvcc`` per source, started together), holds each against its
plain PyTorch version on the card, and serves stablelm-12b at its published
full widths through the port's own entry points on two paths:

* W4A4, ``mode="pallas"``, prepared — the ``lut_dequant_gemm`` kernel;
* W1A3 p=4, ``mode="lut"``, calibrated and prepared — the paper's int-LUT
  mode, whose int32 sums come from the ``lut_stream_gemm`` kernel;

each with continuous batching, every kernel's launch count set to 0 just
before the path and read just after.  It checks the card against the CPU and
the continuous driver against the per-token loop.  Any failed phase exits
non-zero.  It imports no JAX and nothing of the JAX package.  The
second-to-last line is a JSON object describing each kernel (launches on its
serve path, error, times beside its bound); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
N_LAYERS = 40                 # serve depth of phases 3 and 8 (stablelm-12b has 40)
TOL_REL = 1e-4                # kernel vs plain: f32 sums in another order, K <= 13824
TOL_CPU = 1e-3                # card vs CPU logits, relative to max |logit|
TOL_CPU_LUT = 2e-2            # the same for the int-LUT model: 3-bit activation
                              # codes turn f32 last-bit differences (attention,
                              # norms) into whole-step code changes
KERNELS = ("lut_dequant_gemm", "lut_stream_gemm")
LUT_SPEC = dict(bw=1, ba=3, p=4)   # the paper's W1A3 (the reference's serve benchmark)


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


def log_breakdown(what, by_name, wall_ms, *, kernel, card):
    """Print the device time of one call by kernel, beside its wall time:
    busy share, ``kernel``'s share, the largest other kernels."""
    if by_name is None:
        log(f"  {what}: device time by kernel not measured (the profiler saw no device time)")
        return

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
    others = sorted(((ms, n, name) for name, (ms, n) in by_name.items()
                     if kernel not in name), reverse=True)
    for ms, n, name in others[:6]:
        log(f"    {ms:8.3f} ms {n:5.0f} x  {name[:90]}")


def reset_launches():
    """Set every kernel's launch count to 0 (just before a path is driven)."""
    from repro_torch.kernels import lut_dequant_gemm as dq
    from repro_torch.kernels import lut_stream_gemm as ss

    dq.launches = ss.launches = 0


def read_launches():
    from repro_torch.kernels import lut_dequant_gemm as dq
    from repro_torch.kernels import lut_stream_gemm as ss

    return {"lut_dequant_gemm": dq.launches, "lut_stream_gemm": ss.launches}


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
# Phases 6-7: lut_stream_gemm vs its plain version; one full-width lut layer
# ---------------------------------------------------------------------------


def stream_bound_s(m, g, n, r, c, pf, card):
    """Least time of one lut_stream_gemm call: each int32 input read once
    (wpacked, msrank, permid, both LUTs) and the output written once, over the
    memory rate; or its M*G*N int32 lookup-adds over the CUDA cores' peak
    operation rate (the float32 non-tensor rate of the table; a data-dependent
    gather-add has no faster unit).  Returns (seconds, bound_by)."""
    nbytes = 4 * (m * g + 2 * g * n + r * c + r * pf + m * n)
    t_bytes, t_ops = nbytes / card.hbm_bandwidth, m * g * n / card.peak_flops_f32
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plain_stream_chunked(torch, ref, wpk, ms, pid, canon, reorder, cols=16):
    """The plain version over column chunks: its [M, G, N] gather would not
    fit the card at N = 512."""
    return torch.cat([
        ref.lut_stream_gemm_ref(wpk, ms[:, c0 : c0 + cols], pid[:, c0 : c0 + cols], canon, reorder)
        for c0 in range(0, ms.shape[1], cols)], dim=1)


def phase_stream_kernel(torch, dev):
    """The CPU tests' sweep on the card: packs (bw, ba, p) with ragged K, column
    tiles nt in 1, 3, 4, 6, 16, kernel == plain version on the card == plain
    version on the CPU, bit for bit."""
    import numpy as np
    from repro_torch.core import engine, luts
    from repro_torch.kernels import lut_stream_gemm as ss
    from repro_torch.kernels import ops, ref

    n_cases = 0
    for bw, ba, p in [(1, 3, 3), (1, 3, 4), (2, 2, 4), (4, 4, 2), (1, 1, 5)]:
        pack = luts.build_lut_pack(bw, ba, p)
        canon, reorder = engine.device_tables(pack, dev)
        for m, k, n in [(16, 3 * p + 1, 6), (8, 13, 6), (300, 101, 4), (1000, 250, 37),
                        (4096, 1030, 129)]:
            rng = np.random.default_rng(m * 1000 + k + n + p)
            wc = torch.from_numpy(rng.integers(0, 2**bw, (m, k)).astype(np.int32))
            ac = torch.from_numpy(rng.integers(0, 2**ba, (k, n)).astype(np.int32))
            want = ops.lut_stream_gemm_full(wc, ac, pack)                 # CPU, plain
            wd, ad = wc.to(dev), ac.to(dev)
            for nt in (1, 3, 4, 6, 16):
                got = ops.lut_stream_gemm_full(wd, ad, pack, nt=nt)
                check(torch.equal(got.cpu(), want),
                      f"lut_stream_gemm_full (bw,ba,p)=({bw},{ba},{p}) M={m} K={k} N={n} "
                      f"nt={nt}: card != CPU plain version")
                n_cases += 1
            wpk = engine.prepare_stream_weights(wd, pack).wpk
            idx = engine.canonicalize_activations(ad, pack)
            check(torch.equal(ss.lut_stream_gemm(wpk, idx.msrank, idx.permid, canon, reorder),
                              ref.lut_stream_gemm_ref(wpk, idx.msrank, idx.permid, canon, reorder)),
                  f"lut_stream_gemm != plain version on the card: ({bw},{ba},{p}) M={m} N={n}")
            n_cases += 1
    torch.cuda.synchronize()
    log(f"phase 6: {n_cases} lut_stream_gemm-vs-plain cases (5 packs, ragged K, nt 1/3/4/6/16, "
        f"card vs card plain and vs CPU plain) equal bit for bit")


def phase_stream_times(torch, dev, cfg, card, smi):
    """Kernel, plain and library times of lut_stream_gemm at the lut serve
    path's shapes: one stablelm-12b layer's seven projections at W1A3 p=4,
    decode (N = 4) and prefill (N = 4 x 128), with the kernel held against
    its plain version (over column chunks at N = 512) and the library
    yardstick (the reference's one-hot BLAS form) bit for bit."""
    from repro_torch.core import engine
    from repro_torch.core.api import LutLinearSpec, _lut_pack_cache, quantize_linear
    from repro_torch.core.prepared import prepare_linear
    from repro_torch.core.quantize import quantize
    from repro_torch.kernels import lut_stream_gemm as ss
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(5)
    spec = LutLinearSpec(mode="lut", **LUT_SPEC)
    pack = _lut_pack_cache(spec.bw, spec.ba, spec.p, spec.w_kind, spec.a_kind)
    canon, reorder = engine.device_tables(pack, dev)
    r, c, pf = canon.shape[0], canon.shape[1], reorder.shape[1]
    rows = []
    worst = 0
    for name, (k, f) in layer_shapes(cfg).items():
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
        for b in (4, 4 * 128):
            x = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
            acodes, _ = quantize(x.float().T, spec.aspec())
            idx = engine.canonicalize_activations(acodes, pack)
            ms, pid = idx.msrank, idx.permid
            y = ss.lut_stream_gemm(wpk, ms, pid, canon, reorder)
            y_plain = (ref.lut_stream_gemm_ref(wpk, ms, pid, canon, reorder) if b == 4 else
                       plain_stream_chunked(torch, ref, wpk, ms, pid, canon, reorder))
            worst = max(worst, (y - y_plain).abs().max().item())
            check(torch.equal(y, y_plain), f"lut_stream_gemm != plain at {name} N={b}")
            # composed[g, r, n] = canonical[reordering[r, pid[g, n]], ms[g, n]]
            composed = canon[reorder[:, pid.long()].long(), ms[None].long()]  # [R, G, N]
            composed = composed.permute(1, 0, 2).reshape(g * r, b).float()
            y_lib = torch.matmul(onehot, composed)
            check(torch.equal(y_lib.to(torch.int32), y),
                  f"one-hot BLAS yardstick != kernel at {name} N={b}")
            kern = time_ms(torch, lambda i: ss.lut_stream_gemm(
                wpks[i % n_copies], ms, pid, canon, reorder), 20)
            if b == 4:
                plain = time_ms(torch, lambda i: ref.lut_stream_gemm_ref(
                    wpks[i % n_copies], ms, pid, canon, reorder), 3)
            else:
                plain = time_ms(torch, lambda i: plain_stream_chunked(
                    torch, ref, wpks[i % n_copies], ms, pid, canon, reorder), 1)
            lib = time_ms(torch, lambda i: torch.matmul(onehot, composed), 5)
            bnd, by = stream_bound_s(m, g, b, r, c, pf, card)
            rows.append(dict(proj=name, B=b, K=k, F=f, ms=kern, plain_ms=plain,
                             library_ms=lib, bound_ms=bnd * 1e3, bound_by=by))
            log(f"  {name:6s} N={b:4d} M={m:5d} G={g:4d}: kernel {kern:.4f} ms, plain "
                f"{plain:.4f} ms, one-hot torch.matmul {lib:.4f} ms, bound {bnd*1e3:.4f} ms "
                f"({by}) [{smi}]")
            del composed, y_lib
        del wpks, onehot
    torch.cuda.empty_cache()
    log("phase 6: the lut serve path's shapes (N=4 and 512) equal the plain version and the "
        "one-hot yardstick bit for bit")
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
        before = ss.launches
        ys = [apply_linear(q, x) for q in (q_lut, prepare_linear(q_lut, n_hint=4),
                                           q_str, prepare_linear(q_str, n_hint=4))]
        check(ss.launches == before + 4, f"{name}: {ss.launches - before} kernel launches, want 4")
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
        "(4 kernel launches each); wk on the card == the CPU's plain version")


# ---------------------------------------------------------------------------
# Phases 3 and 8: full-width serve (pallas W4A4; the paper's int-LUT mode)
# ---------------------------------------------------------------------------


def phase_serve(torch, dev, cfg, smi, *, phase, spec, kernel, max_prompt, max_new,
                calibrate=False, iters=(3, 10)):
    """Serve 8 requests through ``ServeEngine(batch=4, decode="scan")`` with
    every launch count set to 0 just before and read just after; then the
    steady-state prefill / decode-step times and the profiler's breakdown.
    ``calibrate`` freezes the activation scales on a 2 x 16 token batch from
    ``default_rng(0)`` before preparing (the int-LUT path)."""
    from repro_torch.models.model import build_model
    from repro_torch.serve.serving import Request, ServeEngine
    from repro_torch.tune.plan import quantized_leaf_items
    import numpy as np

    if cfg.n_layers != N_LAYERS:
        log(f"phase {phase}: depth cut from {cfg.n_layers} to {N_LAYERS} layers")
        cfg = dataclasses.replace(cfg, n_layers=N_LAYERS)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_quantized(spec, seed=0, device=dev)
    what = f"W{spec.bw}A{spec.ba}{f' p={spec.p}' if spec.p else ''} {spec.mode}"
    if calibrate:
        cal = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        params = model.prepare(params, calibrate=cal, n_hint=4)
        leaves = quantized_leaf_items(params)
        check(len(leaves) == 7 and all(lf.ascale is not None and lf.ascale.shape == (N_LAYERS,)
                                       and lf.wpk is not None for _p, lf in leaves),
              f"lut tree: every projection needs a frozen [{N_LAYERS}] ascale and wpk")
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
        f"{torch.cuda.memory_allocated(dev)/1e9:.2f} GB on the card")
    eng = ServeEngine(model, params, batch=4, max_seq=256, decode="scan", device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, max_prompt + 1, 8)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=max_new) for n in lens]
    eng.generate([Request(prompt=reqs[0].prompt[:16], max_new_tokens=2)])   # warmup
    torch.cuda.synchronize()

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
    launches = counts[kernel]
    sync_warnings = [str(w.message) for w in caught
                     if "called a synchronizing CUDA operation" in str(w.message)]

    check(all(len(o) == max_new for o in outs),
          f"token counts {[len(o) for o in outs]} != {max_new} each")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o), "token outside [0, vocab)")
    check(eng.host_syncs == len(records),
          f"host_syncs {eng.host_syncs} != waves {len(records)}")
    prefills = sum(1 for r in records if r.admitted)
    steps = sum(r.steps for r in records)
    want = 7 * cfg.n_layers * (prefills + steps)
    check(launches == want, f"{kernel} launches {launches} != 7 x {cfg.n_layers} x "
                            f"({prefills} prefills + {steps} decode steps) = {want}")
    check(all(n == 0 for name, n in counts.items() if name != kernel),
          f"the {spec.mode} path launched another kernel: {counts}")
    check(len(sync_warnings) == eng.host_syncs,
          f"{len(sync_warnings)} synchronizing calls in the serve loop, expected only the "
          f"{eng.host_syncs} token fetches: {sorted(set(sync_warnings))[:3]}")
    n_tok = sum(len(o) for o in outs)
    log(f"phase {phase} [{smi}]: served {len(reqs)} requests (prompt lengths {lens.tolist()}), "
        f"{n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s end to end, prefill "
        f"included); {len(records)} waves, {prefills} prefills, {steps} decode steps, "
        f"{eng.host_syncs} host syncs, {launches} {kernel} launches "
        f"(= 7 x {cfg.n_layers} x {prefills + steps}); sync-debug warnings "
        f"{len(sync_warnings)} (all token fetches); admissions {eng.admissions}")

    # Steady-state times, outside the counted run.
    caches = eng._new_cache()
    toks = torch.randint(0, cfg.vocab_size, (4, 128), device=dev, dtype=torch.int32)
    pad = torch.zeros((4,), dtype=torch.int32, device=dev)
    prefill_ms = time_ms(torch, lambda i: model.prefill(params, toks, caches, pad_len=pad),
                         iters[0])
    tok = toks[:, -1:]
    pos = torch.full((4,), 128, dtype=torch.int32, device=dev)
    step_ms = time_ms(torch, lambda i: model.decode_step(params, tok, caches, pos, pad_len=pad),
                      iters[1])
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"phase {phase} [{smi}]: prefill B=4 x 128 tokens {prefill_ms:.2f} ms; decode step "
        f"B=4 {step_ms:.2f} ms ({4e3 / step_ms:.1f} tok/s); peak memory {peak/1e9:.2f} GB")
    log(f"phase {phase}: where the device time goes (torch.profiler; wall time from the "
        "unprofiled runs above):")
    log_breakdown("prefill B=4 x 128", device_time_by_kernel(
        torch, lambda: model.prefill(params, toks, caches, pad_len=pad), max(1, iters[0] - 1)),
        prefill_ms, kernel=kernel, card=smi)
    log_breakdown("decode step B=4", device_time_by_kernel(
        torch, lambda: model.decode_step(params, tok, caches, pos, pad_len=pad), iters[1] // 2),
        step_ms, kernel=kernel, card=smi)
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
    from repro_torch.core import LutLinearSpec
    from repro_torch.kernels import build

    t_all = time.perf_counter()
    try:
        # One nvcc per source, all started together.
        with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
            for lib in pool.map(build.load, KERNELS):
                check(lib is not None, "kernel library did not load")
        for name in KERNELS:
            info = build.build_info[name]
            regs = sorted({ln.split("info    : ")[-1] for ln in info["log"].splitlines()
                           if "registers" in ln})
            log(f"phase 1: built {name}.cu in {info['seconds']:.1f} s "
                f"(nvcc, sm_90a): {'; '.join(regs)}")
        cfg = get_config("stablelm-12b")
        phase_stream_kernel(torch, dev)
        srows, stream_abs = phase_stream_times(torch, dev, cfg, hw.H100_SXM, smi)
        phase_lut_layer(torch, dev, cfg)
        lserve = phase_serve(torch, dev, cfg, smi, phase=8,
                             spec=LutLinearSpec(mode="lut", **LUT_SPEC),
                             kernel="lut_stream_gemm", max_prompt=64, max_new=16,
                             calibrate=True, iters=(2, 5))
        worst_rel, worst_abs = phase_kernel(torch, dev)
        rows, rel2, abs2 = phase_kernel_times(torch, dev, cfg, hw.H100_SXM)
        worst_rel, worst_abs = max(worst_rel, rel2), max(worst_abs, abs2)
        serve = phase_serve(torch, dev, cfg, smi, phase=3,
                            spec=LutLinearSpec(bw=4, ba=4, mode="pallas"),
                            kernel="lut_dequant_gemm", max_prompt=96, max_new=32)
        cpu_rel, lut_cpu_rel = phase_cpu_and_loop(torch, dev, cfg)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")

    def layer_sum(rs, b, key):
        return sum(r[key] for r in rs if r["B"] == b)

    def bound_by(rs, b):
        return "bytes" if all(r["bound_by"] == "bytes" for r in rs if r["B"] == b) else \
            "operations" if all(r["bound_by"] == "operations" for r in rs if r["B"] == b) else "mixed"

    def times(rs, b, at):
        return {"at": at, "ms": layer_sum(rs, b, "ms"), "plain_ms": layer_sum(rs, b, "plain_ms"),
                "bound_ms": layer_sum(rs, b, "bound_ms"), "bound_by": bound_by(rs, b),
                "library_ms": layer_sum(rs, b, "library_ms")}

    kernels = {"kernels": [{
        "name": "lut_dequant_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lut_dequant_gemm.cu",
        "replaces": "src/repro/kernels/lut_dequant_gemm.py:79",
        "tpu": "src/repro/kernels/lut_dequant_gemm.py::lut_dequant_gemm",
        "launches": serve["launches"],
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        **times(rows, 4, "one decode step of one stablelm-12b layer: its 7 projections at "
                         "B=4, W4, bf16 x"),
        "prefill": times(rows, 512, "one layer's 7 projections at B=4x128, W4, bf16 x"),
        "card_vs_cpu_rel_err": cpu_rel,
        "ok": True,
    }, {
        "name": "lut_stream_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lut_stream_gemm.cu",
        "replaces": "src/repro/kernels/lut_stream_gemm.py:96",
        "tpu": "src/repro/kernels/lut_stream_gemm.py::lut_stream_gemm",
        "launches": lserve["launches"],
        "max_abs_err": stream_abs,
        **times(srows, 4, "one decode step of one stablelm-12b layer: its 7 projections at "
                          "N=4, W1A3 p=4 (library: the one-hot [M, G*R] f32 torch.matmul)"),
        "prefill": times(srows, 512, "one layer's 7 projections at N=4x128, W1A3 p=4"),
        "card_vs_cpu_rel_err": lut_cpu_rel,
        "ok": True,
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
