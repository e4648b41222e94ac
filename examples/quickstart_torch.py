"""Quickstart through the PyTorch/CUDA port (``repro_torch``): the LoCaLUT
pipeline in ~60 lines, the steps of examples/quickstart.py.

1. Build the canonical + reordering LUTs for a W2A4 / p=3 configuration.
2. Run a bit-exact LUT-based GEMM and compare against the integer oracle.
3. Let the perf model pick p* and the execution strategy.
4. Quantize a linear layer and apply it through three execution paths.

Run:  PYTHONPATH=src python examples/quickstart_torch.py            # the card
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch import devices
from repro_torch.core import api, engine, luts, perfmodel

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = devices.resolve(ap.parse_args().device)

# --- 1. LUTs ---------------------------------------------------------------
bw, ba, p = 2, 4, 3
pack = luts.build_lut_pack(bw, ba, p)
print(f"W{bw}A{ba} p={p}:")
print(f"  canonical LUT: {pack.canonical.shape}  ({pack.canonical_bytes:,} B)")
print(f"  reordering LUT: {pack.reordering.shape} ({pack.reordering_bytes:,} B)")
print(f"  operation-packed LUT would be: "
      f"{luts.packed_lut_bytes(bw, ba, p, pack.bo):,} B "
      f"({luts.packed_lut_bytes(bw, ba, p, pack.bo)/pack.total_bytes:.1f}x larger)")

# --- 2. bit-exact LUT GEMM ---------------------------------------------------
rng = np.random.default_rng(0)
M, K, N = 16, 24, 8
wcodes = torch.from_numpy(rng.integers(0, 2**bw, (M, K)).astype(np.int32)).to(dev)
acodes = torch.from_numpy(rng.integers(0, 2**ba, (K, N)).astype(np.int32)).to(dev)
oracle = engine.quantized_matmul_ref(wcodes.cpu(), acodes.cpu(), pack.wgrid, pack.agrid)
lut_out = engine.canonical_lut_gemm(wcodes, acodes, pack).cpu()
streamed, stats = engine.streamed_lut_gemm(wcodes, acodes, pack, k_slices=2)
assert torch.equal(lut_out.to(oracle.dtype), oracle)
assert torch.equal(streamed.cpu().to(oracle.dtype), oracle)
print(f"\nLUT GEMM bit-exact vs oracle ({M}x{K}x{N}) on {dev.type}; slice streaming moved "
      f"{stats.streamed_bytes:,} LUT bytes ({stats.slices_streamed}/"
      f"{stats.flat_slices} slices after dedup), reuse={stats.slice_reuse:.0f}x")

# --- 3. the perf model picks p* and the execution strategy -------------------
plan = perfmodel.make_plan(perfmodel.PlanInputs(m=3072, k=768, n=128, bw=1, ba=3))
print(f"\nperf model (M=3072,K=768,N=128, W1A3): p*={plan.p_star} "
      f"streaming={plan.use_streaming} (p_local={plan.p_local}, p_dram={plan.p_dram})")

# --- 4. quantized linear, three execution paths ------------------------------
w = torch.from_numpy(rng.normal(size=(64, 48)).astype(np.float32)).to(dev)
x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32)).to(dev)
q = api.quantize_linear(w, api.LutLinearSpec(bw=2, ba=4, mode="dequant"))
y_dq = api.apply_linear(q, x)
y_lut = api.apply_linear(
    api.QuantizedLinear(codes=q.codes, scale=q.scale, bias=None,
                        spec=api.LutLinearSpec(bw=2, ba=4, mode="lut", p=3), k=q.k), x)
y_pl = api.apply_linear(
    api.QuantizedLinear(codes=q.codes, scale=q.scale, bias=None,
                        spec=api.LutLinearSpec(bw=2, ba=4, mode="pallas"), k=q.k), x)
print(f"\nquantized linear: dense bytes {w.numel()*4:,} -> packed {q.packed_bytes:,}")
print(f"  |dequant - pallas| = {float((y_dq - y_pl).abs().max()):.2e} (same numerics)")
print(f"  |dequant - lut|    = {float((y_dq - y_lut).abs().max()):.2e} "
      f"(activation-quantization noise)")
print("\nquickstart OK")
