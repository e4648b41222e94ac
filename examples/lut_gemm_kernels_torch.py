"""Demo: the port's Hopper kernels, each held against its plain version —
the steps of examples/lut_gemm_kernels.py on ``repro_torch``.

* ``lut_dequant_gemm`` — packed-code weights decoded in-kernel through the
  value LUT: bf16 x on an int grid takes the wgmma tensor-core route
  (``lut_dequant_gemm_sm90.cu``), f32 x the CUDA-core route
  (``lut_dequant_gemm.cu``); each within 1e-4 x max |y| of the plain f32
  version.
* ``lut_stream_gemm`` — the paper's canonical + reordering LUT GEMM, int32
  exact, on the route its LUT pack selects: the int8 tensor cores (R <= 32),
  the lookup route (32 < R <= 256) and the CUDA cores (other packs); each
  bit-equal to the plain version.

On the CPU the entry points run the plain versions (there is no kernel
there), and the demo says so.

Run:  PYTHONPATH=src python examples/lut_gemm_kernels_torch.py            # the card
      PYTHONPATH=src python examples/lut_gemm_kernels_torch.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch import devices
from repro_torch.core import api, engine, luts
from repro_torch.kernels import lut_dequant_gemm as dq_kernel
from repro_torch.kernels import lut_stream_gemm as stream_kernel
from repro_torch.kernels import ops, ref

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = devices.resolve(ap.parse_args().device)
card = dev.type == "cuda"
if not card:
    print("no card: the entry points run the kernels' plain versions")
rng = np.random.default_rng(0)

# --- packed-code GEMM on both routes ------------------------------------------
B, K, F, bw = 8, 256, 128, 2
w = torch.from_numpy(rng.normal(size=(K, F)).astype(np.float32)).to(dev)
x = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32)).to(dev)
spec = api.LutLinearSpec(bw=bw, ba=4)
q = api.quantize_linear(w, spec)
grid = spec.wspec().grid()
for xx in (x.to(torch.bfloat16), x):
    route = dq_kernel.route(xx.dtype, bw, grid, K)
    before = (dq_kernel.launches, dq_kernel.launches_tc)
    y = ops.lut_dequant_gemm(xx, q.codes, q.scale, bw=bw, k=q.k)
    y_ref = ref.lut_dequant_gemm_ref(xx.cpu().float(), q.codes.cpu(), q.scale.cpu(), bw=bw,
                                     k=q.k, grid=grid)
    err = float((y.cpu() - y_ref).abs().max())
    assert err <= 1e-4 * float(y_ref.abs().max()), err
    if card:
        assert (dq_kernel.launches - before[0], dq_kernel.launches_tc - before[1]) == \
            (1, int(route == "tc")), route
    print(f"lut_dequant_gemm [{B}x{K}x{F}] W{bw} {str(xx.dtype)[6:]} x, "
          f"{route + ' route' if card else 'plain version'}: max err vs plain = {err:.2e}")
print(f"  weight bytes: bf16 {K*F*2:,} -> packed {q.packed_bytes:,} "
      f"({K*F*2/q.packed_bytes:.0f}x less traffic)")

# --- the int32 LUT GEMM on the three routes ------------------------------------
M, K2, N = 32, 64, 8
for bw, ba, p in ((1, 3, 4), (1, 3, 7), (3, 3, 3)):
    pack = luts.build_lut_pack(bw, ba, p)
    route = stream_kernel.route(pack)
    wc = torch.from_numpy(rng.integers(0, 2**bw, (M, K2)).astype(np.int32)).to(dev)
    ac = torch.from_numpy(rng.integers(0, 2**ba, (K2, N)).astype(np.int32)).to(dev)
    before = (stream_kernel.launches, stream_kernel.launches_tc,
              stream_kernel.launches_lookup)
    out = ops.lut_stream_gemm_full(wc, ac, pack)
    want = engine.canonical_lut_gemm(wc.cpu(), ac.cpu(), pack)
    assert torch.equal(out.cpu(), want.to(torch.float32))
    if card:
        assert (stream_kernel.launches - before[0], stream_kernel.launches_tc - before[1],
                stream_kernel.launches_lookup - before[2]) == \
            (1, int(route == "tc"), int(route == "lookup")), route
    print(f"lut_stream_gemm [{M}x{K2}x{N}] W{bw}A{ba} p={p} (R={pack.n_rows}), "
          f"{route + ' route' if card else 'plain version'}: bit-exact "
          f"(canonical LUT {pack.canonical.shape}, reordering LUT {pack.reordering.shape})")
print("kernel demo OK")
