"""End-to-end driver through the PyTorch/CUDA port (``repro_torch``): serve
a LoCaLUT-quantized LLM with batched requests, the steps of
examples/serve_quantized_llm.py.

Build a small GQA decoder, quantize every GEMM weight to packed W4A4 codes
with the LoCaLUT transform, then serve a batch of prompts through prefill +
greedy decode with a KV cache.

Run:  PYTHONPATH=src python examples/serve_quantized_llm_torch.py            # the card
      PYTHONPATH=src python examples/serve_quantized_llm_torch.py --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch import devices, tree
from repro_torch.configs import get_config
from repro_torch.core import LutLinearSpec
from repro_torch.models.model import build_model
from repro_torch.serve.serving import Request, ServeEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = devices.resolve(ap.parse_args().device)

cfg = get_config("stablelm-12b", smoke=True)
model = build_model(cfg)
params = model.init(0, device=dev)
dense_bytes = sum(x.numel() * x.element_size() for x in tree.tensors(params))

qparams = model.quantize(params, LutLinearSpec(bw=4, ba=4, mode="dequant"))
quant_bytes = sum(x.numel() * x.element_size() for x in tree.tensors(qparams))
print(f"params: dense {dense_bytes:,} B -> LoCaLUT-packed {quant_bytes:,} B "
      f"({dense_bytes/quant_bytes:.2f}x smaller)")

# Weight-stationary serving (§V-B): freeze every per-call weight product once;
# the decode loop then runs on the device as continuous in-flight batches — a
# freed KV slot is re-admitted mid-decode, and prompts are left-padded into
# power-of-two buckets behind a pad mask (padding never changes the tokens).
pparams = model.prepare(qparams)
eng = ServeEngine(model, pparams, batch=2, max_seq=48, device=dev)
rng = np.random.default_rng(0)
requests = [
    Request(prompt=rng.integers(0, cfg.vocab_size, 1 + i % 7).astype(np.int32),
            max_new_tokens=2 + 5 * (i % 2))   # ragged budgets: slots free early
    for i in range(6)
]
t0 = time.time()
outputs = eng.generate(requests)
dt = time.time() - t0
print(f"served {len(requests)} ragged requests in {dt:.2f}s on {dev.type}, "
      f"{eng.host_syncs} host syncs across {len(eng.admissions)} admissions")
print(f"in-flight admission order (request -> slot): {eng.admissions}")
for i, out in enumerate(outputs):
    print(f"  request {i} ({len(requests[i].prompt)} prompt tokens) -> {out}")
print("serve example OK")
