"""Autotuned serving walkthrough through the PyTorch/CUDA port
(``repro_torch``), the steps of examples/autotune_serve.py: compile a
capacity-budgeted plan, save it, reload it, serve through it — and watch the
degradation order as the budget tightens.

The paper picks one packing degree per GEMM (Eq. 2-6); ``repro_torch.tune``
restates the tradeoff at model scale: every quantized layer competes for one
global LUT-capacity budget, and the planner spends bytes where the marginal
speedup per byte is highest.

Run:  PYTHONPATH=src python examples/autotune_serve_torch.py            # the card
      PYTHONPATH=src python examples/autotune_serve_torch.py --device cpu
"""

import argparse
import dataclasses
import pathlib
import tempfile

import numpy as np

from repro_torch import devices
from repro_torch.configs import get_config
from repro_torch.core import LutLinearSpec
from repro_torch.models.model import build_model
from repro_torch.serve.serving import Request, ServeEngine
from repro_torch.tune import ModelPlan, plan_model, verify_capacity

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = devices.resolve(ap.parse_args().device)

# --- a small LUT-served decoder -------------------------------------------
cfg = dataclasses.replace(
    get_config("stablelm-12b", smoke=True), name="autotune-demo",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=128,
)
model = build_model(cfg)
params = model.init(0, device=dev)
# A hand-picked whole-model spec: what you write without the planner.
qparams = model.quantize(params, LutLinearSpec(bw=1, ba=3, p=2, mode="lut"))

# --- compile plans at two budgets -----------------------------------------
# measure=False uses the analytic Eq. 2/4 cost model only; pass measure=True
# (the default) to correct it with measurements on the leaves' device.
loose = plan_model(qparams, lut_budget_bytes=4 << 20, n_hint=2, measure=False)
tight = plan_model(qparams, lut_budget_bytes=2 << 10, n_hint=2, measure=False)

for name, plan in [("loose (4 MiB)", loose), ("tight (2 KiB)", tight)]:
    print(f"\n=== {name}: spent {plan.total_bytes:,} B "
          f"of {plan.budget_bytes:,} B ===")
    for path, lp in sorted(plan.layers.items()):
        print(f"  {path:<35} {lp.mode} p={lp.p}"
              f"{' +wcanon' if lp.wcanon else ''}"
              f"{'' if lp.prepared else ' (raw: degraded)'}"
              f"  {lp.capacity_bytes:>8,} B")

# The tight budget walks the degradation order: wcanon dropped first, then
# lower p, finally raw (unprepared) serving at zero capacity.

# --- plans are artifacts: save, reload, fingerprint-checked ----------------
with tempfile.TemporaryDirectory() as td:
    path = pathlib.Path(td) / "plan.json"
    loose.save(path)
    plan = ModelPlan.load(path)
    print(f"\nreloaded plan: fingerprint {plan.fingerprint}, "
          f"{len(plan.layers)} layers")

    # --- serve through the plan (ServeEngine applies + verifies it) -------
    eng = ServeEngine(model, qparams, batch=2, max_seq=32, plan=plan, device=dev)
    verify_capacity(eng.params, plan)   # byte accounting is exact, not estimated
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=6) for n in (3, 5, 8)]
    outs = eng.generate(reqs)

    # Plans never change numerics: the fixed-spec model emits the same tokens.
    eng_fixed = ServeEngine(model, model.prepare(qparams), batch=2, max_seq=32, device=dev)
    assert outs == eng_fixed.generate(reqs)
    print(f"served {len(reqs)} requests through the plan; tokens identical "
          f"to the fixed spec: {outs}")
