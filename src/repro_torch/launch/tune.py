"""Autotuner driver of the port: compile a capacity-budgeted whole-model LUT
plan.

Builds the chosen architecture (random weights from a seed, drawn and
quantized one unit at a time), runs the :mod:`repro_torch.tune` planner
under a global LUT-capacity budget, prints the per-layer choices and writes
the versioned plan JSON — the artifact ``repro_torch.launch.serve --plan``
and ``ServeEngine(plan=...)`` replay (and the reference's too: the JSON and
the fingerprint are the same).

Examples:
    # the GPU, full width, measured on the card
    PYTHONPATH=src python -m repro_torch.launch.tune --full --budget-mb 16384 --batch 4 --out plan.json
    # the CPU, smoke size, from the cost models alone
    PYTHONPATH=src python -m repro_torch.launch.tune --smoke --analytic --device cpu --out plan.json
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import LutLinearSpec
from repro_torch.models.model import build_model
from repro_torch.tune import plan_model


def build_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--bw", type=int, default=1)
    ap.add_argument("--ba", type=int, default=3)
    ap.add_argument("--mode", default="lut",
                    choices=["dequant", "lut", "stream", "pallas"],
                    help="base execution mode; the planner re-tunes within "
                         "the mode's numerics family")
    ap.add_argument("--budget-mb", type=float, default=4.0,
                    help="global LUT-capacity budget (prepared products + "
                         "shared tables), megabytes")
    ap.add_argument("--batch", type=int, default=2,
                    help="serve batch width candidates are priced at (n_hint)")
    ap.add_argument("--p-cap", type=int, default=None,
                    help="optional extra bound on the packing-degree sweep")
    ap.add_argument("--analytic", dest="measure", action="store_false",
                    help="skip measurements; plan from the cost models")
    ap.add_argument("--out", default="plan.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu: where "
                         "the weights live and candidates are measured")
    return ap.parse_args(argv)


def main(argv=None):
    args = build_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    spec = LutLinearSpec(bw=args.bw, ba=args.ba, mode=args.mode)
    qparams = model.init_quantized(spec, seed=0, device=args.device)

    budget = int(args.budget_mb * 1024 * 1024)
    t0 = time.time()
    plan = plan_model(
        qparams, lut_budget_bytes=budget, n_hint=args.batch,
        measure=args.measure, p_cap=args.p_cap,
    )
    dt = time.time() - t0
    print(f"planned {len(plan.layers)} layers in {dt:.1f}s "
          f"(measured={args.measure}, cache "
          f"{plan.meta['measure_cache_hits']}h/"
          f"{plan.meta['measure_cache_misses']}m)")
    print(f"budget {budget:,} B -> spent {plan.total_bytes:,} B "
          f"({plan.table_bytes:,} B shared tables)"
          + ("  [OVER BUDGET: degraded floor]" if plan.meta["over_budget"] else ""))
    for path, lp in sorted(plan.layers.items()):
        t = f"{lp.measured_us:.0f}us" if lp.measured_us else f"{lp.est_us:.1f}us*"
        print(f"  {path:<40} {lp.mode:>7} p={lp.p} "
              f"wcanon={int(lp.wcanon)} prepared={int(lp.prepared)} "
              f"x{lp.stack:<3} {lp.capacity_bytes:>10,} B  {t}")
    plan.save(args.out)
    print(f"wrote {args.out} (fingerprint {plan.fingerprint})")
    return plan


if __name__ == "__main__":
    main()
