"""repro_torch.tune: the capacity-budgeted autotuner compiling whole-model LUT
plans (port of ``repro.tune``).

The paper's capacity-computation tradeoff (spend LUT bytes to buy lookups,
Eq. 2-6) restated at model scale: an offline planner allocates one global
LUT-capacity budget across every quantized layer instead of one static
``LutLinearSpec`` for all.

* :mod:`repro_torch.tune.plan`    — versioned, JSON-serializable
                                    LayerPlan/ModelPlan keyed by a
                                    parameter-tree shape fingerprint (the
                                    reference's JSON and hash)
* :mod:`repro_torch.tune.space`   — per-layer candidate enumeration with
                                    exact capacity accounting
* :mod:`repro_torch.tune.measure` — measurement correcting the analytic
                                    estimates (CUDA events on the card;
                                    cached, median-of-k)
* :mod:`repro_torch.tune.planner` — greedy marginal-speedup-per-byte
                                    knapsack under a global budget, plan
                                    apply and capacity check

Entry points: ``plan_model`` -> ``ModelPlan`` -> ``Model.prepare(params,
plan=...)`` / ``ServeEngine(..., plan=...)``; CLI ``python -m
repro_torch.launch.tune``.
"""

from repro_torch.tune.measure import Measurer  # noqa: F401
from repro_torch.tune.plan import (  # noqa: F401
    LayerPlan,
    ModelPlan,
    describe_drift,
    leaf_identities,
    param_fingerprint,
)
from repro_torch.tune.planner import apply_plan, plan_model, verify_capacity  # noqa: F401
from repro_torch.tune.space import Candidate, layer_candidates  # noqa: F401
