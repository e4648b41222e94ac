"""Per-layer LUT plans (port of ``repro.tune``, in part).

Only the tree walkers of :mod:`repro_torch.tune.plan` are ported so far
(calibration needs them); the planner and ``ModelPlan`` follow with the tune
slice (ROADMAP Queue 1 item 7).
"""
