"""Serving runtime of the port: ``ServeEngine`` (continuous in-flight batching
and the per-token loop oracle) in :mod:`repro_torch.serve.serving`."""
