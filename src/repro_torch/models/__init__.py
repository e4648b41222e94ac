"""Model substrate of the port: the dense GQA decoder (counterpart of
``repro.models``).

Models are functional: ``init_params(cfg, gen) -> params`` (nested dict tree,
per-segment stacked units) and plain apply functions over tensors.  Linear
layers are dense dicts or :class:`repro_torch.core.QuantizedLinear` /
``PreparedLinear`` leaves.
"""
