"""Distribution layer (port of ``repro.dist``): sharding specs, compressed
collectives, pipeline stages, and the sharded forward's rules.

* :mod:`repro_torch.dist.sharding`    — :class:`ShardCtx` and the
  :class:`PSpec` derivation for every model family, LoCaLUT-quantized trees
  included (packed code arrays shard along the output dim; the LUT tables
  are tiny, static and replicated), :func:`shard_tree` (one rank's shard).
* :mod:`repro_torch.dist.collectives` — int8-compressed all-reduce.
* :mod:`repro_torch.dist.pipeline`    — a GPipe schedule over a ``stage``
  mesh axis with ring rotation.
* :mod:`repro_torch.dist.runtime`     — the collectives the model inserts
  around the local shards under a ``ctx``.
"""

from repro_torch.dist.sharding import (  # noqa: F401
    AxisMesh,
    PSpec,
    ShardCtx,
    cache_specs,
    param_specs,
    shard_tree,
    to_shardings,
)
from repro_torch.dist.collectives import compressed_psum  # noqa: F401
from repro_torch.dist.pipeline import pipeline_apply  # noqa: F401
