"""LoCaLUT core, ported to PyTorch (counterpart of ``repro.core``).

* :mod:`repro_torch.core.quantize`  — low-bit quantization + value grids
* :mod:`repro_torch.core.packing`   — code packing / bit-packed weight storage
* :mod:`repro_torch.core.multiset`  — canonicalization math (numpy + torch)
* :mod:`repro_torch.core.luts`      — packed / canonical / reordering LUT builders
* :mod:`repro_torch.core.engine`    — exact LUT GEMM engines (packed,
  canonical, streamed); on the card their int32 sums come from the
  ``lut_stream_gemm`` kernel
* :mod:`repro_torch.core.stream_plan` — tiled, deduplicated slice planner
* :mod:`repro_torch.core.perfmodel` — paper Eq. 2–6 p* auto-selection
* :mod:`repro_torch.core.pim_cost`  — UPMEM cycle cost models
* :mod:`repro_torch.core.api`       — QuantizedLinear / apply_linear (4 modes)
* :mod:`repro_torch.core.prepared`  — weight-stationary prepare/apply split
* :mod:`repro_torch.core.calibrate` — frozen activation scales
"""

from repro_torch.core.api import (  # noqa: F401
    LutLinearSpec,
    QuantizedLinear,
    apply_linear,
    dequantize_weights,
    prepare_linear,
    quantize_linear,
)
from repro_torch.core.luts import LutPack, build_lut_pack  # noqa: F401
from repro_torch.core.perfmodel import Plan, PlanInputs, make_plan  # noqa: F401
from repro_torch.core.prepared import PreparedLinear  # noqa: F401
