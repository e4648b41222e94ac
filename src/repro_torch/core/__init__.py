"""LoCaLUT core, ported to PyTorch (counterpart of ``repro.core``).

* :mod:`repro_torch.core.quantize`  — low-bit quantization + value grids
* :mod:`repro_torch.core.packing`   — code packing / bit-packed weight storage
* :mod:`repro_torch.core.multiset`  — canonicalization math (numpy half)
* :mod:`repro_torch.core.luts`      — packed / canonical / reordering LUT builders
* :mod:`repro_torch.core.perfmodel` — paper Eq. 2–6 p* auto-selection
* :mod:`repro_torch.core.api`       — QuantizedLinear / apply_linear
* :mod:`repro_torch.core.prepared`  — weight-stationary prepare/apply split

Not yet ported: ``engine``, ``stream_plan``, ``pim_cost``, ``calibrate``
(ROADMAP Queue 1 items 2-4).
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
