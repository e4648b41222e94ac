"""PyTorch/CUDA port of the LoCaLUT serving stack (``repro`` is the JAX reference).

The package mirrors ``repro``'s layout and public names so each module has an
obvious counterpart:

* :mod:`repro_torch.core`     — quantization, packing, LUT builders, the
                                perf model, ``QuantizedLinear`` /
                                ``PreparedLinear`` and ``apply_linear``
* :mod:`repro_torch.kernels`  — hand-written Hopper kernels (CUDA C++ under
                                ``kernels/csrc``) with their plain versions
* :mod:`repro_torch.models`   — the dense GQA decoder over stacked units
* :mod:`repro_torch.serve`    — the continuous-batching ``ServeEngine``
* :mod:`repro_torch.launch`   — the serve driver
* :mod:`repro_torch.convert`  — reference parameter trees -> torch trees

It imports ``torch`` and numpy only, never ``jax`` or ``repro``.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; asked for ``cuda``
on a machine without it, they raise.  Importing builds and loads nothing: a
kernel is compiled with ``nvcc`` the first time it is launched.
"""
