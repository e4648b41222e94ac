"""Hand-written Hopper kernels for LoCaLUT's compute hot-spots.

* :mod:`repro_torch.kernels.lut_dequant_gemm` — packed-code GEMM with
  in-kernel value-LUT decode (CUDA C++: ``csrc/lut_dequant_gemm_sm90.cu`` on
  the tensor cores for bf16 x on a grid exact in bf16,
  ``csrc/lut_dequant_gemm.cu`` on the CUDA cores otherwise); replaces the
  TPU kernel of the same name.
* :mod:`repro_torch.kernels.lut_stream_gemm` — canonical-LUT slice-streaming
  GEMM, int32 (CUDA C++: ``csrc/lut_stream_gemm_sm90.cu`` on the int8 tensor
  cores for packs with s8 entries and R <= 32, ``csrc/lut_stream_gemm.cu``
  on the CUDA cores otherwise); replaces the TPU kernel of the same name.
  In front of it ``csrc/lut_canon.cu`` canonicalizes the activation codes
  (and composes the tensor-core route's operand) in one launch.
* :mod:`repro_torch.kernels.flash_attention` — online-softmax attention
  with GQA, causal / sliding-window masks and a logit softcap (CUDA C++:
  ``csrc/flash_attention_sm90.cu`` on the tensor cores for bf16 at head dims
  64/128/256, ``csrc/flash_attention.cu`` on the CUDA cores otherwise);
  replaces the TPU kernel of the same name.
* :mod:`repro_torch.kernels.build` — ``nvcc`` build at first use + ``ctypes``.
* :mod:`repro_torch.kernels.ops` — entry points: kernel on a CUDA tensor,
  plain version on a CPU tensor.
* :mod:`repro_torch.kernels.ref` — the plain PyTorch versions.

Every TPU kernel of the reference has its counterpart here.
"""
