"""Packing ``p`` b-bit codes into one integer index, and bit-packing weight
codes into dense uint8 words (port of ``repro.core.packing``).

Conventions (shared with the reference):

* A *packed index* of a length-``p`` code vector ``c`` is
  ``sum_j c[j] << (bits * j)`` — element 0 occupies the least-significant
  bits.
* Bit-packed *storage* (``pack_bits``/``unpack_bits``) is little-endian
  within each uint8 byte: code 0 of a byte sits in bits [0, bw).
"""

from __future__ import annotations

import numpy as np
import torch


def pack_index(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """[..., p] int codes -> [...] packed integer index (int32)."""
    p = codes.shape[-1]
    if bits * p > 31:
        raise ValueError(f"packed index needs {bits*p} bits; int32 limit exceeded")
    shifts = torch.arange(p, dtype=torch.int32, device=codes.device) * bits
    return (codes.to(torch.int32) << shifts).sum(dim=-1, dtype=torch.int32)


def pack_index_np(codes: np.ndarray, bits: int) -> np.ndarray:
    """[..., p] int codes -> [...] packed integer index (int64)."""
    codes = np.asarray(codes)
    p = codes.shape[-1]
    out = codes[..., 0].astype(np.int64)
    for j in range(1, p):
        out |= codes[..., j].astype(np.int64) << (bits * j)
    return out


def unpack_index_np(idx: np.ndarray, bits: int, p: int) -> np.ndarray:
    shifts = np.arange(p, dtype=np.int64) * bits
    mask = (1 << bits) - 1
    return ((np.asarray(idx, dtype=np.int64)[..., None] >> shifts) & mask).astype(
        np.int32
    )


def all_code_vectors(bits: int, p: int) -> np.ndarray:
    """[2^(bits*p), p] — the code vector of every packed index (row i = unpack(i))."""
    n = 1 << (bits * p)
    return unpack_index_np(np.arange(n), bits, p)


# ---------------------------------------------------------------------------
# Dense bit-packed storage for quantized weights.
# ---------------------------------------------------------------------------


def codes_per_byte(bits: int) -> int:
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"bit-packed storage supports bw in (1,2,4,8), got {bits}")
    return 8 // bits


def pack_bits(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """[..., K] int codes (< 2^bits) -> [..., K*bits/8] uint8 storage."""
    cpb = codes_per_byte(bits)
    k = codes.shape[-1]
    if k % cpb:
        raise ValueError(f"last dim {k} not a multiple of {cpb}")
    grouped = codes.reshape(codes.shape[:-1] + (k // cpb, cpb)).to(torch.int32)
    shifts = torch.arange(cpb, dtype=torch.int32, device=codes.device) * bits
    # Codes occupy disjoint bit ranges, so sum == bitwise-or.
    return (grouped << shifts).sum(dim=-1, dtype=torch.int32).to(torch.uint8)


def unpack_bits(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """[..., B] uint8 -> [..., B*8/bits] int32 codes."""
    cpb = codes_per_byte(bits)
    shifts = torch.arange(cpb, dtype=torch.int32, device=packed.device) * bits
    mask = (1 << bits) - 1
    out = (packed[..., None].to(torch.int32) >> shifts) & mask
    return out.reshape(packed.shape[:-1] + (packed.shape[-1] * cpb,))
