"""First-order performance model (paper §IV-D, Eq. 2–6).

Copy of ``repro.core.perfmodel``.

Selects the optimal packing degree ``p*`` and decides between a
buffer-resident canonical LUT and LUT slice streaming, from the matrix shape
(M, K, N), the bitwidths, and the profiled constants ``L_D`` / ``L_local``.
Mirrors the paper's auto-selection performed on the host at initialization
(§V-A): "we simply test all p <= p_DRAM values on Eq. (2) and Eq. (6)".
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch import hw
from repro_torch.core import luts
from repro_torch.core.quantize import QuantSpec


@dataclasses.dataclass(frozen=True)
class PlanInputs:
    m: int
    k: int
    n: int
    bw: int
    ba: int
    device: hw.PimDevice = hw.UPMEM


@dataclasses.dataclass(frozen=True)
class Plan:
    p_star: int
    use_streaming: bool
    p_local: int
    p_dram: int
    t_predicted: float     # seconds, Eq. 2 (or Eq. 4 if buffer-resident)
    t_local: float         # Eq. 4 at p_local
    lut_bytes: int


def eq2_time(m: int, k: int, n: int, p: int, bw: int, dev: hw.PimDevice) -> float:
    """Paper Eq. 2: T = 2^(bw p) * (KN/p) * L_D + (MKN/p) * L_local."""
    return (2 ** (bw * p)) * (k * n / p) * dev.l_d + (m * k * n / p) * dev.l_local


def eq4_time(m: int, k: int, n: int, p_local: int, dev: hw.PimDevice) -> float:
    """Paper Eq. 4: buffer-resident canonical LUT, no streaming term."""
    return (m * k * n / p_local) * dev.l_local


def capacity_limits(bw: int, ba: int, dev: hw.PimDevice) -> tuple[int, int]:
    """(p_local, p_dram): largest canonical+reordering packs fitting the
    buffer / the DRAM bank LUT budgets (paper §V-A)."""
    p_local = luts.max_p_canonical(bw, ba, dev.buffer_lut_budget)
    p_dram = luts.max_p_canonical(bw, ba, dev.bank_lut_budget)
    return max(p_local, 1), max(p_dram, 1)


def make_plan(inp: PlanInputs) -> Plan:
    """Test all p <= p_dram on Eq. 2 / Eq. 4 and pick the faster design."""
    dev = inp.device
    p_local, p_dram = capacity_limits(inp.bw, inp.ba, dev)
    t_local = eq4_time(inp.m, inp.k, inp.n, p_local, dev)

    best_p, best_t = p_local, t_local
    use_streaming = False
    for p in range(1, p_dram + 1):
        t = eq2_time(inp.m, inp.k, inp.n, p, inp.bw, dev)
        if p <= p_local:
            # A buffer-resident LUT at this p has no streaming term.
            t = min(t, eq4_time(inp.m, inp.k, inp.n, p, dev))
        if t < best_t:
            best_t, best_p = t, p
            use_streaming = p > p_local
    bo = luts.auto_bo(
        inp.bw, inp.ba, best_p, QuantSpec(inp.bw).grid(), QuantSpec(inp.ba).grid()
    )
    lut_bytes = luts.canonical_lut_bytes(
        inp.bw, inp.ba, best_p, bo
    ) + luts.reordering_lut_bytes(inp.bw, best_p)
    return Plan(
        p_star=best_p,
        use_streaming=use_streaming,
        p_local=p_local,
        p_dram=p_dram,
        t_predicted=best_t,
        t_local=t_local,
        lut_bytes=lut_bytes,
    )


def eq6_break_even_m(
    p_star: int, p_local: int, bw: int, dev: hw.PimDevice
) -> Optional[float]:
    """Paper Eq. 6: streaming beats buffer-resident when M exceeds this.

    Returns None when p* == p_local (no streaming gain possible).
    """
    if p_star <= p_local:
        return None
    return (
        (2 ** (bw * p_star))
        * (dev.l_d / dev.l_local)
        * (p_local / (p_star - p_local))
    )
