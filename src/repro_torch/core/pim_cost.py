"""UPMEM cycle cost models for LoCaLUT and every baseline in the paper.

Copy of ``repro.core.pim_cost`` (pure Python): it turns the streamed
engine's :class:`repro_torch.core.engine.StreamStats` and GEMM shapes into
UPMEM time.

The container has no UPMEM hardware, so the paper's *measured* speedup tables
(Figs. 3, 9–13, 16, 18, 19) are reproduced through a first-order cycle model
of the DPU, anchored on the two constants the paper itself profiles and
publishes in §VI-I:

* ``L_D    = 1.36e-9 s``  — stream one canonical+reordering LUT entry pair
                            from the DRAM bank to the local buffer
                            (0.5 B/cycle @ 350 MHz, 3-stage pipelined),
* ``L_local = 3.27e-8 s`` — one canonical lookup + one reordering lookup +
                            accumulate (12 instructions).

Everything else (MAC instruction count on the in-order core, LTC runtime
table construction, OP+LC software reordering) is modeled with explicit
instruction counts recorded in :data:`repro_torch.hw.UPMEM` and documented per
method below.  EXPERIMENTS.md reports model-vs-paper deltas.

All functions return **seconds for the whole GEMM across the full PIM
system** (work divided over ``dev.n_banks`` banks, matching the paper's
data/context-parallel bank split, §V-B).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

from repro_torch import hw
from repro_torch.core import luts, perfmodel
from repro_torch.core.quantize import QuantSpec


@dataclasses.dataclass(frozen=True)
class GemmShape:
    m: int
    k: int
    n: int


def _pow2_leq(x: int) -> int:
    return 1 << max(x.bit_length() - 1, 0)


def bank_tile(s: GemmShape, dev: hw.PimDevice) -> GemmShape:
    """Map the global GEMM onto the bank grid; return one bank's tile.

    The paper splits the workload over the 2048 banks with data/context
    parallelism (§V-B): activations (N) are partitioned first, then weight
    rows (M); K stays whole so each bank produces complete partial outputs
    (inter-bank reduction would have to travel through the host, §VII-B).
    We split N over the largest power of two <= N and M over the remaining
    banks — this reproduces the per-bank M values the paper sweeps in
    Fig. 12 (M_bank = M/16 at N=128) and the Fig. 18 p* selections.
    """
    nb_n = min(_pow2_leq(max(s.n, 1)), dev.n_banks)
    nb_m = max(dev.n_banks // nb_n, 1)
    return GemmShape(
        m=math.ceil(s.m / nb_m), k=s.k, n=math.ceil(s.n / nb_n)
    )


def naive_pim_time(s: GemmShape, bw: int, ba: int, dev: hw.PimDevice = hw.UPMEM) -> float:
    """Scalar MAC loop on the in-order core using the native int8 multiplier.

    ``mac_insts`` covers load-w, load-a, multiply, accumulate and amortized
    loop/address updates.  Multi-byte precisions (>8b operands) would need
    software multiplies; all paper settings fit int8 operands.
    """
    t = bank_tile(s, dev)
    return t.m * t.k * t.n * dev.mac_insts * dev.cycle


def ltc_time(s: GemmShape, bw: int, ba: int, dev: hw.PimDevice = hw.UPMEM) -> float:
    """LUT Tensor Core adapted to the DPU (paper §VI-A baselines).

    Bit-serial weights: ``bw`` 1-bit planes; per plane one lookup covers a
    group of ``g=4`` activations.  The LUT is built *at runtime* from each
    activation group (2^g partial sums; table mirroring halves the build to
    2^(g-1) adds — §VIII, "compresses the LUT by half").  Shift-accumulate
    across weight bit planes rides in the lookup instruction count.
    """
    t = bank_tile(s, dev)
    g = 4
    groups = math.ceil(t.k / g)
    build = groups * t.n * (2 ** (g - 1)) * dev.mac_insts
    lookups = t.m * groups * t.n * bw * dev.ltc_lookup_insts
    return (build + lookups) * dev.cycle


def op_lut_time(s: GemmShape, bw: int, ba: int, dev: hw.PimDevice = hw.UPMEM) -> float:
    """Operation-packed LUT sized for the local buffer (design point OP)."""
    t = bank_tile(s, dev)
    p = max(luts.max_p_packed(bw, ba, dev.buffer_lut_budget), 1)
    lookups = t.m * math.ceil(t.k / p) * t.n
    return lookups * dev.op_lookup_insts * dev.cycle


def op_lc_time(s: GemmShape, bw: int, ba: int, dev: hw.PimDevice = hw.UPMEM) -> float:
    """OP + LUT canonicalization, *software* weight reordering (OP+LC).

    Larger p fits thanks to canonicalization, but every (weight-vector,
    activation-vector) pair pays unpack→permute→repack on the core
    (paper §VI-B: "performance drops significantly from the added ordering
    overhead").
    """
    t = bank_tile(s, dev)
    p = max(luts.max_p_canonical(bw, ba, dev.buffer_lut_budget), 1)
    pairs = t.m * math.ceil(t.k / p) * t.n
    reorder = pairs * dev.reorder_insts_per_elem * p
    lookups = pairs * dev.op_lookup_insts
    return (reorder + lookups) * dev.cycle


def op_lc_rc_time(s: GemmShape, bw: int, ba: int, dev: hw.PimDevice = hw.UPMEM) -> float:
    """OP + canonicalization + reordering LUT, buffer-resident (OP+LC+RC)."""
    t = bank_tile(s, dev)
    p_local = max(luts.max_p_canonical(bw, ba, dev.buffer_lut_budget), 1)
    return perfmodel.eq4_time(t.m, t.k, t.n, p_local, dev)


def localut_time(s: GemmShape, bw: int, ba: int, dev: hw.PimDevice = hw.UPMEM) -> float:
    """Full LoCaLUT: perf-model-selected p*, slice streaming when it wins."""
    t = bank_tile(s, dev)
    plan = perfmodel.make_plan(
        perfmodel.PlanInputs(m=t.m, k=t.k, n=t.n, bw=bw, ba=ba, device=dev)
    )
    return plan.t_predicted


def localut_plan(s: GemmShape, bw: int, ba: int, dev: hw.PimDevice = hw.UPMEM):
    t = bank_tile(s, dev)
    return perfmodel.make_plan(
        perfmodel.PlanInputs(m=t.m, k=t.k, n=t.n, bw=bw, ba=ba, device=dev)
    )


def localut_time_at_p(
    s: GemmShape, bw: int, ba: int, p: int, dev: hw.PimDevice = hw.UPMEM
) -> float:
    """LoCaLUT pinned at a given p (for the Fig. 12/18 sensitivity sweeps)."""
    t = bank_tile(s, dev)
    p_local = max(luts.max_p_canonical(bw, ba, dev.buffer_lut_budget), 1)
    if p <= p_local:
        return perfmodel.eq4_time(t.m, t.k, t.n, p, dev)
    return perfmodel.eq2_time(t.m, t.k, t.n, p, bw, dev)


def dram_bank_lut_time(
    s: GemmShape, bw: int, ba: int, p: int, dev: hw.PimDevice = hw.UPMEM
) -> float:
    """Fig. 3(a) candidate: every lookup served straight from the DRAM bank.

    Per-lookup cost = one bank access of ``bo`` bytes at 0.5 B/cycle plus the
    amortized activation overhead — far above the single-cycle buffer access.
    """
    t = bank_tile(s, dev)
    bo = luts.auto_bo(bw, ba, p, QuantSpec(bw).grid(), QuantSpec(ba).grid())
    access_cycles = bo / dev.dram_bytes_per_cycle + 8  # row-activation amortized
    lookups = t.m * math.ceil(t.k / p) * t.n
    return lookups * (access_cycles + dev.op_lookup_insts) * dev.cycle


def buffer_lut_time(
    s: GemmShape, bw: int, ba: int, p: int, dev: hw.PimDevice = hw.UPMEM
) -> float:
    """Fig. 3(b) candidate: packed LUT resident in the local buffer."""
    t = bank_tile(s, dev)
    lookups = t.m * math.ceil(t.k / p) * t.n
    return lookups * dev.op_lookup_insts * dev.cycle


METHODS: dict[str, Callable[..., float]] = {
    "naive_pim": naive_pim_time,
    "ltc": ltc_time,
    "op": op_lut_time,
    "op_lc": op_lc_time,
    "op_lc_rc": op_lc_rc_time,
    "localut": localut_time,
}


# ---------------------------------------------------------------------------
# End-to-end model time (paper Fig. 10): sum of GEMM times over a transformer
# layer's projections plus a host-side overhead term for quant/softmax/norm.
# ---------------------------------------------------------------------------


def transformer_layer_gemms(d_model: int, d_ff: int, seq: int) -> list[GemmShape]:
    """QKV, output projection and the two FFN GEMMs (paper §V-B / Fig. 8)."""
    return [
        GemmShape(3 * d_model, d_model, seq),  # fused QKV
        GemmShape(d_model, d_model, seq),      # output proj
        GemmShape(d_ff, d_model, seq),         # FFN up
        GemmShape(d_model, d_ff, seq),         # FFN down
    ]


def model_time(
    method: str,
    layers: int,
    d_model: int,
    d_ff: int,
    seq: int,
    bw: int,
    ba: int,
    dev: hw.PimDevice = hw.UPMEM,
    host_overhead_frac: float = 0.25,
) -> float:
    """End-to-end inference time under a cost model.

    ``host_overhead_frac`` models the host-resident fp32 ops (softmax, norm,
    GELU, quant/dequant) as a fraction of the *naive* GEMM time — identical
    across methods, as the paper's host work does not depend on the PIM-side
    LUT design (§V-B, Fig. 16(a)).
    """
    fn = METHODS[method]
    gemm_t = sum(fn(s, bw, ba, dev) for s in transformer_layer_gemms(d_model, d_ff, seq))
    host_t = host_overhead_frac * sum(
        naive_pim_time(s, bw, ba, dev) for s in transformer_layer_gemms(d_model, d_ff, seq)
    )
    return layers * (gemm_t + host_t)
