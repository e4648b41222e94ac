"""Hardware constants: the paper's PIM device and the port's GPU.

* ``UPMEM`` — the paper's evaluation platform (§V-A, §VI-I), copied from the
  reference.  The perf model (:mod:`repro_torch.core.perfmodel`) plans the
  packing degree ``p`` against it in every mode, so ``PreparedLinear.p``
  agrees with the reference.
* ``H100_SXM`` — the published peaks of the card the port runs on (NVIDIA's
  data sheet, SXM part, dense rates, at the full 700 W power limit), and the
  links of the 8-GPU HGX node it sits in.  Used only to compute a least
  possible time (a kernel's bound, the dry-run's roofline terms in
  :mod:`repro_torch.launch.roofline`); a card set below 700 W runs slower
  than these.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GpuCard:
    name: str
    hbm_bandwidth: float       # bytes/s
    peak_flops_bf16: float     # FLOP/s, tensor cores, dense
    peak_flops_f32: float      # FLOP/s, CUDA cores (no tensor cores)
    peak_ops_int8: float       # OP/s, tensor cores, dense (one MAC = 2 operations)
    nvlink_bandwidth: float    # bytes/s each way, one GPU to the others of its node
    network_bandwidth: float   # bytes/s each way, one GPU to other nodes
    gpus_per_node: int         # GPUs joined by NVLink


H100_SXM = GpuCard(
    name="h100-sxm",
    hbm_bandwidth=3.35e12,
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    peak_ops_int8=1979e12,
    # NVIDIA H100 Tensor Core GPU data sheet (SXM): NVLink 900 GB/s, both
    # directions together, so 450 GB/s each way.
    nvlink_bandwidth=450e9,
    # NVIDIA DGX H100 / HGX H100 8-GPU node: one ConnectX-7 port of 400 Gb/s
    # NDR InfiniBand per GPU, so 50 GB/s each way.
    network_bandwidth=50e9,
    gpus_per_node=8,
)


@dataclasses.dataclass(frozen=True)
class PimDevice:
    """UPMEM-like near-bank DRAM-PIM (paper §II-A, §V-A, §VI-I)."""

    name: str
    n_banks: int               # PIM processing elements (paper: 2048)
    bank_capacity: int         # bytes per DRAM bank (64 MB)
    buffer_capacity: int       # bytes per SRAM local buffer (64 KB)
    lut_budget_frac: float     # fraction of bank/buffer devoted to LUTs (~half, §V-A)
    freq_hz: float             # DPU clock (350 MHz)
    dram_bytes_per_cycle: float  # DRAM bank -> buffer streaming rate (0.5 B/cyc)
    l_d: float                 # s, stream one canonical+reordering LUT entry (§VI-I)
    l_local: float             # s, canonical+reordering lookup + accumulate (12 inst)
    lookup_insts: int          # instructions per canonical+reorder lookup+acc
    op_lookup_insts: int       # instructions per plain packed-LUT lookup+acc
    ltc_lookup_insts: int      # per bit-serial lookup incl. shift-accumulate (LTC)
    mac_insts: int             # instructions per scalar MAC on the in-order core
    reorder_insts_per_elem: int  # unpack+permute+repack cost per packed element (OP+LC)

    @property
    def cycle(self) -> float:
        return 1.0 / self.freq_hz

    @property
    def bank_lut_budget(self) -> int:
        return int(self.bank_capacity * self.lut_budget_frac)

    @property
    def buffer_lut_budget(self) -> int:
        return int(self.buffer_capacity * self.lut_budget_frac)


UPMEM = PimDevice(
    name="upmem",
    n_banks=2048,
    bank_capacity=64 * 1024**2,
    buffer_capacity=64 * 1024,
    lut_budget_frac=0.55,  # "approximately half" (§V-A); 0.55 reproduces
                           # p_local=5/p_dram=8 (W1A3) and p_local=2 (W4A4)
    freq_hz=350e6,
    dram_bytes_per_cycle=0.5,
    l_d=1.36e-9,      # paper §VI-I: 0.5 B/cycle @ 350 MHz, 3-stage pipelined access
    l_local=3.27e-8,  # paper §VI-I: 12 instructions for both lookups + accumulate
    lookup_insts=12,
    op_lookup_insts=8,
    ltc_lookup_insts=10,  # packed lookup + left-shift + accumulate per bit plane
    mac_insts=7,          # ld w, ld a, mul, add, addr/loop overhead (in-order DPU)
    reorder_insts_per_elem=4,
)
