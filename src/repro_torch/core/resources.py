"""Resource types of the paper's fleet (HeterPS §3, §6; the part of
``repro.core.resources`` the parameter-server telemetry needs).

A :class:`ResourceType` is one *kind* of computing resource the scheduler
may place a layer on: one CPU core or one V100 card, priced per hour as
in the paper (0.04 USD/core-hr CPU, 2.42 USD/hr V100).  The PS telemetry
re-anchors a type's bandwidth terms to measured traffic
(``repro_torch.ps.telemetry.PSTelemetry.to_resource``).
"""

from __future__ import annotations

import dataclasses

GB = 1024**3
TFLOPS = 1e12


@dataclasses.dataclass(frozen=True)
class ResourceType:
    """One type of computing resource (paper's ``Type t``).

    Attributes:
      name: human-readable identifier.
      price: USD per hour for one unit (paper §6: CPU core 0.04, V100 2.42).
      flops: peak dense FLOP/s of one unit.
      mem_bw: memory bandwidth in bytes/s of one unit.
      net_bw: network/interconnect bandwidth in bytes/s of one unit.
      ingest_bw: bandwidth at which *input training data* reaches the unit
        (host RAM for CPU workers; PCIe for GPU workers).  This is what
        makes embedding/data-intensive layers expensive on accelerators —
        the paper's data-intensive vs compute-intensive distinction.
      sparse_eff: efficiency multiplier for sparse/gather-heavy work
        (CPUs handle irregular access relatively better than their peak
        FLOPs suggest; accelerators are de-rated).
      max_count: ``N_{t,limit}`` — maximum number of units available
        (Formula 10).
    """

    name: str
    price: float
    flops: float
    mem_bw: float
    net_bw: float
    ingest_bw: float
    sparse_eff: float
    max_count: int

    @property
    def price_per_sec(self) -> float:
        return self.price / 3600.0


# --- the paper's experimental fleet (§6: Intel Gold 6271C cores + V100) ---

CPU_CORE = ResourceType(
    name="cpu",
    price=0.04,
    flops=0.05 * TFLOPS,          # one core w/ AVX-512, fp32
    mem_bw=8 * GB,                # per-core share of socket bandwidth
    net_bw=12.5 * GB,             # 100 Gbps InfiniBand
    ingest_bw=8 * GB,             # data already in host RAM
    sparse_eff=0.5,
    max_count=10 * 48,            # 10 CPU servers x 48 cores (paper §6)
)

V100 = ResourceType(
    name="v100",
    price=2.42,
    flops=112 * TFLOPS,           # tensor-core fp16
    mem_bw=900 * GB,
    net_bw=12.5 * GB,
    ingest_bw=12 * GB,            # PCIe 3.0 x16 effective
    sparse_eff=0.05,
    max_count=4 * 8,              # 4 GPU servers x 8 V100 (paper §6)
)
