"""Heterogeneous resource-type fleet definitions (HeterPS §3, §6; the
port's copy of ``repro.core.resources``).

A :class:`ResourceType` is one *kind* of computing resource the scheduler
may place a layer on — one CPU core, one V100 card, one TPU v5e chip.
The paper prices resources per hour (0.04 USD/core-hr CPU, 2.42 USD/hr
V100) and simulates additional GPU types by scaling the price; the
scheduling experiments keep that fleet, plus a TPU-like tier the
reference's analytic architecture profiles use.  These are the
*scheduled* fleet's constants, not the card the port runs on.  The PS
telemetry re-anchors a type's bandwidth terms to measured traffic
(``repro_torch.ps.telemetry.PSTelemetry.to_resource``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

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

# TPU v5e-like tier used for the assigned-architecture profiles
# (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI — roofline constants).
TPU_V5E = ResourceType(
    name="tpu_v5e",
    price=1.20,
    flops=197 * TFLOPS,
    mem_bw=819 * GB,
    net_bw=50 * GB,
    ingest_bw=12 * GB,
    sparse_eff=0.05,
    max_count=512,
)


def default_fleet() -> list[ResourceType]:
    """The paper's two-type fleet: CPU cores + V100 cards."""
    return [CPU_CORE, V100]


def make_fleet(num_types: int, *, seedless: bool = True) -> list[ResourceType]:
    """A fleet with ``num_types`` resource types.

    The paper simulates many GPU types by taking "the V100 GPU with
    different prices" (§6.2).  We do the same deterministically: type
    ``j`` is a V100 variant whose price and throughput are scaled so that
    price/performance varies across types (otherwise every plan would pick
    the single cheapest type and the scheduling problem degenerates).
    """
    fleet = [CPU_CORE]
    for j in range(num_types - 1):
        # spread performance over [0.55x, 1.45x] and price super-linearly so
        # faster variants have worse price/perf (cloud-realistic).
        perf = 0.55 + 0.9 * (j / max(1, num_types - 2)) if num_types > 2 else 1.0
        price = 2.42 * perf**1.35
        fleet.append(
            dataclasses.replace(
                V100,
                name=f"gpu{j}",
                price=round(price, 4),
                flops=V100.flops * perf,
                mem_bw=V100.mem_bw * perf,
                max_count=V100.max_count,
            )
        )
    return fleet


def fleet_names(fleet: Sequence[ResourceType]) -> list[str]:
    return [r.name for r in fleet]
