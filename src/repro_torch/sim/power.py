"""Memory-node power model — paper Table IV + §V-C performance/watt.

DIMM TDPs are the paper's cited measurements (Samsung datasheets + Micron
DDR4 power calculator); a memory-node carries 10 DIMMs (§III-A).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

DGX_TDP_W = 3200.0           # DC-DLA baseline system TDP (paper §V-C)
N_MEMNODES = 8


@dataclasses.dataclass(frozen=True)
class DimmOption:
    name: str
    capacity_gb: int
    tdp_w: float             # single DIMM

    @property
    def node_tdp_w(self) -> float:
        return 10 * self.tdp_w

    @property
    def node_capacity_gb(self) -> float:
        return 10 * self.capacity_gb

    @property
    def gb_per_w(self) -> float:
        return self.node_capacity_gb / self.node_tdp_w


# paper Table IV
DIMM_OPTIONS: Tuple[DimmOption, ...] = (
    DimmOption("8GB RDIMM", 8, 2.9),
    DimmOption("16GB RDIMM", 16, 6.6),
    DimmOption("32GB LRDIMM", 32, 8.7),
    DimmOption("64GB LRDIMM", 64, 10.2),
    DimmOption("128GB LRDIMM", 128, 12.7),
)


def table4() -> Dict[str, Dict[str, float]]:
    out = {}
    for d in DIMM_OPTIONS:
        out[d.name] = {
            "dimm_tdp_w": d.tdp_w,
            "node_tdp_w": d.node_tdp_w,
            "gb_per_w": round(d.gb_per_w, 1),
            "node_capacity_gb": d.node_capacity_gb,
        }
    return out


def system_overhead(option: DimmOption) -> Dict[str, float]:
    """§V-C: added power, capacity, and perf/W of MC-DLA vs DC-DLA."""
    added_w = N_MEMNODES * option.node_tdp_w
    frac = added_w / DGX_TDP_W
    return {
        "added_power_w": added_w,
        "power_increase_frac": frac,
        "pool_capacity_tb": N_MEMNODES * option.node_capacity_gb / 1e3,
    }


def perf_per_watt(speedup: float, option: DimmOption) -> float:
    """Speedup / power-increase = perf/W gain over DC-DLA (paper: 2.1-2.6x
    for 2.8x speedup at +7%..+31% power)."""
    ov = system_overhead(option)
    return speedup / (1.0 + ov["power_increase_frac"])
