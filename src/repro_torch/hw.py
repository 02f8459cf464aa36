"""Hardware constants.

Three hardware models coexist here:

* :data:`H100` — the TARGET hardware of this package (PyTorch + CUDA on
  one NVIDIA H100 SXM: 80 GB HBM at 3.35 TB/s, 989 TFLOP/s dense bf16,
  NVLink 450 GB/s each way).  Cache sizing and tier costs default to it.

* :data:`TPU_V5E` — the target of the JAX reference package, kept as data
  (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI, 16 GB HBM).

* :data:`PAPER_DEVICE` / :data:`PAPER_MEMNODE` — the paper's Table II
  configuration (1024 PEs x 125 MACs @ 1 GHz = 256 TFLOP/s, 900 GB/s HBM,
  N=6 links x 25 GB/s).  The ``sim/`` package reproduces the paper's
  evaluation against these numbers, so the faithful-reproduction figures are
  comparable with the paper's own.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Chip:
    """One accelerator chip (device-node in the paper's vocabulary)."""

    name: str
    peak_flops: float          # FLOP/s (bf16 MXU for TPU, MAC*2 for paper dev)
    hbm_bw: float              # bytes/s local memory bandwidth
    hbm_bytes: float           # local memory capacity
    num_links: int             # device-side interconnect links (N)
    link_bw: float             # bytes/s per link, per direction (B)
    mem_latency_s: float = 1e-7


@dataclasses.dataclass(frozen=True)
class MemNode:
    """The paper's capacity-optimized memory-node (Fig. 6)."""

    mem_bw: float              # bytes/s of the DIMM array
    capacity_bytes: float
    num_links: int
    link_bw: float


GB = 1e9
TB = 1e12

TPU_V5E = Chip(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    hbm_bytes=16 * GB,
    num_links=4,               # v5e: 4 ICI links per chip (2D torus)
    link_bw=50e9,
)

# NVIDIA H100 SXM data sheet (dense rates, 700 W): 18 NVLink-4 links of
# 25 GB/s per direction = 450 GB/s each way.
H100 = Chip(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80 * GB,
    num_links=18,
    link_bw=25e9,
)

# Paper Table II device-node: 1024 PEs x 125 MACs x 1 GHz -> 128 TMAC/s
# = 256 TFLOP/s (1 MAC = 2 FLOPs); 900 GB/s HBM; N=6 links x 25 GB/s.
PAPER_DEVICE = Chip(
    name="paper-device",
    peak_flops=1024 * 125 * 1e9 * 2.0,
    hbm_bw=900e9,
    hbm_bytes=16 * GB,
    num_links=6,
    link_bw=25e9,
)

# Paper Table II memory-node: 256 GB/s DIMM bandwidth; 10 DIMMs/node;
# capacity 80 GB (8 GB RDIMM) .. 1.3 TB (128 GB LRDIMM).
PAPER_MEMNODE = MemNode(
    mem_bw=256e9,
    capacity_bytes=1.3 * TB,
    num_links=6,
    link_bw=25e9,
)

# inter-pod data-center network: the pod-axis pipeline's per-stage hop
# (parallel/pipeline.py ppermute).  Per-transfer latency matters for the
# bubble-vs-stall planner: many small microbatches pay it per transfer.
DCN_BW = 25e9                  # bytes/s per device across pods
DCN_LATENCY_S = 5e-6           # per-transfer latency of one DCN hop

PCIE_GEN3_BW = 16e9            # x16 per direction (DC-DLA host link)
PCIE_GEN4_BW = 32e9            # sensitivity study (paper §V-B)

# DGX-1-style PCIe tree: 4 GPUs share one CPU socket's root complex
# (~2 x16 uplinks worth).  Paper §I: per-device host bandwidth divides by
# the number of intra-node devices streaming concurrently.
PCIE_ROOT_PER_SOCKET = 32e9
DEVICES_PER_HOST = 8           # intra-node devices sharing the host links

# host DRAM visible to one device's virtualization (DC-DLA backing store)
HOST_DRAM_BYTES = 512 * GB

# host CPU socket memory bandwidth (paper §II-C): Xeon 80 GB/s, Power9 120;
# the hypothetical HC-DLA CPU is overprovisioned to 300 GB/s (paper §IV).
XEON_SOCKET_BW = 80e9
HCDLA_SOCKET_BW = 300e9

BYTES_BF16 = 2
BYTES_FP32 = 4
BYTES_FP8 = 1
