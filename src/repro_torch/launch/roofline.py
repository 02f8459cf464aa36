"""Roofline analysis of the dry-run's counts (§Roofline), against the H100.

Per (arch x shape x mesh) cell:

  compute term    = FLOPs / peak_FLOP/s
  memory term     = bytes / HBM_bw
  collective term = collective_bytes / link_bw

All three inputs are per-device numbers from launch/dryrun.py (FLOPs
counted by ``FlopCounterMode`` plus the hand-written kernels' own counts,
bytes summed over the step's aten ops and kernels, the collectives from
the ring formulas), so the division by ``chips`` is already folded in.
The dominant term is the bottleneck; the roofline fraction scores how
close the cell is to the machine:

  ideal_s    = MODEL_FLOPS / (chips x peak)     (6*N*D useful compute)
  bound_s    = max(compute, memory, collective)
  fraction   = ideal_s / bound_s

Every number here is modelled, from counts and the chip's data-sheet
rates (``hw.H100`` by default); nothing is timed.  Known bias: the bytes
are summed over unfused aten ops (each op's inputs read and outputs
written once), so the memory term is an upper bound on what a fused
program moves — as the reference's note on XLA's CPU counts says of its
own.
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List, Optional

from repro_torch import hw
from repro_torch.configs import SHAPES_BY_NAME, ShapeConfig, get_arch
from repro_torch.core.dag import model_flops


def mesh_chips(mesh: str) -> int:
    """Devices of a mesh string: "1" -> 1, "16x16" -> 256, "2x16x16" ->
    512."""
    return math.prod(int(d) for d in str(mesh).split("x"))


def _shape_of(r: Dict) -> ShapeConfig:
    if r["shape"] in SHAPES_BY_NAME:
        return SHAPES_BY_NAME[r["shape"]]
    return ShapeConfig(r["shape"], r["seq_len"], r["global_batch"],
                       r["mode"])


def analyze_cell(r: Dict, chip: hw.Chip = hw.H100, cfg=None
                 ) -> Optional[Dict]:
    """The roofline terms of one dry-run result ``r`` on ``chip``; None
    for a skipped or failed cell.  ``cfg``: the model configuration when
    ``r["arch"]`` is not a registry name (a cut depth)."""
    if not r.get("ok"):
        return None
    cfg = cfg if cfg is not None else get_arch(r["arch"])
    shape = _shape_of(r)
    chips = mesh_chips(r["mesh"])

    compute_s = (r["flops_per_dev"] or 0.0) / chip.peak_flops
    memory_s = (r["bytes_accessed_per_dev"] or 0.0) / chip.hbm_bw
    coll_s = (r["collective_wire_bytes_per_dev"] or 0.0) / chip.link_bw

    mf = model_flops(cfg, shape)
    ideal_s = mf / (chips * chip.peak_flops)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    flops_global = (r["flops_per_dev"] or 0.0) * chips
    return {
        **{k: r.get(k) for k in ("arch", "shape", "mesh", "policy",
                                 "placement", "compress", "opt_bits",
                                 "accum")},
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "model_flops": mf,
        "ideal_s": ideal_s,
        "bound_s": bound,
        "useful_ratio": (mf / flops_global) if flops_global else 0.0,
        "roofline_fraction": (ideal_s / bound) if bound else 0.0,
        "fits_hbm": ((r.get("arg_bytes_per_dev") or 0)
                     + (r.get("temp_bytes_per_dev") or 0)) <= chip.hbm_bytes,
        "arg_gb": (r.get("arg_bytes_per_dev") or 0) / 1e9,
        "temp_gb": (r.get("temp_bytes_per_dev") or 0) / 1e9,
        "advice": _advice(dominant),
    }


def _advice(dominant: str) -> str:
    if dominant == "collective":
        return ("shrink NVLink bytes: local placement / fp8 stash "
                "compression / fewer FSDP regathers (larger weight shards)")
    if dominant == "memory":
        return ("raise arithmetic intensity: fewer HBM round trips (fuse "
                "norms, rope, casts and the optimizer into hand-written "
                "kernels), larger per-device batch, bf16 end to end")
    return ("compute-bound: reduce recompute (policy=auto keeps layers "
            "resident when HBM allows), keep every product on the bf16 "
            "tensor cores (wgmma tiles), cast scores bf16")


def analyze_file(path: str, chip: hw.Chip = hw.H100) -> List[Dict]:
    with open(path) as f:
        rows = json.load(f)
    out = []
    for r in rows:
        a = analyze_cell(r, chip)
        if a is not None:
            out.append(a)
        elif r.get("skip"):
            out.append({"arch": r["arch"], "shape": r["shape"],
                        "mesh": r["mesh"], "skip": r["skip"]})
        else:
            out.append({"arch": r["arch"], "shape": r["shape"],
                        "mesh": r.get("mesh"), "error": r.get("error")})
    return out


def to_markdown(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| 6ND/counted | roofline frac | fits | note |\n"
           "|---|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for a in rows:
        if "skip" in a:
            lines.append(f"| {a['arch']} | {a['shape']} | — | — | — | — | — "
                         f"| — | — | SKIP: {a['skip'][:40]} |")
            continue
        if "error" in a:
            lines.append(f"| {a['arch']} | {a['shape']} | — | — | — | — | — "
                         f"| — | — | ERROR: {str(a['error'])[:40]} |")
            continue
        lines.append(
            f"| {a['arch']} | {a['shape']} | {a['compute_s']:.3f} "
            f"| {a['memory_s']:.3f} | {a['collective_s']:.3f} "
            f"| **{a['dominant']}** | {a['useful_ratio']:.2f} "
            f"| {a['roofline_fraction']:.2%} "
            f"| {'y' if a['fits_hbm'] else 'NO'} "
            f"| {a['advice'][:48]} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("reports", nargs="+")
    ap.add_argument("--md", default="")
    args = ap.parse_args(argv)
    rows = []
    for path in args.reports:
        rows.extend(analyze_file(path))
    md = to_markdown(rows)
    print(md)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md + "\n")


if __name__ == "__main__":
    main()
