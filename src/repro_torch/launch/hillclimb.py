"""§Perf hill climb: run one (arch x shape) cell under a list of
named variants (placement / compression / optimizer bits / accumulation /
policy changes) through the dry-run on the fake card, print the roofline
terms of each against the H100, and append the hypothesis log to a JSON.

    python -m repro_torch.launch.hillclimb --arch smollm-135m \\
        --shape train_4k --variants baseline,fp8,auto,oracle --out hc.json

Serving-wire sweep (``probe_wire`` MB/s on the host clock instead of a
traced cell; the pages on ``--device``, so a codec packs on the card):

    python -m repro_torch.launch.hillclimb --wire \\
        --variants wire-baseline,wire-streams-4,shm --out hc.json

A training variant's numbers are modelled (counted FLOPs and bytes over
data-sheet rates); a wire variant's MB/s is measured.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict

from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.roofline import analyze_cell

# named variants: kwargs overrides for lower_cell
VARIANTS: Dict[str, Dict] = {
    "baseline": {},                                  # paper-faithful mcdla
    "local": {"placement": "local"},
    "fp8": {"compress": "fp8"},
    "bits8": {"opt_bits": 8},
    "accum2": {"accum": 2},
    "accum4": {"accum": 4},
    "no-sp": {"seq_parallel": False},
    "auto": {"policy": "auto"},
    "oracle": {"policy": "none"},
    "local+fp8": {"placement": "local", "compress": "fp8"},
    "local+fp8+bits8": {"placement": "local", "compress": "fp8",
                        "opt_bits": 8},
    "local+bits8": {"placement": "local", "opt_bits": 8},
    "local+bits8+accum4": {"placement": "local", "opt_bits": 8, "accum": 4},
    "no-aux-stash": {"stash_aux": False},
    "bits8+accum2": {"opt_bits": 8, "accum": 2},
}

# serving-wire variants: kwargs overrides for serve/transport.probe_wire.
# Swept with ``--wire`` instead of a training cell — the wire config joins
# the same hypothesis log ahead of the global autotuner.
WIRE_VARIANTS: Dict[str, Dict] = {
    "wire-baseline": {"transport": "tcp", "streams": 1},
    "wire-bufsize-4m": {"transport": "tcp", "streams": 1,
                        "bufsize": 4 << 20},
    "wire-streams-2": {"transport": "tcp", "streams": 2},
    "wire-streams-4": {"transport": "tcp", "streams": 4},
    "wire-streams-8": {"transport": "tcp", "streams": 8},
    "wire-streams-4+int8": {"transport": "tcp", "streams": 4,
                            "codec": "int8"},
    "shm": {"transport": "shm", "streams": 1},
}


def _run_wire(args) -> list:
    from repro_torch.serve.transport import probe_wire
    rows = []
    for name in args.variants.split(","):
        kw = WIRE_VARIANTS[name]
        try:
            r = probe_wire(payload_mb=args.payload_mb, device=args.device,
                           **kw)
            rows.append({"variant": name, **r})
            print(f"[{name:>18s}] {r['mb_per_s']:8.1f} MB/s "
                  f"handoff={r['handoff_ms']:.1f}ms "
                  f"wire={int(r['wire_bytes'])}B")
        except Exception as e:  # noqa: BLE001
            rows.append({"variant": name, "error": str(e)})
            print(f"[{name:>18s}] FAILED: {e}")
    return rows


def _append(path: str, entry: dict) -> None:
    existing = []
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    existing.append(entry)
    with open(path, "w") as f:
        json.dump(existing, f, indent=1, default=str)


def main(argv=None) -> list:
    """Runs the sweep; returns its rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--variants", default="baseline,local")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--wire", action="store_true",
                    help="sweep WIRE_VARIANTS via probe_wire instead of "
                         "tracing a training cell")
    ap.add_argument("--payload-mb", type=float, default=64.0,
                    help="handoff payload for --wire probes")
    ap.add_argument("--device", default="cuda",
                    help="the fake device a cell is traced on; the device "
                         "the --wire pages lie on")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    if args.wire:
        rows = _run_wire(args)
        if args.out:
            _append(args.out, {"arch": "wire",
                               "shape": f"{args.payload_mb}mb", "rows": rows})
        return rows
    if not args.arch or not args.shape:
        ap.error("--arch and --shape are required without --wire")
    if args.multi_pod:
        ap.error("--multi-pod: the dry-run runs on one device; the "
                 "production mesh ports with ROADMAP A8b")

    rows = []
    for name in args.variants.split(","):
        kw = VARIANTS[name]
        try:
            r = lower_cell(args.arch, args.shape,
                           probes=not args.no_probes, device=args.device,
                           **kw)
            a = analyze_cell(r)
            rows.append({"variant": name, **a,
                         "temp_gb": r["temp_bytes_per_dev"] / 1e9,
                         "arg_gb": r["arg_bytes_per_dev"] / 1e9,
                         "collectives": r["collectives"]})
            print(f"[{name:>18s}] compute={a['compute_s']:.3f}s "
                  f"memory={a['memory_s']:.3f}s coll={a['collective_s']:.3f}s "
                  f"dom={a['dominant']:10s} frac={a['roofline_fraction']:.2%} "
                  f"args={r['arg_bytes_per_dev']/1e9:.1f}GB "
                  f"temp={r['temp_bytes_per_dev']/1e9:.1f}GB")
        except Exception as e:  # noqa: BLE001
            rows.append({"variant": name, "error": str(e)})
            print(f"[{name:>18s}] FAILED: {e}")
    if args.out:
        _append(args.out, {"arch": args.arch, "shape": args.shape,
                           "rows": rows})
    return rows


if __name__ == "__main__":
    main()
