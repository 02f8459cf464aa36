"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs the colocated serving engine (serve/engine.py facade over Scheduler /
KVCacheManager / Session) on one device, ``--device cuda`` by default.
Without ``--smoke`` the configuration runs at its full published width
with random weights from ``--seed``; ``--smoke`` takes its ``.reduced()``
twin.

``--batch`` / ``--max-len`` may be omitted: the cache manager then sizes
the decode slots from the serving tier's ``cache_tier_report``.  Cold KV
(preempted sessions under ``--scheduler fair/priority/srpt/deadline``)
goes to the ``--spill`` tier; with ``--page-size`` the cache is *paged* —
cold pages spill lazily, per page, through the per-tenant ``--page-codec``
— and ``--pages`` overcommits the pool below batch x pages_per_slot.
``--decode-kernel`` decodes in place over the page table through the
paged-attention kernel (cold int8 pages may then stay compressed-resident);
the int8 spill codec always runs through its pack/unpack kernels on the
card.  A hybrid model (zamba2) pages its shared attention block's k/v and
keeps each slot's Mamba2 conv / ssm state beside the pool, parked whole
when its session is preempted.  The summary ends with the launches of
each kernel wrapper during the run (0 on the CPU, where every wrapper
takes its plain version).  ``--tenant-quota`` caps what each tenant may
hold (see serve/quota.parse_quota_spec for the grammar); ``--tenants N``
spreads the synthetic requests over N tenant names.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import MemoryPlan, RunConfig, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.runtime import fmt_bytes
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.quota import quota_from_cli
from repro_torch.serve.scheduler import build_scheduler, registered_schedulers


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced twin of the configuration")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--batch", type=int, default=None,
                    help="decode slots (default: auto from the tier report)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="cache rows per slot (default: auto)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", default=[16],
                    type=lambda v: [int(n) for n in v.split(",")],
                    help="prompt tokens, or a comma-separated list of "
                         "lengths cycled over the requests")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--stagger", type=int, default=0,
                    help="request i decodes new-tokens + i*stagger tokens")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--scheduler", default="fcfs",
                    choices=registered_schedulers())
    ap.add_argument("--quantum", type=int, default=8,
                    help="fair-scheduler decode quantum")
    ap.add_argument("--spill", default="spill",
                    help="secondary tier policy for cold KV")
    ap.add_argument("--page-size", type=int, default=None,
                    help="page the KV cache (rows per page; default: "
                         "monolithic slots)")
    ap.add_argument("--pages", type=int, default=None,
                    help="page-pool size (default batch*max_len/page_size; "
                         "smaller overcommits)")
    ap.add_argument("--page-codec", default=None,
                    help="default spill codec for cold pages (fp8/int8/...)")
    ap.add_argument("--decode-kernel", action="store_true",
                    help="decode in place over the page table (paged "
                         "attention kernel)")
    ap.add_argument("--tenant-quota", default=None,
                    help="per-tenant caps, e.g. 'pages=16,sessions=2' or "
                         "'a:pages=8;b:sessions=1,codec=int8'")
    ap.add_argument("--tenants", type=int, default=1,
                    help="spread requests over N tenant names t0..tN-1")
    ap.add_argument("--deadline-slack", type=int, default=None,
                    help="per-request deadline = slack + (i+1)*new-tokens "
                         "engine steps (with --scheduler deadline)")
    args = ap.parse_args(argv)
    if args.decode_kernel and not args.page_size:
        ap.error("--decode-kernel reads through the page table: pass "
                 "--page-size")
    return args


def build_engine(args: argparse.Namespace,
                 dtype: Optional[str] = None) -> Engine:
    """The model (random weights from ``--seed``) behind its engine;
    ``dtype`` (e.g. "float32") overrides the configuration's."""
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    shape = ShapeConfig("serve", args.max_len or 128, args.batch or 4,
                        "decode")
    model = build_model(RunConfig(model=cfg, shape=shape,
                                  memory=MemoryPlan(policy="none")),
                        device=args.device)
    sched = (build_scheduler("fair", quantum=args.quantum)
             if args.scheduler == "fair" else build_scheduler(args.scheduler))
    return Engine(model, model.init(args.seed), batch=args.batch,
                  max_len=args.max_len, temperature=args.temperature,
                  seed=args.seed, scheduler=sched, spill=args.spill,
                  page_size=args.page_size, pages=args.pages,
                  quota=quota_from_cli(args.tenant_quota, args.page_codec),
                  decode_kernel=args.decode_kernel)


def submit_requests(eng: Engine, args: argparse.Namespace,
                    first_token_at: dict) -> list:
    """The synthetic requests (prompts from ``--seed``); each session's
    first token time lands in ``first_token_at``."""
    rng = np.random.default_rng(args.seed)
    sessions = []
    for i in range(args.requests):
        deadline = (args.deadline_slack + (i + 1) * args.new_tokens
                    if args.deadline_slack is not None else None)
        sessions.append(eng.submit(Request(
            uid=i,
            prompt=rng.integers(0, eng.model.cfg.vocab_size,
                                size=(args.prompt_len[i % len(
                                    args.prompt_len)],)).astype(np.int32),
            max_new_tokens=args.new_tokens + i * args.stagger,
            priority=i % 3 if args.scheduler == "priority" else 0,
            tenant=f"t{i % max(1, args.tenants)}",
            deadline=deadline),
            on_token=lambda s, t: first_token_at.setdefault(
                s.uid, time.perf_counter())))
    return sessions


def kernel_launches() -> dict:
    """The launch count of every serving kernel's wrapper."""
    from repro_torch.kernels import offload_pack, paged_attention, ssd_scan
    return {"paged_decode_attention":
            paged_attention.paged_decode_attention.launches,
            "ssd_scan": ssd_scan.ssd_scan.launches,
            "int8_pack": offload_pack.int8_pack.launches,
            "unpack": offload_pack.fp8_unpack.launches}


def main(argv=None) -> Engine:
    """Serve the synthetic requests and print the summary; returns the
    engine (its sessions and traffic report) for callers that check it."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    eng = build_engine(args)
    model, cfg = eng.model, eng.model.cfg
    print(eng.describe())
    print(f"model: {cfg.name} {cfg.num_layers}L d_model={cfg.d_model} "
          f"{cfg.dtype} on {model.device}")
    sync = torch.cuda.synchronize if model.device.type == "cuda" \
        else (lambda: None)
    first_token_at = {}
    launches = kernel_launches()
    sync()
    t0 = time.perf_counter()
    sessions = submit_requests(eng, args, first_token_at)
    done = eng.run()
    sync()
    dt = time.perf_counter() - t0
    total_new = sum(len(s.result()) for s in sessions)
    print(f"served {len(done)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s)")
    if first_token_at:
        ttft = [first_token_at[s.uid] - t0 for s in sessions
                if s.uid in first_token_at]
        print(f"ttft: mean {1e3 * sum(ttft) / len(ttft):.1f}ms, "
              f"max {1e3 * max(ttft):.1f}ms")
    for s in sessions[:3]:
        print(f"  req {s.uid}: {s.finish_reason}, "
              f"preempted {s.preemptions}x, {s.result()[:8]}...")
    report = eng.traffic_report()
    if report.get("kv_stash"):
        fetch = report.get("kv_fetch", {"wire_bytes": 0.0, "calls": 0})
        print(f"spill[{report['tier']}]: "
              f"stash {fmt_bytes(report['kv_stash']['wire_bytes'])}"
              f"/{report['kv_stash']['calls']}x, "
              f"fetch {fmt_bytes(fetch['wire_bytes'])}"
              f"/{fetch['calls']}x")
    if report.get("slots", {}).get("parks"):
        sl = report["slots"]
        print(f"slots parked: {sl['parks']}x, "
              f"{fmt_bytes(sl['park_bytes'])} of conv / ssm state")
    if report.get("pages"):
        p = report["pages"]
        print(f"pages[{p['num_pages']}x{p['page_size']}]: "
              f"{p['evictions']} evicted, {p['refetches']} refetched, "
              f"{p['readmits_free']} readmitted copy-free, "
              f"{p['adoptions']} adopted")
    if report.get("decode_io", {}).get("in_place"):
        dio = report["decode_io"]
        frac = (dio["bytes_touched"] / dio["bytes_gather_equiv"]
                if dio["bytes_gather_equiv"] else 0.0)
        print(f"decode_io[in-place]: {dio['steps']} steps read "
              f"{fmt_bytes(dio['bytes_touched'])} of KV "
              f"({frac:.1%} of the {fmt_bytes(dio['bytes_gather_equiv'])} "
              f"a full gather touches), "
              f"{dio['compressed_resident']} pages compressed-resident "
              f"({dio['compressed_adopts']} adoptions)")
    if eng.quota is not None:
        print("tenants:", {t: u for t, u in eng.quota_report().items()})
    print("kernel launches: " + ", ".join(
        f"{k}={n - launches[k]}" for k, n in kernel_launches().items()))
    if hasattr(eng.scheduler, "miss_report"):
        print("deadlines:", eng.scheduler.miss_report())
    return eng


if __name__ == "__main__":
    main()
