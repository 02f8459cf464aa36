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
card.  ``--prefix-share`` (paged only) binds the pages of a prompt prefix
already in the cache read-only and forks the page where a prompt leaves
it; ``--shared-prefix N`` starts every synthetic prompt with the same N
tokens.  A hybrid model (zamba2) pages its shared attention block's k/v and
keeps each slot's Mamba2 conv / ssm state beside the pool, parked whole
when its session is preempted.  The summary ends with the launches of
each kernel wrapper during the run (0 on the CPU, where every wrapper
takes its plain version).  ``--tenant-quota`` caps what each tenant may
hold (see serve/quota.parse_quota_spec for the grammar); ``--tenants N``
spreads the synthetic requests over N tenant names.

``--role`` disaggregates prefill from decode (serve/disagg.py): ``both``
runs the two engines in this process — prompts prefill on a prefill-role
engine, KV pages ship through the ``--transfer-tier`` (metered, printed as
the transfer report beside the time to first token, which the prefill
side emits), and a decode-role engine adopts them; ``prefill`` runs the
prefill engine alone into a queue of ``--transfer-depth`` handoffs and
reports what shipped; ``decode --connect HOST:PORT`` runs the decode
worker of a two-process deployment over the TCP wire (serve/transport.py),
adopting handoffs off the socket and sending results back.  Omit
``--role`` for the colocated engine.

``--router`` runs the cluster front-end (serve/router.py) over
``--engines`` prefill / decode pairs, ``--placement`` choosing where
sessions land: ``--transport memory|tcp|shm`` makes engine 0 a wire pair
(every page crosses as frames; ``shm``: tensor bytes through a
shared-memory arena, headers over the pipe), ``--listen PORT`` makes it
the prefill half of a two-process pair (start the peer with ``--role
decode --connect``; port 0 picks one and prints it), ``--wire-streams N``
stripes each handoff over N connections (both halves must agree),
``--wire-bufsize`` sizes the socket buffers, ``--drain-after N`` drains
``--drain-engine`` after N router steps (the run fails if a session is
dropped), and ``--trace N`` replays N sessions of the synthetic diurnal /
burst / shared-prefix traffic (sim/workloads.py) instead of the uniform
requests.  ``--fed-listen PORT`` (0: pick one, printed as ``federation:
listening on PORT``) and ``--peer HOST:PORT`` federate two such routers
(serve/router.py ``FederatedRouter``): work neither engine of a cluster
has room for is forwarded to the peer cluster, served there and its
tokens sent home.  ``--trace`` does not compose with federation.
Serving runs on one device: under ``torchrun`` (``WORLD_SIZE`` > 1) and
with ``--multi-pod`` the CLI exits (serving on a mesh is ROADMAP A8b's).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs import MemoryPlan, RunConfig, get_arch
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.runtime import MemoryRuntime, fmt_bytes
from repro_torch.models.model import build_model
from repro_torch.serve.disagg import DisaggPair, TransferQueue, build_disagg
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.quota import QuotaManager, quota_from_cli
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
    ap.add_argument("--multi-pod", action="store_true",
                    help="the production mesh: refused (ROADMAP A8b)")
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
    ap.add_argument("--prefix-share", action="store_true",
                    help="share common prompt-prefix pages copy-on-write "
                         "across sessions (paged cache only)")
    ap.add_argument("--decode-kernel", action="store_true",
                    help="decode in place over the page table (paged "
                         "attention kernel)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="draw the first N prompt tokens from a common "
                         "prefix so --prefix-share has something to hit")
    ap.add_argument("--tenant-quota", default=None,
                    help="per-tenant caps, e.g. 'pages=16,sessions=2' or "
                         "'a:pages=8;b:sessions=1,codec=int8'")
    ap.add_argument("--tenants", type=int, default=1,
                    help="spread requests over N tenant names t0..tN-1")
    ap.add_argument("--deadline-slack", type=int, default=None,
                    help="per-request deadline = slack + (i+1)*new-tokens "
                         "engine steps (with --scheduler deadline)")
    ap.add_argument("--role", default=None,
                    choices=("prefill", "decode", "both"),
                    help="disaggregate prefill/decode (both: the two "
                         "engines in this process; default: colocated "
                         "engine)")
    ap.add_argument("--transfer-tier", default="spill",
                    help="tier policy carrying KV handoffs between roles "
                         "(spill: pooled HBM -> host; host: pinned host "
                         "memory)")
    ap.add_argument("--transfer-depth", type=int, default=None,
                    help="max handoffs parked in the transfer queue "
                         "(prefill admission stalls past it)")
    ap.add_argument("--router", action="store_true",
                    help="run the cluster router over --engines pairs")
    ap.add_argument("--engines", type=int, default=2,
                    help="prefill/decode pairs behind the router")
    ap.add_argument("--placement", default="least_loaded",
                    help="placement policy "
                         "(least_loaded/prefix_affinity/round_robin)")
    ap.add_argument("--transport", default=None,
                    choices=("memory", "tcp", "shm"),
                    help="make router engine 0 a wire pair over this "
                         "channel (shm: tensor bytes through a "
                         "shared-memory arena, headers over the pipe)")
    ap.add_argument("--wire-streams", type=int, default=1,
                    help="stripe each wire handoff page-wise across N "
                         "parallel sub-channels (1: single stream)")
    ap.add_argument("--wire-bufsize", type=int, default=None,
                    help="SO_SNDBUF/SO_RCVBUF for wire TCP sockets "
                         "(default: kernel autotuning)")
    ap.add_argument("--peer", default=None, metavar="HOST:PORT",
                    help="router mode: federate with the router at this "
                         "address (forward admissions we cannot place)")
    ap.add_argument("--fed-listen", type=int, default=None,
                    help="router mode: accept one federation peer on this "
                         "port (0: ephemeral, printed)")
    ap.add_argument("--listen", type=int, default=None,
                    help="router engine 0 serves prefill over TCP on this "
                         "port (0: ephemeral, printed); the peer runs "
                         "--role decode --connect")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="with --role decode: adopt handoffs from this "
                         "router process")
    ap.add_argument("--drain-after", type=int, default=None,
                    help="router mode: drain --drain-engine after N "
                         "router steps")
    ap.add_argument("--drain-engine", type=int, default=0)
    ap.add_argument("--trace", type=int, default=None,
                    help="router mode: replay N synthetic traffic "
                         "sessions (diurnal/burst/shared-prefix mix)")
    args = ap.parse_args(argv)
    if args.role == "decode" and args.connect is None:
        ap.error("--role decode needs a peer feeding the transfer queue; "
                 "use --role both for the in-process loopback, or pass "
                 "--connect HOST:PORT for the two-process wire")
    if args.role is not None and not args.page_size:
        ap.error("--role ships page-shaped KV: pass --page-size")
    if args.router and not args.page_size:
        ap.error("--router ships page-shaped KV: pass --page-size")
    if args.decode_kernel and not args.page_size:
        ap.error("--decode-kernel reads through the page table: pass "
                 "--page-size")
    if args.prefix_share and not args.page_size:
        ap.error("--prefix-share reuses whole pages: pass --page-size")
    if args.prefix_share and (args.role is not None or args.router):
        ap.error("--prefix-share is a colocated-engine feature for now")
    if args.decode_kernel and (args.role is not None or args.router):
        ap.error("--decode-kernel is a colocated-engine feature for now")
    if args.listen is not None and args.batch is None:
        ap.error("--listen needs explicit --batch/--max-len (the remote "
                 "decode geometry cannot be negotiated over the wire)")
    if args.wire_streams < 1:
        ap.error("--wire-streams must be >= 1")
    if args.wire_streams > 1 and args.transport == "shm":
        ap.error("--transport shm is header-only on one control socket; "
                 "striping it is meaningless (drop --wire-streams)")
    if args.trace and (args.peer or args.fed_listen is not None):
        ap.error("--trace replays against one cluster; it does not "
                 "compose with federation (--peer/--fed-listen)")
    return args


def build_model_params(args: argparse.Namespace,
                       dtype: Optional[str] = None,
                       cfg: Optional[ModelConfig] = None):
    """The model of ``--arch`` (``cfg`` if given; ``dtype`` overriding its
    dtype) on ``--device`` and its random weights from ``--seed``."""
    if cfg is None:
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
    return model, model.init(args.seed)


def decode_scheduler(args: argparse.Namespace):
    """A fresh scheduler object of ``--scheduler`` (``--quantum`` for
    fair)."""
    return (build_scheduler("fair", quantum=args.quantum)
            if args.scheduler == "fair" else build_scheduler(args.scheduler))


def build_engine(args: argparse.Namespace, dtype: Optional[str] = None,
                 cfg: Optional[ModelConfig] = None,
                 **engine_kwargs) -> Union[Engine, DisaggPair]:
    """The model (random weights from ``--seed``) behind its engine (with
    ``--role both``, the prefill/decode pair); ``dtype`` (e.g. "float32")
    overrides the configuration's.  ``cfg`` (no flag sets it) replaces
    ``--arch`` / ``--smoke``'s configuration, e.g. one cut in depth with
    ``dataclasses.replace(cfg, num_layers=N)`` to fit a card.
    ``engine_kwargs`` (no flag sets them) go to the engine, or to the
    pair's decode engine: ``decode_kernel=True`` there, which the command
    line refuses beside ``--role``."""
    model, params = build_model_params(args, dtype, cfg)
    sched = decode_scheduler(args)
    quota = quota_from_cli(args.tenant_quota, args.page_codec)
    if args.role == "both":
        return build_disagg(model, params, batch=args.batch,
                            max_len=args.max_len, page_size=args.page_size,
                            pages=args.pages, transfer=args.transfer_tier,
                            max_depth=args.transfer_depth,
                            scheduler=args.scheduler, decode_scheduler=sched,
                            spill=args.spill, quota=quota,
                            temperature=args.temperature, seed=args.seed,
                            **engine_kwargs)
    if args.role == "prefill":
        runtime = MemoryRuntime(
            model.plan, MemoryPlan(policy=args.transfer_tier,
                                   placement=model.memory.placement),
            model.device)
        return Engine(model, params, batch=args.batch, max_len=args.max_len,
                      temperature=args.temperature, seed=args.seed,
                      scheduler=sched, spill=None, page_size=args.page_size,
                      quota=quota, role="prefill",
                      transfer=TransferQueue(runtime,
                                             max_depth=args.transfer_depth),
                      **engine_kwargs)
    engine_kwargs.setdefault("decode_kernel", args.decode_kernel)
    return Engine(model, params, batch=args.batch,
                  max_len=args.max_len, temperature=args.temperature,
                  seed=args.seed, scheduler=sched, spill=args.spill,
                  page_size=args.page_size, pages=args.pages, quota=quota,
                  prefix_share=args.prefix_share, **engine_kwargs)


def submit_requests(eng, args: argparse.Namespace, first_token_at: dict,
                    vocab: Optional[int] = None) -> list:
    """The synthetic requests (prompts from ``--seed``, each starting with
    the ``--shared-prefix`` tokens drawn first) submitted to ``eng`` (an
    engine, a pair or a router; ``vocab`` for one without a model); each
    session's first token time lands in ``first_token_at``."""
    rng = np.random.default_rng(args.seed)
    vocab = vocab or eng.model.cfg.vocab_size
    head = (rng.integers(0, vocab, size=(args.shared_prefix,))
            if args.shared_prefix > 0 else np.zeros((0,), np.int64))
    sessions = []
    for i in range(args.requests):
        deadline = (args.deadline_slack + (i + 1) * args.new_tokens
                    if args.deadline_slack is not None else None)
        tail = max(1, args.prompt_len[i % len(args.prompt_len)] - len(head))
        prompt = np.concatenate([head, rng.integers(0, vocab, size=(tail,))])
        sessions.append(eng.submit(Request(
            uid=i,
            prompt=prompt.astype(np.int32),
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


def transfer_summary(queue: TransferQueue) -> str:
    """The transfer report in one line: handoffs shipped, adopted and
    requeued, and each leg's wire bytes and calls."""
    rep = queue.traffic_report()
    tq = rep["transfer"]
    legs = ", ".join(
        f"{d} {fmt_bytes(rep[d]['wire_bytes'])}/{rep[d]['calls']}x"
        for d in ("kv_publish", "kv_adopt") if d in rep)
    return (f"transfer[{queue.runtime.tier.describe()}]: "
            f"{tq['published']} handoffs shipped "
            f"({tq['shipped_pages']} pages), "
            f"{tq['adopted_pages']} pages adopted, "
            f"{tq['requeued']} requeued, {tq['swept']} swept, depth "
            f"{tq['depth']}; {legs}")


def main(argv=None, cfg: Optional[ModelConfig] = None,
         **engine_kwargs) -> Union[Engine, DisaggPair]:
    """Serve the synthetic requests and print the summary; returns the
    engine, the pair, the router (``--router``; the federated router over
    it with ``--peer`` / ``--fed-listen``) or the decode worker's
    engine (``--role decode``) for callers that check it.  ``cfg`` and ``engine_kwargs``: as :func:`build_engine`'s
    (the command line never sets them)."""
    args = parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 or args.multi_pod:
        raise SystemExit(
            f"serving on a mesh ({world} ranks"
            f"{', --multi-pod' if args.multi_pod else ''}): the serving "
            "stack runs on one device; serving on a mesh ports with ROADMAP "
            "A8b")
    logging.basicConfig(level=logging.INFO)
    if args.role == "decode":
        return run_decode_role(args, cfg=cfg, **engine_kwargs)
    if args.router:
        return run_router(args, cfg=cfg, **engine_kwargs)
    eng = build_engine(args, cfg=cfg, **engine_kwargs)
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
    if args.role is not None:
        print(transfer_summary(eng.transfer))
    serving = eng.decode if args.role == "both" else eng
    report = serving.traffic_report()
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
    if report.get("prefix", {}).get("enabled"):
        pf = report["prefix"]
        print(f"prefix: {pf['hits']} page hits, {pf['forks']} forks, "
              f"{pf['rows_reused']}/{pf['rows_prompted']} prompt rows "
              f"reused (hit rate {pf['hit_rate']:.1%})")
    if eng.quota is not None:
        print("tenants:", {t: u for t, u in eng.quota_report().items()})
    print("kernel launches: " + ", ".join(
        f"{k}={n - launches[k]}" for k, n in kernel_launches().items()))
    if hasattr(serving.scheduler, "miss_report"):
        print("deadlines:", serving.scheduler.miss_report())
    return eng


def wire_summary(sender) -> str:
    """A wire sender's report in one line: handoffs and pages shipped,
    results back, and its legs' wire bytes and calls."""
    rep = sender.traffic_report()
    tq = rep["transfer"]
    legs = ", ".join(
        f"{d} {fmt_bytes(rep[d]['wire_bytes'])}/{rep[d]['calls']}x"
        for d in ("kv_publish", "kv_wire") if d in rep)
    chan = sender.channel
    kind = chan.describe() if hasattr(chan, "describe") \
        else type(chan).__name__
    return (f"wire[{kind}]: {tq['published']} handoffs shipped "
            f"({tq['shipped_pages']} pages), {tq['results']} results, "
            f"depth {tq['depth']}; {legs}")


def run_decode_role(args: argparse.Namespace,
                    cfg: Optional[ModelConfig] = None, **engine_kwargs):
    """``--role decode --connect HOST:PORT``: the decode worker of a
    two-process deployment.  It adopts handoffs until the prefill side
    says BYE; returns its engine.  ``engine_kwargs`` (no flag sets them)
    go to the engine: ``decode_kernel=True`` there."""
    from repro_torch.serve.transport import (ShmChannel, run_decode_worker,
                                             tcp_connect, tcp_connect_striped)
    model, params = build_model_params(args, cfg=cfg)
    host, _, port = args.connect.rpartition(":")
    host = host or "127.0.0.1"
    if args.wire_streams > 1:
        channel = tcp_connect_striped(host, int(port), args.wire_streams,
                                      bufsize=args.wire_bufsize)
    else:
        channel = tcp_connect(host, int(port), bufsize=args.wire_bufsize)
        if args.transport == "shm":
            channel = ShmChannel(channel)
    print(f"decode worker: connected to {args.connect} "
          f"({args.wire_streams} stream(s)"
          f"{', shm' if args.transport == 'shm' else ''})", flush=True)
    launches = kernel_launches()
    eng = run_decode_worker(
        model, params, channel, batch=args.batch, max_len=args.max_len,
        page_size=args.page_size, pages=args.pages,
        scheduler=decode_scheduler(args), spill=args.spill,
        quota=quota_from_cli(args.tenant_quota, args.page_codec),
        temperature=args.temperature, seed=args.seed + 1, **engine_kwargs)
    rep = eng.transfer.traffic_report()
    tq = rep["transfer"]
    wire = rep.get("kv_wire", {"wire_bytes": 0.0, "calls": 0})
    adopt = rep.get("kv_adopt", {"wire_bytes": 0.0, "calls": 0})
    print(f"decode worker done: adopted {tq['adopted_pages']} pages "
          f"({tq['published']} handoffs, {fmt_bytes(adopt['wire_bytes'])}"
          f"), sent {fmt_bytes(wire['wire_bytes'])} of result/ack frames; "
          f"{len(eng.finished)} sessions retired", flush=True)
    report = eng.traffic_report()
    if report.get("pages"):
        p = report["pages"]
        print(f"pages[{p['num_pages']}x{p['page_size']}]: "
              f"{p['evictions']} evicted, {p['refetches']} refetched, "
              f"{p['adoptions']} adopted", flush=True)
    print("kernel launches: " + ", ".join(
        f"{k}={n - launches[k]}" for k, n in kernel_launches().items()),
        flush=True)
    return eng


def drain_hook(args: argparse.Namespace, router):
    """The router's ``on_step``: drain ``--drain-engine`` once the router
    clock reaches ``--drain-after``."""
    state = {"done": False}

    def hook(_router) -> None:
        if (args.drain_after is not None and not state["done"]
                and router.now >= args.drain_after):
            state["done"] = True
            router.drain(args.drain_engine)
            print(f"drained engine {args.drain_engine} "
                  f"at step {router.now}", flush=True)

    return hook


#: seconds ``--listen`` waits for its decode worker to connect
ACCEPT_TIMEOUT = 300.0


def build_router_pairs(args: argparse.Namespace, model, params,
                       quota: Optional[QuotaManager], **engine_kwargs
                       ) -> list:
    """The router's ``--engines`` pairs: engine 0 the prefill half of a
    two-process wire (``--listen``; blocks until the decode worker
    attaches) or an in-process wire pair (``--transport``), the others
    loopback pairs; all share ``quota``.  ``engine_kwargs`` go to every
    in-process decode engine."""
    from repro_torch.serve.transport import (ShmChannel, build_wire_pair,
                                             build_wire_prefill, tcp_accept,
                                             tcp_accept_striped, tcp_listen)
    pair_kw = dict(batch=args.batch, max_len=args.max_len,
                   page_size=args.page_size, pages=args.pages,
                   scheduler=args.scheduler, spill=args.spill, quota=quota,
                   temperature=args.temperature)
    pairs = []
    for i in range(args.engines):
        if i == 0 and args.listen is not None:
            listener, port = tcp_listen(port=args.listen,
                                        backlog=args.wire_streams)
            # the port stays the line's last token: two-process callers
            # read it from here
            print(f"router: engine 0 [{args.wire_streams} stream(s)] "
                  f"listening on {port}", flush=True)
            if args.wire_streams > 1:
                channel = tcp_accept_striped(listener, args.wire_streams,
                                             timeout=ACCEPT_TIMEOUT,
                                             bufsize=args.wire_bufsize)
            else:
                channel = tcp_accept(listener, timeout=ACCEPT_TIMEOUT,
                                     bufsize=args.wire_bufsize)
                if args.transport == "shm":
                    channel = ShmChannel(channel)
            print("router: decode worker attached", flush=True)
            pairs.append(build_wire_prefill(
                model, params, channel, max_len=args.max_len,
                page_size=args.page_size, scheduler=args.scheduler,
                quota=quota, window_hint=2 * args.batch,
                temperature=args.temperature, seed=args.seed))
        elif i == 0 and args.transport is not None:
            pairs.append(build_wire_pair(
                model, params, transport=args.transport,
                streams=args.wire_streams, seed=args.seed,
                decode_scheduler=decode_scheduler(args), **pair_kw,
                **engine_kwargs))
        else:
            pairs.append(build_disagg(
                model, params, transfer=args.transfer_tier,
                max_depth=args.transfer_depth, seed=args.seed + 2 * i,
                decode_scheduler=decode_scheduler(args), **pair_kw,
                **engine_kwargs))
    return pairs


def federate_cli(args: argparse.Namespace, router):
    """The :class:`~repro_torch.serve.router.FederatedRouter` over
    ``router`` peered by ``--fed-listen`` (blocks until the peer
    connects) or ``--peer``; None without either flag."""
    from repro_torch.serve.router import FederatedRouter
    from repro_torch.serve.transport import (tcp_accept, tcp_connect,
                                             tcp_listen)
    if args.peer is None and args.fed_listen is None:
        return None
    fed = FederatedRouter(router)
    if args.fed_listen is not None:
        listener, port = tcp_listen(port=args.fed_listen)
        print(f"federation: listening on {port}", flush=True)
        fed.add_peer("peer", tcp_accept(listener, timeout=ACCEPT_TIMEOUT,
                                        bufsize=args.wire_bufsize))
    else:
        host, _, port = args.peer.rpartition(":")
        fed.add_peer("peer", tcp_connect(host or "127.0.0.1", int(port),
                                         bufsize=args.wire_bufsize))
    print(f"federation: peered ({fed.describe()})", flush=True)
    return fed


def run_router(args: argparse.Namespace, cfg: Optional[ModelConfig] = None,
               **engine_kwargs):
    """``--router``: the cluster front-end over ``--engines`` pairs serves
    the synthetic requests (or a ``--trace``) and prints the summary;
    returns the router, or with ``--peer`` / ``--fed-listen`` the
    federated router over it.  Raises if a session was dropped."""
    from repro_torch.serve.router import Router, replay_trace
    from repro_torch.sim.workloads import TrafficSpec, generate_traffic
    model, params = build_model_params(args, cfg=cfg)
    quota = quota_from_cli(args.tenant_quota, args.page_codec)
    pairs = build_router_pairs(args, model, params, quota, **engine_kwargs)
    router = Router(pairs, placement=args.placement)
    fed = federate_cli(args, router)
    driver = fed if fed is not None else router
    print(router.describe())
    print(f"model: {model.cfg.name} {model.cfg.num_layers}L "
          f"d_model={model.cfg.d_model} {model.cfg.dtype} on {model.device}")
    sync = torch.cuda.synchronize if model.device.type == "cuda" \
        else (lambda: None)
    first_token_at = {}
    launches = kernel_launches()
    try:
        sync()
        t0 = time.perf_counter()
        if args.trace:
            trace = generate_traffic(TrafficSpec(sessions=args.trace,
                                                 horizon_s=3600.0))
            done = replay_trace(router, trace, model.cfg.vocab_size,
                                arrivals_per_step=2.0,
                                on_step=drain_hook(args, router))
        else:
            submit_requests(driver, args, first_token_at,
                            vocab=model.cfg.vocab_size)
            done = driver.run(on_step=drain_hook(args, router))
        sync()
        dt = time.perf_counter() - t0
    finally:
        if fed is not None:
            print(fed.describe())
            fed.close()
            print(fed.wire_summary())
        for pair in pairs:
            if hasattr(pair, "close"):      # a wire pair: BYE the worker
                pair.close()
    total_new = sum(len(r.out_tokens) for r in done)
    dropped = sum(1 for s in router.sessions.values() if not s.done)
    print(f"router served {len(done)}/{len(router.sessions)} sessions, "
          f"{total_new} tokens in {dt:.2f}s ({total_new / dt:.1f} tok/s), "
          f"{dropped} dropped, {router.requeues} requeued")
    by_engine = {}
    for _, idx in router.placement_log:
        by_engine[idx] = by_engine.get(idx, 0) + 1
    print(f"placement[{args.placement}]: {by_engine}; "
          f"ttft(steps): {router.ttft_report()}")
    if first_token_at:
        ttft = sorted(t - t0 for t in first_token_at.values())
        print(f"ttft: mean {1e3 * sum(ttft) / len(ttft):.1f}ms, "
              f"max {1e3 * ttft[-1]:.1f}ms")
    if any(s.request.deadline is not None
           for s in router.sessions.values()):
        print("slo:", router.slo_report())
    for eng in router.engines:
        print(" ", eng.describe())
        sender = eng.pair.transfer
        print("   ", wire_summary(sender) if hasattr(sender, "channel")
              else transfer_summary(sender))
    if quota is not None:
        print("tenants:", dict(quota.usage()))
    print("kernel launches: " + ", ".join(
        f"{k}={n - launches[k]}" for k, n in kernel_launches().items()))
    if dropped:
        raise RuntimeError(f"{dropped} sessions dropped")
    return driver


if __name__ == "__main__":
    main()
