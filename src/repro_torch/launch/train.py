"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains on one device, ``--device cuda`` by default, under the memory-
overlaying runtime: with ``--policy host|mcdla|spill`` every layer's input
is stashed to that tier (through the ``--compress`` codec's kernels) and
the layer recomputed in backward.  Without ``--smoke`` the configuration
runs at its full published width with random weights from ``--seed``;
``--smoke`` takes its ``.reduced()`` twin at batch 4 x 128 tokens.  Each
step logs ``step N loss=... grad_norm=... lr=... (... ms)``; the run ends
with the ``memory traffic: ...`` line of the tier's stash/fetch bytes.

A run resumes from the newest valid snapshot in ``--ckpt-dir`` (the
reference's default, ``/tmp/repro_ckpt``, under ``$TMPDIR`` where that is
set: give each run its own) and saves every ``max(25, steps // 4)``
steps, or ``--ckpt-every`` through the checkpoint tier of ``--ckpt-tier``
(``--ckpt-codec``, ``--ckpt-async``, ``--ckpt-shards``); SIGTERM saves at
the next step boundary and exits.  ``--chaos`` injects kills,
preemptions, corrupt snapshots and stage losses
(``kill@3:2,corrupt@4,preempt@7`` or ``random:<seed>``); a recovery
rewinds the prefetched stream.  The reference's ``--pipeline*`` and
``--multi-pod`` flags wait for ROADMAP A8 / A9, the ``auto`` policy and
the planner-chosen cadence (``--ckpt-every 0`` with ``--ckpt-tier``, and
the ``--mtbf-steps`` it reads) for A12.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.configs import (MemoryPlan, RunConfig, SHAPES_BY_NAME,
                                 TrainConfig, get_arch)
from repro_torch.configs.base import (DEFAULT_CKPT_DIR, CheckpointPlan,
                                      ModelConfig, ShapeConfig)
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models.model import Model, build_model
from repro_torch.models.transformer import arch_group
from repro_torch.train.chaos import ChaosMonkey, ChaosSchedule
from repro_torch.train.elastic import ElasticController
from repro_torch.train.fault import FaultHandler
from repro_torch.train.loop import make_manager, train


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k",
                    help="shape cell for --batch / --seq defaults")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, batch 4 x 128 tokens by default")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the data stream")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--policy", default="mcdla",
                    help="memory tier of the stashed layer inputs: none | "
                         "host | mcdla | spill")
    ap.add_argument("--placement", default="bw_aware")
    ap.add_argument("--compress", default="none",
                    help="stash codec: none | fp8 | int8 | blocksparse")
    ap.add_argument("--opt-bits", type=int, default=32)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-tier", default="",
                    help="checkpoint through a tier stack: host | mcdla | "
                         "spill (empty: legacy direct writes)")
    ap.add_argument("--ckpt-codec", default="none",
                    help="snapshot codec: none | fp8 | int8 | blocksparse "
                         "(lossy codecs trade restore bit-exactness for "
                         "bytes)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint cadence in steps (0 with --ckpt-tier: "
                         "the planner's cadence, not ported yet)")
    ap.add_argument("--ckpt-async", action="store_true",
                    help="write, CRC and commit overlapping the next steps")
    ap.add_argument("--ckpt-shards", type=int, default=1)
    ap.add_argument("--mtbf-steps", type=int, default=None,
                    help="expected steps between failures (the cadence "
                         "planner's, not ported yet)")
    ap.add_argument("--chaos", default="",
                    help="fault-injection schedule, e.g. "
                         "'kill@3,corrupt@5,stage_loss@7:1,preempt@9', or "
                         "'random:<seed>' for a seeded random schedule")
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


def checkpoint_plan(args: argparse.Namespace) -> CheckpointPlan:
    """The run's :class:`CheckpointPlan` (disabled without --ckpt-tier)."""
    if args.mtbf_steps is not None:
        raise SystemExit(
            "--mtbf-steps feeds only the planner's Young-Daly cadence "
            "(--ckpt-tier with --ckpt-every 0), which needs plan_memory's "
            "analytic step time (ROADMAP A12)")
    ckpt = CheckpointPlan(enabled=bool(args.ckpt_tier),
                          tier=args.ckpt_tier or "host",
                          codec=args.ckpt_codec, every=args.ckpt_every,
                          async_saves=args.ckpt_async,
                          shards=args.ckpt_shards)
    if ckpt.enabled:
        ckpt.validate()
        if ckpt.every == 0:
            raise SystemExit(
                "--ckpt-tier with --ckpt-every 0 asks for the planner's "
                "Young-Daly cadence, which needs plan_memory's analytic "
                "step time (core/dag.py and core/policy.plan_memory, "
                "ROADMAP A12): give --ckpt-every N")
    return ckpt


def build_run(args: argparse.Namespace, dtype: Optional[str] = None,
              cfg: Optional[ModelConfig] = None
              ) -> Tuple[Model, TrainConfig, SyntheticLM]:
    """The model, its train config and its data stream for ``args``;
    ``dtype`` (e.g. "float32") overrides the configuration's.  ``cfg`` (no
    flag sets it) replaces ``--arch``'s configuration, e.g. one cut in
    depth with ``dataclasses.replace(cfg, num_layers=N)`` to fit a card."""
    if cfg is None:
        cfg = get_arch(args.arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if args.smoke:
        cfg = cfg.reduced()
        batch, seq = args.batch or 4, args.seq or 128
    else:
        sh = SHAPES_BY_NAME[args.shape]
        batch, seq = args.batch or sh.global_batch, args.seq or sh.seq_len
    tc = TrainConfig(total_steps=args.steps, warmup_steps=args.steps // 10,
                     learning_rate=args.lr, grad_accum=args.accum,
                     checkpoint_dir=args.ckpt_dir,
                     checkpoint_every=max(25, args.steps // 4),
                     log_every=args.log_every, seed=args.seed)
    memory = MemoryPlan(policy=args.policy, placement=args.placement,
                        compress=args.compress, opt_state_bits=args.opt_bits)
    run = RunConfig(model=cfg, shape=ShapeConfig("train", seq, batch,
                                                 "train"),
                    memory=memory, train=tc)
    model = build_model(run, device=args.device)
    return model, tc, SyntheticLM(cfg, batch=batch, seq=seq, seed=tc.seed)


def main(argv=None, cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Train and log; returns ``{"model", "tc", "source", "state",
    "history", "mgr", "chaos"}`` (history: the logged steps' metrics; mgr:
    the CheckpointManager; chaos: the ChaosMonkey or None) for callers
    that check the run.  ``cfg``: as :func:`build_run`'s (the command line
    never sets it).  SIGTERM / SIGINT handlers are installed for the run
    and restored after it."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(name)s %(message)s")
    ckpt = checkpoint_plan(args)
    model, tc, source = build_run(args, cfg=cfg)
    cfg = model.cfg
    group, n_groups = arch_group(cfg)
    stashed = n_groups if model.runtime.offloads else 0
    # an encoder-decoder's encoder layers are wrapped (stashed) too
    subs = stashed * len(group) + (cfg.encoder_layers if stashed else 0)
    print(f"model: {cfg.name} {cfg.num_layers}L d_model={cfg.d_model} "
          f"{cfg.dtype} on {model.device}; tier "
          f"{model.runtime.tier.describe()}, {stashed} of {n_groups} "
          f"layer groups stashed ({subs} sub-layers); "
          f"batch {source.batch} x {source.seq}", flush=True)
    chaos = None
    if args.chaos:
        if args.chaos.startswith("random:"):
            sched = ChaosSchedule.random(int(args.chaos.split(":", 1)[1]),
                                         args.steps)
        else:
            sched = ChaosSchedule.parse(args.chaos)
        chaos = ChaosMonkey(sched, seed=tc.seed)
        logging.getLogger(__name__).info("chaos schedule: %s", sched.spec())
    history: List[Dict[str, float]] = []
    hooks = {"on_log": lambda step, m: history.append(dict(m, step=step))}
    mgr = make_manager(model, tc, ckpt, chaos)
    elastic = None
    if chaos is not None:
        run = RunConfig(model=cfg, shape=ShapeConfig(
            "train", source.seq, source.batch, "train"),
            memory=model.memory, train=tc, ckpt=ckpt)
        elastic = ElasticController(run, mgr, device=model.device)
    data = Prefetcher(source, model.device)
    handler = FaultHandler()
    try:
        state, _ = train(model, tc, data, fault_handler=handler, hooks=hooks,
                         ckpt=ckpt, chaos=chaos, elastic=elastic, mgr=mgr)
    finally:
        data.close()
        handler.uninstall()
    return {"model": model, "tc": tc, "source": source, "state": state,
            "history": history, "mgr": mgr, "chaos": chaos}


if __name__ == "__main__":
    main()
