"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains on one device, ``--device cuda`` by default, under the memory-
overlaying runtime: with ``--policy host|mcdla|spill`` every layer's input
is stashed to that tier (through the ``--compress`` codec's kernels) and
the layer recomputed in backward; with ``--policy auto`` the KEEP / POOL /
RECOMPUTE planner (core/policy.py) chooses how many layer groups to stash
under the card's HBM budget and the run logs its plan (``plan: ...``).
Without ``--smoke`` the configuration runs at its full published width
with random weights from ``--seed``;
``--smoke`` takes its ``.reduced()`` twin at batch 4 x 128 tokens.  Each
step logs ``step N loss=... grad_norm=... lr=... (... ms)``; the run ends
with the ``memory traffic: ...`` line of the tier's stash/fetch bytes.

A run resumes from the newest valid snapshot in ``--ckpt-dir`` (the
reference's default, ``/tmp/repro_ckpt``, under ``$TMPDIR`` where that is
set: give each run its own) and saves every ``max(25, steps // 4)``
steps, or ``--ckpt-every`` through the checkpoint tier of ``--ckpt-tier``
(``--ckpt-codec``, ``--ckpt-async``, ``--ckpt-shards``); with ``--ckpt-every
0`` the planner picks the cadence (Young-Daly against its modelled step
time and ``--mtbf-steps``) and logs it (``checkpoint plan: every=K
...``).  SIGTERM saves at the next step boundary and exits.  ``--chaos``
injects kills, preemptions, corrupt snapshots and stage losses
(``kill@3:2,corrupt@4,preempt@7`` or ``random:<seed>``); a recovery
rewinds the prefetched stream.  The reference's ``--pipeline*`` flags
wait for ROADMAP A9.

Under ``torchrun`` (``WORLD_SIZE`` > 1) the run trains on a ``("data",
"model")`` DeviceMesh of the world's ranks, the reference's
``MeshPlan((2, n // 2), ("data", "model"))`` (the production mesh for a
full-size run over 256 ranks), each rank holding the shards of the state
its specs name and its rows of every batch (``models/model.py``); the
``mcdla`` tier keeps each rank's slice of a stash and gathers it back
over the pool's ranks.  ``--dist-backend`` picks the process group's
backend (nccl for a card, gloo for the CPU by default; ranks that share
one card need gloo, which stages the card's tensors through pinned host
memory) and the run prints it beside the mesh.  Only rank 0 logs.  The
``--ckpt-*`` flags and ``--chaos`` refuse a mesh (ROADMAP A8b), as do
the MoE family (A9), the encoder-decoder and the VLM (A8b).
``--multi-pod`` asks for the (2, 16, 16) production mesh and exits
unless the world has its 512 ranks.  ``--grad-compress int8`` keeps the
error-feedback residual in the state (ROADMAP C16: the step carries it
unchanged, as the reference's does).

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --arch smollm --smoke --device cpu \
        --policy mcdla --compress fp8 --steps 3
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import hw
from repro_torch.configs import (MemoryPlan, RunConfig, SHAPES_BY_NAME,
                                 TrainConfig, get_arch)
from repro_torch.configs.base import (DEFAULT_CKPT_DIR, CheckpointPlan,
                                      ModelConfig, ShapeConfig)
from repro_torch.core.dag import build_dag
from repro_torch.core.policy import MemoryPlanReport, plan_memory, summarize
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch import mesh as mesh_mod
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
                         "host | mcdla | spill | auto (the planner's split)")
    ap.add_argument("--placement", default="bw_aware")
    ap.add_argument("--compress", default="none",
                    help="stash codec: none | fp8 | int8 | blocksparse")
    ap.add_argument("--opt-bits", type=int, default=32)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-compress", default="none",
                    choices=("none", "int8"),
                    help="int8: keep the error-feedback residual of the "
                         "compressed all-reduce in the state")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) production mesh (512 ranks)")
    ap.add_argument("--dist-backend", default="", choices=("", "nccl", "gloo"),
                    help="process group backend under torchrun (default: "
                         "nccl on cuda, gloo on cpu)")
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
                         "the planner's Young-Daly cadence)")
    ap.add_argument("--ckpt-async", action="store_true",
                    help="write, CRC and commit overlapping the next steps")
    ap.add_argument("--ckpt-shards", type=int, default=1)
    ap.add_argument("--mtbf-steps", type=int, default=10_000,
                    help="expected steps between failures (the cadence "
                         "planner's)")
    ap.add_argument("--chaos", default="",
                    help="fault-injection schedule, e.g. "
                         "'kill@3,corrupt@5,stage_loss@7:1,preempt@9', or "
                         "'random:<seed>' for a seeded random schedule")
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


def checkpoint_plan(args: argparse.Namespace) -> CheckpointPlan:
    """The run's :class:`CheckpointPlan` (disabled without --ckpt-tier;
    ``every`` 0 until :func:`plan_cadence` resolves it)."""
    ckpt = CheckpointPlan(enabled=bool(args.ckpt_tier),
                          tier=args.ckpt_tier or "host",
                          codec=args.ckpt_codec, every=args.ckpt_every,
                          async_saves=args.ckpt_async,
                          shards=args.ckpt_shards,
                          mtbf_steps=args.mtbf_steps)
    if ckpt.enabled:
        ckpt.validate()
    return ckpt


def plan_cadence(model: Model, shape: ShapeConfig, ckpt: CheckpointPlan,
                 chip: hw.Chip = hw.H100
                 ) -> Tuple[CheckpointPlan, MemoryPlanReport]:
    """The planner's save cadence for ``--ckpt-every 0``: a Young-Daly
    sweep against the modelled step time of ``model`` at ``shape`` through
    the checkpoint tier stack (the reference's ``launch/train.py``
    arithmetic, its optimizer-state bytes included).  Returns the plan
    with ``every`` set and the planner's report."""
    cfg, memory = model.cfg, model.memory
    opt_bytes = 4 + 2 * memory.opt_state_bits // 8
    report = plan_memory(build_dag(cfg, shape), model.plan, memory, chip=chip,
                         model_state_bytes=cfg.param_count() * opt_bytes,
                         checkpoint=ckpt)
    return dataclasses.replace(ckpt, every=report.checkpoint.every), report


def build_run(args: argparse.Namespace, dtype: Optional[str] = None,
              cfg: Optional[ModelConfig] = None, mesh=None, plan=None,
              device=None) -> Tuple[Model, TrainConfig, SyntheticLM]:
    """The model, its train config and its data stream for ``args``;
    ``dtype`` (e.g. "float32") overrides the configuration's.  ``cfg`` (no
    flag sets it) replaces ``--arch``'s configuration, e.g. one cut in
    depth with ``dataclasses.replace(cfg, num_layers=N)`` to fit a card.
    ``mesh`` / ``plan``: the DeviceMesh and MeshPlan of a sharded run,
    ``device`` its rank's (``--device`` by default); the stream yields
    global batches."""
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
                     log_every=args.log_every, seed=args.seed,
                     grad_compress=args.grad_compress)
    memory = MemoryPlan(policy=args.policy, placement=args.placement,
                        compress=args.compress, opt_state_bits=args.opt_bits)
    run = RunConfig(model=cfg, shape=ShapeConfig("train", seq, batch,
                                                 "train"),
                    memory=memory, train=tc,
                    **({} if plan is None else dict(mesh=plan)))
    model = build_model(run, device=device or args.device, mesh=mesh)
    return model, tc, SyntheticLM(cfg, batch=batch, seq=seq, seed=tc.seed)


def setup_mesh(args: argparse.Namespace):
    """``(mesh, plan, device, backend)`` of a run under ``torchrun``
    (``WORLD_SIZE`` > 1), after joining its process group; ``(None, None,
    None, "")`` for one process.  Exits for what a mesh refuses."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.multi_pod and world != 512:
        raise SystemExit(
            f"--multi-pod trains on the (2, 16, 16) production mesh of 512 "
            f"ranks; this run has {world}: runs on the production mesh port "
            "with ROADMAP A8b")
    if world == 1:
        return None, None, None, ""
    if args.ckpt_tier or args.ckpt_every or args.ckpt_async or \
            args.ckpt_shards != 1 or args.ckpt_codec != "none" or \
            args.ckpt_dir != DEFAULT_CKPT_DIR or args.chaos:
        raise SystemExit("--ckpt-* and --chaos on a mesh: checkpoints of a "
                         "sharded state port with ROADMAP A8b")
    _, world, device, backend = mesh_mod.init_distributed(
        args.dist_backend, args.device)
    if args.multi_pod or (not args.smoke and world >= 256):
        return (mesh_mod.make_production_mesh(multi_pod=args.multi_pod),
                mesh_mod.plan_for(multi_pod=args.multi_pod), device,
                backend)
    return (mesh_mod.make_host_mesh(world), mesh_mod.host_plan(world),
            device, backend)


def main(argv=None, cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Train and log; returns ``{"model", "tc", "source", "state",
    "history", "mgr", "chaos", "ckpt"}`` (history: the logged steps'
    metrics; mgr: the CheckpointManager, None on a mesh; chaos: the
    ChaosMonkey or None; ckpt: the CheckpointPlan in effect, its planned
    cadence in ``every``) for callers that check the run.  ``cfg``: as
    :func:`build_run`'s (the command line never sets it).  SIGTERM /
    SIGINT handlers are installed for the run and restored after it.
    Under ``torchrun`` the process group is left to the caller's process
    to end (it ends with it)."""
    args = parse_args(argv)
    rank = int(os.environ.get("RANK", "0"))
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        stream=sys.stdout,
                        format="%(asctime)s %(name)s %(message)s")
    ckpt = checkpoint_plan(args)
    mesh, plan, device, backend = setup_mesh(args)
    model, tc, source = build_run(args, cfg=cfg, mesh=mesh, plan=plan,
                                  device=device)
    cfg = model.cfg
    log = logging.getLogger(__name__)
    if mesh is not None and rank == 0:
        staged = " (the card's tensors staged through pinned host memory)" \
            if backend == "gloo" and model.device.type == "cuda" else ""
        print(f"mesh: {plan.shape} over {plan.axes}, "
              f"{model.mesh.size()} ranks; backend {backend}{staged}; "
              f"batch rows over {model.planner.axes.batch}", flush=True)
    group, n_groups = arch_group(cfg)
    stashed = model.stash_groups
    # an encoder-decoder's encoder layers are wrapped (stashed) too
    subs = stashed * len(group) + (cfg.encoder_layers
                                   if model.runtime.offloads else 0)
    if rank == 0:
        print(f"model: {cfg.name} {cfg.num_layers}L d_model={cfg.d_model} "
              f"{cfg.dtype} on {model.device}; tier "
              f"{model.runtime.tier.describe()}, {stashed} of {n_groups} "
              f"layer groups stashed ({subs} sub-layers); "
              f"batch {source.batch} x {source.seq}", flush=True)
    shape = ShapeConfig("train", source.seq, source.batch, "train")
    if args.policy == "auto":
        log.info("plan: %s", summarize(model.runtime.plan_report(
            build_dag(cfg, shape),
            model_state_bytes=model.runtime.model_state_bytes(cfg))))
    if ckpt.enabled and ckpt.every == 0:
        ckpt, report = plan_cadence(model, shape, ckpt)
        c = report.checkpoint
        log.info("checkpoint plan: every=%d steps (save=%.2fs overhead="
                 "%.2fms/step lost=%.2fms/step via %s)", c.every, c.save_s,
                 1e3 * c.overhead_s, 1e3 * c.lost_s, c.tier)
    chaos = None
    if args.chaos:
        if args.chaos.startswith("random:"):
            sched = ChaosSchedule.random(int(args.chaos.split(":", 1)[1]),
                                         args.steps)
        else:
            sched = ChaosSchedule.parse(args.chaos)
        chaos = ChaosMonkey(sched, seed=tc.seed)
        log.info("chaos schedule: %s", sched.spec())
    history: List[Dict[str, float]] = []
    hooks = {"on_log": lambda step, m: history.append(dict(m, step=step))}
    mgr = make_manager(model, tc, ckpt, chaos) if mesh is None else None
    elastic = None
    if chaos is not None:
        run = RunConfig(model=cfg, shape=shape, memory=model.memory,
                        train=tc, ckpt=ckpt)
        elastic = ElasticController(run, mgr, device=model.device)
    data = Prefetcher(source, model.device)
    handler = FaultHandler()
    try:
        state, _ = train(model, tc, data, fault_handler=handler, hooks=hooks,
                         ckpt=ckpt, chaos=chaos, elastic=elastic, mgr=mgr)
    finally:
        data.close()
        handler.uninstall()
    if mesh is not None and rank == 0 and model.runtime.offloads:
        print(f"pool traffic per rank: {model.runtime.traffic_summary()}",
              flush=True)
    return {"model": model, "tc": tc, "source": source, "state": state,
            "history": history, "mgr": mgr, "chaos": chaos, "ckpt": ckpt}


if __name__ == "__main__":
    try:
        main()
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
