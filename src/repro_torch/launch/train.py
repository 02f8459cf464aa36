"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains on one device, ``--device cuda`` by default, under the memory-
overlaying runtime: with ``--policy host|mcdla|spill`` every layer's input
is stashed to that tier (through the ``--compress`` codec's kernels) and
the layer recomputed in backward.  Without ``--smoke`` the configuration
runs at its full published width with random weights from ``--seed``;
``--smoke`` takes its ``.reduced()`` twin at batch 4 x 128 tokens.  Each
step logs ``step N loss=... grad_norm=... lr=... (... ms)``; the run ends
with the ``memory traffic: ...`` line of the tier's stash/fetch bytes.

The reference's ``--ckpt-*``, ``--chaos``, ``--pipeline*`` and
``--multi-pod`` flags port with slice 4, the ``auto`` policy with slice 5.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.configs import (MemoryPlan, RunConfig, SHAPES_BY_NAME,
                                 TrainConfig, get_arch)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models.model import Model, build_model
from repro_torch.models.transformer import arch_group
from repro_torch.train.loop import train


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
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


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
    "history"}`` (history: the logged steps' metrics) for callers that
    check the run.  ``cfg``: as :func:`build_run`'s (the command line
    never sets it)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(name)s %(message)s")
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
    history: List[Dict[str, float]] = []
    data = Prefetcher(source, model.device)
    try:
        state, _ = train(model, tc, iter(data),
                         hooks={"on_log": lambda step, m: history.append(
                             dict(m, step=step))})
    finally:
        data.close()
    return {"model": model, "tc": tc, "source": source, "state": state,
            "history": history}


if __name__ == "__main__":
    main()
