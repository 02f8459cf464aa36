"""Training loss curves from one set of weights: the reference against the
port on the CPU, or the port's kernel and plain paths against each other
on a GPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_train_curves.py \\
        --layers 4 --batch 8 --seq 1024 --steps 20 --lr 3e-3
    PYTHONPATH=src python tests/torch_train_curves.py --device cuda \\
        --layers 30 --batch 8 --seq 1024 --steps 20 --lr 3e-3
    PYTHONPATH=src python tests/torch_train_curves.py --device cuda \\
        --arch mamba2-370m --layers 48 --steps 10 --total-steps 10 --lr 3e-4

Every run takes the training CLI's schedule for a ``--total-steps`` run
(warmup a tenth of it, cosine decay) and the same synthetic stream
(``--seed``), at the configuration's full width with ``--layers`` of its
layers.  The runs:

* ``ref`` (CPU only): ``repro.train.loop.make_train_step`` under
  ``jax.jit``, from the reference's initialiser; its weights are carried
  over to every other run with ``repro_torch.convert.params_from_jax``.
  On one device (no mesh) the reference calls every layer bare, so no
  policy or codec changes its numbers.  On a GPU the weights come from
  the port's initialiser and JAX is not imported;
* ``port_plain`` (GPU only): ``--policy none``, attention and the SSD
  scan through their plain versions: no kernel runs;
* ``port``: ``--policy none``; on a GPU attention runs the flash kernel
  and the SSD scan its kernel;
* ``port_<policy>_<codec>``: every layer input stashed through the codec
  (``--policy host --compress fp8`` by default), through its kernels on a
  GPU.

The runs go one after another, each freed before the next starts.  Prints
one line a step of each run and a JSON summary with each curve and the
means of its first and last 5 steps (as ``chip_smoke.py`` reads the
card's curve).
"""
import argparse
import dataclasses
import gc
import json
import time

import numpy as np

from repro_torch import tree
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import MemoryPlan, RunConfig, TrainConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.kernels import ops as kops
from repro_torch.models.model import build_model
from repro_torch.train.loop import make_train_step
from repro_torch.train.train_state import init_state


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--total-steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--policy", default="host")
    ap.add_argument("--compress", default="fp8")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _train_cfgs(args, cls):
    return cls(total_steps=args.total_steps,
               warmup_steps=args.total_steps // 10,
               learning_rate=args.lr, seed=args.seed)


def _model(args, cfg, policy="none", codec="none"):
    tc = _train_cfgs(args, TrainConfig)
    model = build_model(RunConfig(
        model=cfg, shape=ShapeConfig("train", args.seq, args.batch, "train"),
        memory=MemoryPlan(policy=policy, compress=codec), train=tc),
        device=args.device)
    return model, tc


_T0 = [time.perf_counter()]


def _log(name, t, loss):
    now = time.perf_counter()
    print(f"{name} step {t + 1} loss={loss:.4f} ({now - _T0[0]:.1f} s)",
          flush=True)
    _T0[0] = now


def _reference(args, src):
    """The reference's curve and its initial weights (numpy)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as JARCHS
    from repro.configs import MemoryPlan as JMemoryPlan
    from repro.configs import MeshPlan as JMeshPlan
    from repro.configs import RunConfig as JRunConfig
    from repro.configs import TrainConfig as JTrainConfig
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.models.model import build_model as jbuild
    from repro.train.loop import make_train_step as jmake_train_step
    from repro.train.train_state import init_state as jinit_state

    jcfg = dataclasses.replace(JARCHS[args.arch], num_layers=args.layers,
                               dtype=args.dtype)
    jtc = _train_cfgs(args, JTrainConfig)
    jm = jbuild(JRunConfig(
        model=jcfg, shape=JShapeConfig("train", args.seq, args.batch,
                                       "train"),
        mesh=JMeshPlan((1,), ("data",)), memory=JMemoryPlan(policy="none"),
        train=jtc))
    jstate = jinit_state(jm, jtc)
    weights = jax.tree.map(np.asarray, jstate["params"])
    jstep = jax.jit(jmake_train_step(jm, jtc))
    curve = []
    for t in range(args.steps):
        jstate, met = jstep(jstate, {k: jnp.asarray(v)
                                     for k, v in src.batch_at(t).items()})
        curve.append(float(met["loss"]))
        _log("ref", t, curve[-1])
    del jstate, jstep
    jax.clear_caches()
    return weights, curve


def main(argv=None):
    args = parse_args(argv)
    tcfg = dataclasses.replace(TARCHS[args.arch], num_layers=args.layers,
                               dtype=args.dtype)
    src = SyntheticLM(tcfg, batch=args.batch, seq=args.seq, seed=args.seed)
    print(f"{tcfg.name} {args.layers} of {TARCHS[args.arch].num_layers} "
          f"layers, d_model {tcfg.d_model}, {args.dtype}, batch "
          f"{args.batch} x {args.seq}, lr {args.lr} over a "
          f"{args.total_steps}-step schedule, seed {args.seed}, on "
          f"{args.device}", flush=True)
    curves = {}
    stash = f"port_{args.policy}_{args.compress}"
    if args.device == "cpu":
        weights, curves["ref"] = _reference(args, src)
        gc.collect()
        runs = [("port", "torch", "none", "none"),
                (stash, "torch", args.policy, args.compress)]

        def start():
            return params_from_jax(weights, "cpu")
    else:
        init = _model(args, tcfg)[0].init(args.seed)
        runs = [("port_plain", "torch", "none", "none"),
                ("port", "cuda", "none", "none"),
                (stash, "cuda", args.policy, args.compress)]

        def start():
            return tree.map(lambda t: t.detach().clone(), init)
    for name, impl, policy, codec in runs:
        kops.set_flash_impl(impl)
        kops.set_ssd_impl(impl)
        model, tc = _model(args, tcfg, policy, codec)
        state = init_state(model, tc, params=start())
        step = make_train_step(model, tc)
        curves[name] = []
        for t in range(args.steps):
            state, met = step(state, to_device(src.batch_at(t),
                                               args.device))
            curves[name].append(float(met["loss"]))
            _log(name, t, curves[name][-1])
        del model, state, step
        gc.collect()
    k = min(5, args.steps // 2)
    print(json.dumps({n: {"losses": c, f"first_{k}_mean": float(
        np.mean(c[:k])), f"last_{k}_mean": float(np.mean(c[-k:]))}
        for n, c in curves.items()}))


if __name__ == "__main__":
    main()
