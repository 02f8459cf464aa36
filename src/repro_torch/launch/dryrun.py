"""The dry-run on a fake card: reckon one step without running it.

For every (architecture x input shape) cell it builds the model, the train
state and the batch (or the params and caches of a prefill / decode) under
``torch._subclasses.fake_tensor.FakeTensorMode`` on a fake device (the
card by default: nothing is allocated and nothing launches), runs one
``make_train_step`` step (or ``Model.prefill``, or ``Model.decode_step``)
and reports the reference's keys:

* ``arg_bytes_per_dev`` — the state (or the params and caches) plus the
  batch;
* ``temp_bytes_per_dev`` — the peak of live device storage during the
  step, less the args (:class:`StepTracker`: a weak reference on every
  op output's storage); ``host_bytes_per_dev`` the peak of live storage
  on the host's side (the host tier's pinned copies) apart;
* ``flops_per_dev`` — ``torch.utils.flop_counter.FlopCounterMode`` plus
  the hand-written kernels' own counts (``kernels/fake.py``: a kernel
  wrapper given FakeTensors on the card allocates its outputs and
  reports its work instead of launching, so the step traced is the one
  the card runs, not the plain versions');
* ``bytes_accessed_per_dev`` — every aten op's inputs and outputs
  (views and bare allocations move nothing) plus the kernels': unfused,
  so an upper bound, as the reference's note says of XLA's count;
* ``collective_wire_bytes_per_dev`` — 0: the mesh is one device.  The
  per-kind ring formulas of the reference's HLO parser are kept as
  :func:`ring_wire_bytes` for the multi-device dry-run (ROADMAP A8b);
* ``tier`` and ``traffic`` — ``MemoryRuntime.traffic_report``.

Every figure is counted or modelled from shapes; nothing is timed.  An
eager trace counts every layer, so the reference's loop probes
(``probe_scaled``) have no counterpart; ``probes`` / ``--no-probes`` are
accepted and change nothing.  ``multi_pod`` and a production mesh raise
naming ROADMAP A8b, ``pipeline_cell`` naming A9.

    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Union

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import hw
from repro_torch.configs import (ARCHS, MemoryPlan, RunConfig, SHAPES_BY_NAME,
                                 ShapeConfig, TrainConfig, get_arch)
from repro_torch.configs.registry import cells_for
from repro_torch.launch.mesh import plan_for
from repro_torch.models import frontends
from repro_torch.models import transformer as tfm
from repro_torch.models.model import SINGLE_DEVICE, build_model

MESH = "1"


# ---------------------------------------------------------------------------
def ring_wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Per-device wire bytes of one collective on a ring of ``n`` devices
    whose result is ``result_bytes`` (the reference's ``parse_collectives``
    formulas, one record at a time)."""
    if kind == "all-gather":
        return (n - 1) / n * result_bytes          # result = gathered
    if kind == "all-reduce":
        return 2 * (n - 1) / n * result_bytes
    if kind == "reduce-scatter":
        return (n - 1) * result_bytes              # result = scattered shard
    if kind == "all-to-all":
        return (n - 1) / n * result_bytes
    if kind == "collective-permute":
        return result_bytes
    raise ValueError(f"unknown collective {kind!r}")


# ---------------------------------------------------------------------------
def _mutates(func) -> bool:
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


def _moves_nothing(func) -> bool:
    """A bare allocation, or a constant lifted into the trace."""
    name = func._schema.name.split("::")[-1]
    return name.startswith(("empty", "new_empty", "lift_fresh"))


def _tensor_bytes(t: torch.Tensor) -> float:
    return float(t.numel()) * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class StepTracker(TorchDispatchMode):
    """Live storage, op traffic and kernel work of the code run under it.

    Every op output's untyped storage is held by a weak reference
    (``StorageWeakRef``), on the ``device``'s side or the host's; the
    live bytes of each side are summed after every op and their peaks
    kept.  A sum that counts storages already freed is an upper bound, so
    the expired references are swept only when it passes the peak.
    ``bytes_accessed`` sums, over every aten op, the bytes of its inputs
    and outputs on the device's side, an output that shares an input's
    storage only where the op writes it: a view, a bare allocation and a
    host-side copy move no device bytes.  Kernel wrappers given
    FakeTensors report their launches through :meth:`record_kernel`."""

    def __init__(self, device):
        super().__init__()
        self.device_type = torch.device(device).type
        self._live: Dict[int, tuple] = {}
        self._total = [0.0, 0.0]          # device, host (may count dead)
        self.peak = [0.0, 0.0]
        self.bytes_accessed = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}

    def note(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live (once per storage)."""
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        held = self._live.get(ref.cdata)
        if held is not None and not held[0].expired():
            return
        side = 0 if t.device.type == self.device_type else 1
        nbytes = float(st.nbytes())
        self._live[ref.cdata] = (ref, nbytes, side)
        self._total[side] += nbytes

    def live_bytes(self) -> list:
        """Exact live bytes of each side (sweeps expired references)."""
        total = [0.0, 0.0]
        for key, (ref, nbytes, side) in list(self._live.items()):
            if ref.expired():
                del self._live[key]
            else:
                total[side] += nbytes
        self._total = total
        return total

    def _update_peak(self) -> None:
        if any(t > p for t, p in zip(self._total, self.peak)):
            self.live_bytes()
            self.peak = [max(t, p) for t, p in zip(self._total, self.peak)]

    def start(self, tensors) -> float:
        """Count ``tensors`` (the step's args) live; returns their bytes
        on the device's side."""
        for t in tensors:
            self.note(t)
        self._update_peak()
        return self.live_bytes()[0]

    def record_kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.note(t)
        if func.namespace == "aten" and not _moves_nothing(func):
            self.bytes_accessed += self._traffic(func, args, kwargs, outs)
        self._update_peak()
        return out

    def _traffic(self, func, args, kwargs, outs) -> float:
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        read = {_storage_key(t) for t in ins}
        written = outs if _mutates(func) else [
            t for t in outs if _storage_key(t) not in read]
        if outs and not written:
            return 0.0                      # a view: nothing moves
        return sum(_tensor_bytes(t) for t in ins + written
                   if t.device.type == self.device_type)


def trace_step(fn: Callable[[], Any], args, device) -> Dict[str, Any]:
    """Run ``fn()`` under a :class:`StepTracker` and a
    ``FlopCounterMode``; ``args`` are the tensors (a tree) live before it.
    Returns the counts and ``fn``'s output."""
    from torch.utils.flop_counter import FlopCounterMode
    tracker = StepTracker(device)
    arg_bytes = tracker.start([t for t in tree_leaves(args)
                               if isinstance(t, torch.Tensor)])
    flops = FlopCounterMode(display=False)
    t0 = time.time()
    with flops, tracker:
        out = fn()
    kflops = sum(k["flops"] for k in tracker.kernels.values())
    kbytes = sum(k["bytes"] for k in tracker.kernels.values())
    return {
        "out": out, "seconds": time.time() - t0,
        "arg_bytes": arg_bytes,
        "temp_bytes": tracker.peak[0] - arg_bytes,
        "host_bytes": tracker.peak[1],
        "flops": float(flops.get_total_flops()) + kflops,
        "bytes_accessed": tracker.bytes_accessed + kbytes,
        "kernels": tracker.kernels,
    }


# ---------------------------------------------------------------------------
def input_specs(model, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The batch of a cell (the reference's ``Model.input_specs``): int32
    tokens and positions, frames / patches in the model's dtype; a decode
    step's one token and its cache ``index``."""
    cfg, dev = model.cfg, model.device
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def pos(n):
        p = torch.zeros((B, n), dtype=i32, device=dev)
        return p.expand(3, B, n).clone() if cfg.mrope_sections else p

    if shape.mode in ("train", "prefill"):
        d = {"tokens": torch.zeros((B, S), dtype=i32, device=dev),
             "positions": pos(S)}
        if shape.mode == "train":
            d["labels"] = torch.zeros((B, S), dtype=i32, device=dev)
        if cfg.frontend == "audio_stub":
            d["frames"] = torch.zeros(
                (B, cfg.frontend_tokens, frontends.AUDIO_FRAME_DIM),
                dtype=model.dtype, device=dev)
        if cfg.frontend == "vision_stub":
            d["patches"] = torch.zeros(
                (B, cfg.frontend_tokens, frontends.VISION_PATCH_DIM),
                dtype=model.dtype, device=dev)
        return d
    return {"token": torch.zeros((B, 1), dtype=i32, device=dev),
            "positions": pos(1),
            "index": torch.zeros((), dtype=i32, device=dev)}


def _shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape


def lower_cell(arch: str, shape: Union[str, ShapeConfig], *,
               multi_pod: bool = False, policy: str = "mcdla",
               placement: str = "bw_aware", compress: str = "none",
               opt_bits: int = 32, accum: int = 1, seq_parallel: bool = True,
               stash_aux: bool = True, probes: bool = True, mesh=None,
               device="cuda", cfg=None) -> Dict:
    """Trace one cell on the fake ``device``: ``shape`` a registry name or
    a :class:`ShapeConfig` (one that fits a card, to hold the count
    against a real step); ``cfg`` a configuration other than the
    registry's (a cut depth).  The mesh is one device."""
    if multi_pod or mesh is not None:
        raise NotImplementedError(
            "the dry-run runs on one device (mesh '1'): the production "
            "mesh and its collectives port with ROADMAP A8b")
    cfg = cfg if cfg is not None else get_arch(arch)
    res = _lower_one(cfg, _shape(shape), policy=policy, placement=placement,
                     compress=compress, opt_bits=opt_bits, accum=accum,
                     seq_parallel=seq_parallel, stash_aux=stash_aux,
                     device=device)
    res.update({"arch": cfg.name, "raw_flops_per_dev": res["flops_per_dev"],
                "raw_collective_wire_bytes_per_dev":
                    res["collective_wire_bytes_per_dev"]})
    return res


def _lower_one(cfg, shape: ShapeConfig, *, policy: str, placement: str,
               compress: str, opt_bits: int, accum: int, seq_parallel: bool,
               device, stash_aux: bool = True) -> Dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.train_state import init_state

    memory = MemoryPlan(policy=policy, placement=placement,
                        compress=compress, opt_state_bits=opt_bits,
                        seq_parallel=seq_parallel, stash_aux=stash_aux)
    tc = TrainConfig(grad_accum=accum)
    run = RunConfig(model=cfg, shape=shape, mesh=SINGLE_DEVICE,
                    memory=memory, train=tc)
    t0 = time.time()
    with FakeTensorMode():
        model = build_model(run, device=device)
        model.runtime.reset_traffic()
        batch = input_specs(model, shape)
        params = tfm.init_params(None, cfg, model.dtype, model.device)
        if shape.mode == "train":
            state = init_state(model, tc, params=params)
            step = make_train_step(model, tc)
            args = (state, batch)
            t_build = time.time() - t0
            got = trace_step(lambda: step(state, batch), args, device)
        else:
            caches = model.init_cache(shape.global_batch, shape.seq_len)
            args = (params, caches, batch)
            t_build = time.time() - t0
            if shape.mode == "prefill":
                got = trace_step(lambda: model.prefill(params, batch, caches),
                                 args, device)
            else:
                got = trace_step(lambda: model.decode_step(
                    params, batch["token"], batch["positions"], caches,
                    shape.seq_len - 1), args, device)
        out_bytes = _storage_bytes(got["out"])
    traffic = model.runtime.traffic_report()
    return {
        "shape": shape.name, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch, "mode": shape.mode,
        "mesh": MESH, "device": str(model.device),
        "policy": policy, "placement": placement, "compress": compress,
        "opt_bits": opt_bits, "accum": accum, "ok": True,
        "stash_groups": model.stash_groups,
        "lower_s": round(t_build, 1),
        "compile_s": round(t_build + got["seconds"], 1),
        "arg_bytes_per_dev": got["arg_bytes"],
        "temp_bytes_per_dev": got["temp_bytes"],
        "host_bytes_per_dev": got["host_bytes"],
        "out_bytes_per_dev": out_bytes,
        "flops_per_dev": got["flops"],
        "bytes_accessed_per_dev": got["bytes_accessed"],
        "kernels": got["kernels"],
        "collectives": {},
        "collective_wire_bytes_per_dev": 0.0,
        "tier": traffic["tier"],
        "traffic": traffic,
    }


def _storage_bytes(out) -> float:
    seen, total = set(), 0.0
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor):
            key = StorageWeakRef(t.untyped_storage()).cdata
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


# ---------------------------------------------------------------------------
def pipeline_cell(arch: str, shape_name: str, *, multi_pod: bool,
                  policy: str, placement: str, compress: str, opt_bits: int,
                  pipeline) -> Dict:
    """The reference's analytic stage-tier report: the pipeline schedules,
    their stage tier and ``plan_memory``'s pipelined branch port with
    ROADMAP A9."""
    raise NotImplementedError(
        "pipeline_cell: the pipeline schedules and the planner's n_micro "
        "sweep port with ROADMAP A9")


def checkpoint_cell(arch: str, shape_name: str, *, multi_pod: bool,
                    policy: str, placement: str, compress: str,
                    opt_bits: int, ckpt, chip: hw.Chip = hw.H100,
                    plan=None) -> Dict:
    """Analytic checkpoint-traffic report for one cell: the Young-Daly
    cadence verdict through the configured CheckpointTier stack plus the
    per-snapshot wire bytes the backing store absorbs (pure tier
    arithmetic on ``chip``; the metered path is train/checkpoint.py).
    ``plan``: the mesh plan priced, the reference's production plan by
    default."""
    from repro_torch.core.dag import build_dag
    from repro_torch.core.policy import plan_memory

    cfg = get_arch(arch)
    shape = _shape(shape_name)
    plan = plan if plan is not None else plan_for(multi_pod=multi_pod)
    memory = MemoryPlan(policy=policy, placement=placement,
                        compress=compress, opt_state_bits=opt_bits)
    opt_bytes = 4 + 2 * opt_bits // 8
    report = plan_memory(build_dag(cfg, shape), plan, memory, chip=chip,
                         model_state_bytes=cfg.param_count() * opt_bytes,
                         checkpoint=ckpt)
    d = report.checkpoint
    return {
        "tier": d.tier, "every": d.every,
        "snapshot_bytes": d.snapshot_bytes,
        "save_s": d.save_s,
        "overhead_s_per_step": d.overhead_s,
        "lost_s_per_step": d.lost_s,
        "async": d.async_saves,
        "ckpt_wire_bytes_per_step": d.snapshot_bytes / max(d.every, 1),
    }


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--policy", default="mcdla",
                    choices=["none", "host", "mcdla", "auto"])
    ap.add_argument("--placement", default="bw_aware",
                    choices=["bw_aware", "local"])
    ap.add_argument("--compress", default="none", choices=["none", "fp8"])
    ap.add_argument("--opt-bits", type=int, default=32, choices=[32, 8])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--pipeline", action="store_true",
                    help="the analytic pipeline stage-tier report "
                         "(ROADMAP A9: refused)")
    ap.add_argument("--pipeline-schedule", default="1f1b")
    ap.add_argument("--pipeline-stages", type=int, default=2)
    ap.add_argument("--n-micro", type=int, default=0)
    ap.add_argument("--ckpt", action="store_true",
                    help="attach the analytic checkpoint-traffic report "
                         "(Young-Daly cadence + snapshot bytes)")
    ap.add_argument("--ckpt-tier", default="host")
    ap.add_argument("--ckpt-codec", default="none")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-async", action="store_true")
    ap.add_argument("--mtbf-steps", type=int, default=10_000)
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="accepted for the reference's command lines: an "
                         "eager trace counts every layer, there are no "
                         "probes")
    ap.add_argument("--device", default="cuda",
                    help="the fake device the step is traced on (cuda, cpu)")
    ap.add_argument("--out", default="")
    ap.add_argument("--include-skipped", action="store_true")
    args = ap.parse_args(argv)

    if args.multi_pod:
        ap.error("--multi-pod: the dry-run runs on one device; the "
                 "production mesh ports with ROADMAP A8b")
    if args.pipeline:
        ap.error("--pipeline: the pipeline schedules and their stage tier "
                 "port with ROADMAP A9")
    archs = sorted(ARCHS) if args.arch == "all" else [get_arch(args.arch)
                                                      .name]
    results = []
    for arch in archs:
        for cfg, shape, status in cells_for(get_arch(arch)):
            if args.shape != "all" and shape.name != args.shape:
                continue
            if status != "run" and not args.include_skipped:
                results.append({"arch": arch, "shape": shape.name,
                                "mesh": MESH, "ok": None, "skip": status})
                print(f"[skip] {arch} x {shape.name}: {status}")
                continue
            tag = f"{arch} x {shape.name} x {MESH}"
            try:
                r = lower_cell(arch, shape.name, policy=args.policy,
                               placement=args.placement,
                               compress=args.compress, accum=args.accum,
                               seq_parallel=not args.no_seq_parallel,
                               probes=not args.no_probes,
                               opt_bits=args.opt_bits, device=args.device)
                if args.ckpt and shape.mode == "train":
                    from repro_torch.configs.base import CheckpointPlan
                    r["checkpoint"] = checkpoint_cell(
                        arch, shape.name, multi_pod=False,
                        policy=args.policy, placement=args.placement,
                        compress=args.compress, opt_bits=args.opt_bits,
                        plan=SINGLE_DEVICE,
                        ckpt=CheckpointPlan(
                            enabled=True, tier=args.ckpt_tier,
                            codec=args.ckpt_codec, every=args.ckpt_every,
                            async_saves=args.ckpt_async,
                            mtbf_steps=args.mtbf_steps))
                results.append(r)
                tr = r.get("traffic", {})
                print(f"[ok]   {tag}: trace={r['compile_s']}s "
                      f"args={r['arg_bytes_per_dev']/1e9:.2f}GB "
                      f"temp={r['temp_bytes_per_dev']/1e9:.2f}GB "
                      f"host={r['host_bytes_per_dev']/1e9:.2f}GB "
                      f"flops/dev={r['flops_per_dev']:.3e} "
                      f"bytes/dev={r['bytes_accessed_per_dev']:.3e} "
                      f"tier[{tr.get('tier', '?')}]="
                      f"{tr.get('wire_bytes_total', 0.0)/1e9:.3f}GB/step")
                if "checkpoint" in r:
                    c = r["checkpoint"]
                    print(f"       checkpoint[{c['tier']}]: "
                          f"every={c['every']} "
                          f"snap={c['snapshot_bytes']/1e9:.3f}GB "
                          f"save={c['save_s']:.2f}s "
                          f"overhead={c['overhead_s_per_step']*1e3:.2f}ms"
                          f"/step lost={c['lost_s_per_step']*1e3:.2f}ms"
                          f"/step{' async' if c['async'] else ''}")
            except Exception as e:  # noqa: BLE001 — a failed cell is a bug
                results.append({"arch": arch, "shape": shape.name,
                                "mesh": MESH, "ok": False,
                                "error": f"{type(e).__name__}: {e}"})
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
                traceback.print_exc()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    failed = [r for r in results if r.get("ok") is False]
    print(f"\n{len([r for r in results if r.get('ok')])} ok, "
          f"{len(failed)} failed, "
          f"{len([r for r in results if r.get('ok') is None])} skipped")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
