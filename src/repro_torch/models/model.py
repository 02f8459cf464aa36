"""Model facade — one object per (architecture x memory plan x device).

Wraps the transformer stack with parameter init, the sharding specs of
its parameters, caches and batches, the training loss (chunked CE over
the tied table, the sub-layers of the first ``stash_groups`` layer groups
wrapped by the memory runtime), cache construction and the serving entry
points (prefill / decode).

On a mesh (``mesh``: a ``("data", "model")`` DeviceMesh of the plan's
shape) the model is one rank of the sharded step: :meth:`Model.init`
gives this rank's parameter shards (by :meth:`Model.param_specs`),
:meth:`Model.shard_batch` its rows of a global batch, and
:meth:`Model.loss_fn` this rank's share of the global batch's mean loss,
whose gradients, summed over the ranks by the parameter gathers'
backward, are the global batch's.  Dense decoders, the SSM family and
the hybrid run there; the MoE family waits for expert parallelism (ROADMAP
A9), the encoder-decoder and the VLM for A8b.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import (MemoryPlan, MeshPlan, ModelConfig,
                                      RunConfig, ShapeConfig)
from repro_torch.core.runtime import MemoryRuntime
from repro_torch.models import frontends
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (ModelContext, chunked_cross_entropy,
                                       torch_dtype)
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import PartitionSpec as P

Params = Dict[str, Any]
SINGLE_DEVICE = MeshPlan((1,), ("data",))
AUX_WEIGHT = 0.01


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA without it raises,
    unless a ``FakeTensorMode`` is in force (the dry-run's fake card,
    ``launch/dryrun.py``: nothing is allocated or launched)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available() and \
            torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is None:
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available (pass device='cpu' to run on the CPU)")
    return device


def check_mesh_arch(cfg: ModelConfig) -> None:
    """Raise for a configuration the sharded step does not run yet."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name} on a mesh: the MoE block's capacity is counted over "
            "the rows that enter it, so a rank's shard of the batch routes "
            "otherwise; MoE on a mesh ports with expert parallelism "
            "(ROADMAP A9)")
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name} on a mesh: the encoder-decoder and the VLM port to "
            "the mesh with ROADMAP A8b")


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    plan: MeshPlan = SINGLE_DEVICE
    memory: MemoryPlan = MemoryPlan(policy="none")
    device: Any = "cuda"
    stash_groups: Optional[int] = None     # None -> stash all
    mesh: Any = None                       # a DeviceMesh of the plan

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.dtype = torch_dtype(self.cfg.dtype)
        self.mesh = sharding.mesh_groups(self.mesh)
        if self.mesh is not None:
            check_mesh_arch(self.cfg)
            if self.mesh.shape != tuple(self.plan.shape) or \
                    self.mesh.names != tuple(self.plan.axes):
                raise ValueError(f"the mesh {self.mesh.shape} over "
                                 f"{self.mesh.names} is not the plan's "
                                 f"{self.plan}")
        self.runtime = MemoryRuntime(self.plan, self.memory, self.device,
                                     mesh=self.mesh)
        self.planner = self.runtime.planner

    def ctx(self, mode: str = "decode") -> ModelContext:
        specs = self.param_specs() if self.mesh is not None else None
        return ModelContext(cfg=self.cfg, mode=mode, runtime=self.runtime,
                            param_specs=specs)

    def init(self, seed: int = 0) -> Params:
        """Random parameters from a seeded generator on the model device;
        on a mesh this rank's shards of them."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = tfm.init_params(gen, self.cfg, self.dtype, self.device)
        if self.mesh is None:
            return params
        return tree.map(lambda t, sp: sharding.shard(t, sp, self.mesh),
                        params, self.param_specs())

    # ------------------------------------------------------------------
    # sharding specs (the reference's tables)
    def param_specs(self) -> Params:
        return tfm.param_specs(self.cfg, self.planner)

    def cache_specs(self, batch: int, seq: int) -> Params:
        return tfm.cache_specs(self.cfg, self.planner, batch, seq)

    def input_shapes(self, shape: ShapeConfig) -> Dict[str, Tuple[int, ...]]:
        """The shapes of a batch's entries at ``shape`` (the reference's
        ``input_specs``, without dtypes)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.mode in ("train", "prefill"):
            d = {"tokens": (B, S),
                 "positions": (3, B, S) if cfg.mrope_sections else (B, S)}
            if shape.mode == "train":
                d["labels"] = (B, S)
            if cfg.frontend == "audio_stub":
                d["frames"] = (B, cfg.frontend_tokens,
                               frontends.AUDIO_FRAME_DIM)
            if cfg.frontend == "vision_stub":
                d["patches"] = (B, cfg.frontend_tokens,
                                frontends.VISION_PATCH_DIM)
            return d
        return {"token": (B, 1),
                "positions": (3, B, 1) if cfg.mrope_sections else (B, 1),
                "index": ()}

    def batch_specs(self, shape: ShapeConfig) -> Dict[str, P]:
        """PartitionSpecs of :meth:`input_shapes`' entries."""
        b = self.planner.axes.batch
        specs = {}
        for name, s in self.input_shapes(shape).items():
            if name == "index":
                specs[name] = P()
            elif name == "positions" and len(s) == 3:
                specs[name] = self.planner.spec(s, [None, b, None], name)
            else:
                specs[name] = self.planner.spec(
                    s, [b] + [None] * (len(s) - 1), name)
        return specs

    def shard_batch(self, batch: Dict[str, torch.Tensor], n_micro: int = 1
                    ) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch: each of ``n_micro``
        microbatches (the batch's leading rows cut in ``n_micro``, as
        gradient accumulation cuts them) split over the batch axes, so the
        rank's microbatch i is its block of the global microbatch i.  The
        batch itself off a mesh."""
        if self.mesh is None:
            return batch
        axes = self.mesh.axes(self.planner.axes.batch)
        n = math.prod(self.mesh.axis_size(a) for a in axes)
        me = self.mesh.index(axes)

        def rows(v):
            B = v.shape[0]
            if B % (n_micro * n):
                raise ValueError(f"a batch of {B} rows does not split into "
                                 f"{n_micro} microbatches over {n} ranks")
            v = v.unflatten(0, (n_micro, n, B // (n_micro * n)))
            return v.select(1, me).flatten(0, 1)

        return {k: rows(v) for k, v in batch.items()}

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the batch axes' ranks (``x`` off a mesh)."""
        group = None if self.mesh is None else \
            self.mesh.group(self.planner.axes.batch)
        if group is None:
            return x
        from repro_torch.parallel import collectives as coll
        return coll.all_reduce(x, group)

    def init_cache(self, batch: int, seq: int) -> Params:
        return tfm.init_caches(self.cfg, batch, seq, self.dtype, self.device)

    # ------------------------------------------------------------------
    # training
    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, metrics): chunked CE over the tied table, labels
        < 0 masked, plus ``AUX_WEIGHT`` x the layers' aux loss.  The
        batch's ``frames`` (encoder-decoder) or ``patches`` (VLM) feed
        the frontend; M-RoPE ``positions`` are (3, B, S)."""
        cfg = self.cfg
        ctx = self.ctx("train")
        if self.mesh is not None:
            # the tables, the final norm and the hybrid's shared block are
            # gathered once a step: their gradients sum over their uses
            # before the one reduce-scatter
            specs = ctx.param_specs
            params = dict(params)
            for k in ("embed", "unembed", "final_norm", "shared"):
                if k in params:
                    params[k] = self.runtime.gather(params[k], specs[k])
        h, aux = tfm.forward_train(params, ctx, batch["tokens"],
                                   batch["positions"],
                                   frames=batch.get("frames"),
                                   patches=batch.get("patches"),
                                   stash_groups=self.stash_groups)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        labels = batch["labels"]
        mask = (labels >= 0).float()
        count = None
        if self.mesh is not None:      # this rank's share of the mean
            count = self.batch_sum(mask.sum())
        loss, n_tok = chunked_cross_entropy(h, table, labels.clamp(min=0),
                                            mask, count=count)
        total = loss + AUX_WEIGHT * aux
        return total, {"loss": loss, "aux_loss": aux, "tokens": n_tok}

    # ------------------------------------------------------------------
    # serving
    @torch.no_grad()
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                caches: Params, cache_index: int = 0,
                prefix_attend: bool = False) -> Tuple[torch.Tensor, Params]:
        """Process the prompt into ``caches`` (in place); returns
        (last-token logits (B, V), caches).  ``prefix_attend``: the tokens
        are a prompt's suffix, written at ``cache_index`` over the prefix
        rows already in ``caches`` (a prefix-sharing admission).  The
        batch's ``frames`` / ``patches`` go to ``forward_serve``."""
        ctx = self.ctx("prefill")
        h, caches = tfm.forward_serve(params, ctx, batch["tokens"],
                                      batch["positions"], caches,
                                      cache_index=cache_index,
                                      prefix_attend=prefix_attend,
                                      frames=batch.get("frames"),
                                      patches=batch.get("patches"))
        return tfm.unembed(params, ctx, h[:, -1:, :])[:, 0, :], caches

    @torch.no_grad()
    def decode_step(self, params: Params, token: torch.Tensor,
                    positions: torch.Tensor, caches: Params, index: int,
                    paged: Optional[dict] = None
                    ) -> Tuple[torch.Tensor, Params]:
        """One decode step: token (B, 1), positions (B, 1) or (3, B, 1);
        ``index`` tokens already cached.  ``paged``: decode in place over a page pool (see
        ``models/attention.attention_block``)."""
        ctx = self.ctx()
        h, caches = tfm.forward_serve(params, ctx, token, positions, caches,
                                      cache_index=index, paged=paged)
        return tfm.unembed(params, ctx, h[:, 0:1, :])[:, 0, :], caches


def build_model(run: RunConfig, device="cuda", mesh=None) -> Model:
    """The Model for a run on one device, or with ``mesh`` (a DeviceMesh
    of ``run.mesh``) one rank of it (``run.mesh`` is not used without
    one), resolving the memory tier's stash split through the
    MemoryRuntime: every layer group for a stash-all tier (host, mcdla,
    spill), none when the tier does not offload, and for ``auto`` the
    groups the KEEP / POOL / RECOMPUTE planner evicts at ``run.shape``."""
    model = Model(cfg=run.model, memory=run.memory, device=device,
                  **({} if mesh is None else dict(plan=run.mesh, mesh=mesh)))
    _, n_groups = tfm.arch_group(run.model)
    model.stash_groups = model.runtime.resolve_stash_groups(
        run.model, run.shape, n_groups)
    return model
