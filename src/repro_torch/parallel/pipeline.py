"""Microbatch schedules.  So far only the degenerate single-stage one,
gradient accumulation; the gpipe / 1F1B pipeline schedules and their stage
tier port with slice 4.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree

Pytree = Any
#: metrics summed (not averaged) across microbatches: token counters
SUM_METRICS = ("tokens",)


def value_and_grad(loss_fn: Callable, params: Pytree, batch: Pytree
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Pytree]:
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)`` w.r.t. every float leaf of ``params`` (JAX's
    ``value_and_grad(..., has_aux=True)``)."""
    leaves, paths = tree.flatten(params)
    loss, metrics = loss_fn(params, batch)
    diff = [t for t in leaves if t.requires_grad]
    got = iter(torch.autograd.grad(loss, diff, allow_unused=True))
    grads = []
    for t in leaves:
        g = next(got) if t.requires_grad else None
        grads.append(torch.zeros_like(t) if g is None else g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree.unflatten(paths, grads))


def accumulate_microbatches(loss_fn: Callable, params: Pytree, batch: Pytree,
                            n_micro: int):
    """Gradient accumulation: the batch's leading dim split into
    ``n_micro`` microbatches run one after another (activation memory
    divided by M).  Returns ``(grads, loss, metrics)`` with grads (float32)
    and loss averaged and every metric the loss_fn reports accumulated:
    token counters (:data:`SUM_METRICS`) summed, the others averaged."""
    n = n_micro

    def micro(i):
        return {k: (v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                    if v.ndim >= 1 and v.shape[0] % n == 0 else v)
                for k, v in batch.items()}

    acc = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    msum, ltot = {}, 0.0
    for i in range(n):
        l, m, g = value_and_grad(loss_fn, params, micro(i))
        acc = tree.map(lambda a, b: a + b.float(), acc, g)
        msum = {k: msum.get(k, 0.0) + v.float() for k, v in m.items()}
        ltot = ltot + l.float()
    grads = tree.map(lambda v: v / n, acc)
    metrics = {k: (v if k in SUM_METRICS else v / n) for k, v in msum.items()}
    return grads, ltot / n, metrics
