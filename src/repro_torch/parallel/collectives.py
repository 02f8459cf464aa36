"""Explicit collectives: ring all-reduce + int8 error-feedback compression,
and the few collectives the sharded training step makes.

``torch.distributed`` already maps its collectives to near-optimal ring
schedules, so the sharded step (parameter gathers, gradient
reduce-scatters, the pool's fetch) uses plain :func:`all_gather` /
:func:`reduce_scatter` / :func:`all_reduce` (DESIGN.md §2: do not emulate
NCCL).  The reference's two explicit collectives exist where explicit
control is the feature, not a detail:

* :func:`ring_all_reduce` — a reduce-scatter + all-gather ring over
  point-to-point sends, the textbook schedule the paper's NCCL-based
  systems use (Fig. 4/5), adding the chunks in the reference's order, so
  it equals the reference's ``ppermute`` ring bit for bit in float32.

* :func:`compressed_all_reduce` — int8 wire traffic with fp32
  accumulation and error feedback (the 'compressing DMA engine' the paper
  cites as [56]): each rank quantizes its contribution once; the
  quantization residual is carried to the next step by the caller.

Every collective here goes through :func:`_wire`: gloo takes CUDA tensors
for ``broadcast`` and ``all_reduce`` only (torch's backend table), so on a
gloo group a CUDA tensor is staged through pinned host memory, every
collective alike; an NCCL group stages nothing.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.kernels.ref import INT8_MAX, true_div

#: ``all_reduce`` ops by name
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def stages_through_host(group=None) -> bool:
    """Whether the group's collectives copy CUDA tensors through pinned
    host memory (a gloo group) or take them as they are (NCCL)."""
    return dist.get_backend(group) == "gloo"


def _wire(xs: List[torch.Tensor], group, run: Callable[[List[torch.Tensor]],
                                                      Any]) -> List[torch.Tensor]:
    """Run ``run`` on the tensors ``xs`` as the group's backend takes them
    (pinned host copies of CUDA tensors on gloo) and return them on their
    devices again, contiguous; ``run`` writes its results into them."""
    stage = stages_through_host(group)
    wire = []
    for x in xs:
        if stage and x.is_cuda:
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x)
            wire.append(h)
        else:
            wire.append(x.contiguous())
    run(wire)
    return [w.to(x.device) if w.device != x.device else w
            for w, x in zip(wire, xs)]


def all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` reduced (sum, max or min) over the group."""
    out = x.clone()
    return _wire([out], group,
                 lambda w: dist.all_reduce(w[0], op=_OPS[op], group=group))[0]


def all_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` in group-rank
    order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    got = _wire([x] + parts, group,
                lambda w: dist.all_gather(w[1:], w[0], group=group))
    return torch.cat(got[1:], dim=dim)


def reduce_scatter(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum of the members' ``x``, cut along ``dim`` into one block per
    member: this member's block (by group rank).  On gloo the sum is an
    all-reduce and the block a slice of it."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    me = dist.get_rank(group)
    if stages_through_host(group):
        return all_reduce(x, group).chunk(n, dim=dim)[me].clone()
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + src.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


# ---------------------------------------------------------------------------
def _ring_peers(group) -> Tuple[int, int, int, int]:
    """``(n, me, next, previous)``: the group's size, this member's group
    rank, and the global ranks of its ring neighbours."""
    ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
    n, me = len(ranks), dist.get_rank(group)
    return n, me, ranks[(me + 1) % n], ranks[(me - 1) % n]


def _shift(xs: List[torch.Tensor], nxt: int, prv: int, group
           ) -> List[torch.Tensor]:
    """One ring hop (the reference's ``ppermute`` by +1): send ``xs`` to
    the next rank, receive the previous rank's in their place."""
    recv = [torch.empty_like(x) for x in xs]

    def run(w):
        k = len(xs)
        ops = [dist.P2POp(dist.isend, t, nxt, group) for t in w[:k]]
        ops += [dist.P2POp(dist.irecv, t, prv, group) for t in w[k:]]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    return _wire(list(xs) + recv, group, run)[len(xs):]


def ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Reduce-scatter + all-gather ring all-reduce over ``group``.

    x: identical shape on every member; the leading dim must be divisible
    by the group size.  At reduce-scatter step k member i sends its
    partial of chunk (i-k) and adds the received partial of chunk (i-k-1)
    to its own; after n-1 steps member i owns the complete sum of chunk
    (i+1) mod n, which the all-gather circulates."""
    n, me, nxt, prv = _ring_peers(group)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"ring_all_reduce: leading dim {x.shape[0]} is "
                         f"not divisible by the group size {n}")
    acc = x.reshape((n, x.shape[0] // n) + x.shape[1:]).clone()
    for k in range(n - 1):
        buf, = _shift([acc[(me - k) % n]], nxt, prv, group)
        acc[(me - k - 1) % n] = acc[(me - k - 1) % n] + buf
    mine = (me + 1) % n
    buf = acc[mine]
    out = torch.zeros_like(acc)
    out[mine] = buf
    for k in range(n - 1):
        buf, = _shift([buf], nxt, prv, group)
        out[(me - k) % n] = buf
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor int8: scale absmax / 127 (the IEEE quotient: ROADMAP
    C2), codes round(x / scale) clipped to +-127."""
    scale = torch.clamp(true_div(x.abs().amax(), INT8_MAX), min=1e-30)
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def compressed_all_reduce(x: torch.Tensor, err: torch.Tensor, group=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce.

    Wire bytes: the int8 payload and one fp32 scale a hop (4x less
    traffic than fp32); accumulation stays fp32.  Returns (mean-reduced
    value, new local error).  Convergence: the residual ``err`` is added
    before quantization next call (EF-SGD)."""
    n, _, nxt, prv = _ring_peers(group)
    corrected = x.float() + err
    q, scale = _quant(corrected)
    sent = q.float() * scale
    new_err = corrected - sent
    if n == 1:
        return sent, new_err
    acc = sent
    buf_q, buf_s = q, scale
    for _ in range(n - 1):
        buf_q, buf_s = _shift([buf_q, buf_s], nxt, prv, group)
        acc = acc + buf_q.float() * buf_s
    return acc / n, new_err


def compressed_tree_all_reduce(grads, errs, group=None):
    """Tree version of :func:`compressed_all_reduce`: per-rank local
    gradient tree + error tree -> (mean gradients, new errors)."""
    flat_g, paths = tree.flatten(grads)
    out = [compressed_all_reduce(g, e, group)
           for g, e in zip(flat_g, tree.leaves(errs))]
    return (tree.unflatten(paths, [o[0] for o in out]),
            tree.unflatten(paths, [o[1] for o in out]))
