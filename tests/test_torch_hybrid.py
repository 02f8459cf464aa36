"""The hybrid (zamba2) slice of the port — serving and training — against
the JAX reference, on the CPU.

Weights come from the reference's initialisers on ``zamba2_2_7b.reduced(
dtype="float32")`` — 2 Mamba2 blocks and one site of the shared attention
block, d_model 128, 4 heads of 32 over 2 kv heads — and on a second cut
closer to the full model's attention: 4 Mamba2 blocks (two sites of the
shared block, so one set of weights serves two cache rows), head_dim 80
(RoPE over halves of 40) and no GQA (4 kv heads), as zamba2-2.7b's 32
heads of 80.  They are carried over with
``repro_torch.convert.params_from_jax``.  Greedy token streams must be
bit-identical; logits and caches agree to float32 rounding; a training
step's loss and every gradient leaf, the shared block's summed over its
sites, agree to float32 rounding.

The reference's paged path with ``decode_kernel=True`` cannot run a
hybrid model (ROADMAP C5): there the port's in-place kernel path is held
to the reference's monolithic and paged gather streams, which agree with
each other, and the paged decode at zamba2's head shape is held to the
reference's Pallas kernel in interpret mode.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import MemoryPlan as JMemoryPlan
from repro.configs import MeshPlan as JMeshPlan
from repro.configs import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.kernels.paged_attention import paged_decode_attention as jpaged
from repro.models.model import build_model as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.quota import TenantQuota as JQuota
from repro.serve.scheduler import FairScheduler as JFair
from repro_torch import tree
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import MemoryPlan, RunConfig, TrainConfig
from repro_torch.configs.base import MeshPlan, ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.runtime import MemoryRuntime
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.models import transformer as ttfm
from repro_torch.models.model import Model, build_model
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.quota import TenantQuota
from repro_torch.serve.scheduler import FairScheduler
from repro_torch.train.loop import make_train_step
from repro_torch.train.train_state import init_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "zamba2-2.7b"
SINGLE = JMeshPlan((1,), ("data",))
# float32 on both sides, products summed in other orders through the
# stack: logits and cache leaves agree to a few float32 ulps of their
# scale (as tests/test_torch_ssm.py)
TOL = 1e-4
# the paged decode against the Pallas kernel (tests/test_torch_kernels.py)
PAGED_TOL = 1e-5
# a training step, as tests/test_torch_ssm.py: the loss absolute, each
# gradient leaf relative to its largest magnitude
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
#: the two cuts: the reference's reduced() and one with zamba2's attention
#: shape (head_dim 80, no GQA) and two sites of the shared block
CUTS = {"reduced": {},
        "hd80x2": dict(num_layers=4, head_dim=80, num_kv_heads=4)}


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


@functools.lru_cache(maxsize=None)
def _models(cut="hd80x2", dtype="float32"):
    over = dict(CUTS[cut], dtype=dtype)
    jcfg = JARCHS[ARCH].reduced(**over)
    jm = jbuild(JRunConfig(model=jcfg, shape=JShapeConfig("t", 64, 2,
                                                          "decode"),
                           mesh=SINGLE, memory=JMemoryPlan(policy="none")))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(TARCHS[ARCH].reduced(**over), device="cpu")
    tp = params_from_jax(_np(jp), "cpu")
    return jm, jp, tm, tp


def _close(got, want, tol, what=""):
    """``got`` within ``tol`` of ``want``'s largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err < tol, (what, err)


# ---------------------------------------------------------------------------
# (a) the parameter tree and its carry-over
@pytest.mark.parametrize("cut", sorted(CUTS))
def test_param_tree_keeps_shared_block_unstacked(cut):
    """``shared`` is one unstacked dense sub-layer; the groups hold the
    SSM blocks only; every leaf has the reference's shape and the port's
    own init gives the same tree."""
    jm, jp, tm, tp = _models(cut)
    cfg = tm.cfg
    k = cfg.hybrid_attn_every
    assert sorted(tp["groups"]) == [f"sub_{j}" for j in range(k)]
    assert sorted(tp["shared"]) == ["attn", "ln1", "ln2", "mlp"]
    assert sorted(tp["shared"]["mlp"]) == ["w1", "w2"]     # gelu: no gate
    H, K, hd, D = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                   cfg.d_model)
    assert tuple(tp["shared"]["attn"]["wq"].shape) == (D, H * hd)
    assert tuple(tp["shared"]["attn"]["wk"].shape) == (D, K * hd)
    init = tm.init(0)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t, i = tp, init
        for key in path:
            t, i = t[key.key], i[key.key]
        assert tuple(t.shape) == leaf.shape == tuple(i.shape), path
        assert t.dtype == i.dtype, path


def test_bf16_carry_over_keeps_f32_leaves():
    """Under a bf16 cast the norms (the shared block's too) and the SSM
    blocks' A_log, D, dt_bias and norm_scale stay float32 and bit-equal to
    the reference's; the shared block's weights become bf16."""
    jcfg = JARCHS[ARCH].reduced(dtype="bfloat16")
    jp = jbuild(JRunConfig(model=jcfg, shape=JShapeConfig("t", 8, 1, "train"),
                           mesh=SINGLE, memory=JMemoryPlan(policy="none"))
                ).init(jax.random.PRNGKey(0))
    want = _np(jp)
    tp = params_from_jax(want, "cpu", dtype=torch.bfloat16)
    for path in (("shared", "ln1", "scale"), ("shared", "ln2", "scale"),
                 ("groups", "sub_0", "ln1", "scale"), ("final_norm", "scale"),
                 ("groups", "sub_1", "ssm", "A_log"),
                 ("groups", "sub_0", "ssm", "D"),
                 ("groups", "sub_0", "ssm", "dt_bias"),
                 ("groups", "sub_1", "ssm", "norm_scale")):
        t, w = tp, want
        for key in path:
            t, w = t[key], w[key]
        assert w.dtype == np.float32 and t.dtype == torch.float32, path
        np.testing.assert_array_equal(t.numpy(), w)
    for path in (("shared", "attn", "wq"), ("shared", "mlp", "w1"),
                 ("groups", "sub_0", "ssm", "in_proj"), ("embed",)):
        t = tp
        for key in path:
            t = t[key]
        assert t.dtype == torch.bfloat16, path


# ---------------------------------------------------------------------------
# (b) the model: prefill, decode, continuation
@pytest.mark.parametrize("cut,S", [("reduced", 20), ("hd80x2", 20),
                                   ("hd80x2", 37)])
def test_forward_serve_matches_reference(cut, S):
    """Prefill S tokens (S padded to the 16-row chunk inside each SSM
    block), then 4 decode steps: the logits and every cache leaf — the
    SSM groups' conv / ssm state and the shared block's k/v stacked over
    its sites — as the reference's."""
    jm, jp, tm, tp = _models(cut)
    rng = np.random.default_rng(S)
    n = S + 4
    toks = rng.integers(0, 512, size=(2, n)).astype(np.int32)
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (2, n))

    def t_in(lo, hi):
        return (torch.from_numpy(np.ascontiguousarray(a[:, lo:hi])).long()
                for a in (toks, pos))

    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S]),
                             "positions": jnp.asarray(pos[:, :S])},
                        jm.init_cache(2, 64))
    tt, tpos = t_in(0, S)
    tl, tc = tm.prefill(tp, {"tokens": tt, "positions": tpos},
                        tm.init_cache(2, 64))
    _close(tl, jl, TOL, "prefill logits")
    for i in range(S, n):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(pos[:, i:i + 1]), jc,
                                jnp.int32(i))
        tl, tc = tm.decode_step(tp, *t_in(i, i + 1), tc, i)
        _close(tl, jl, TOL, f"decode {i} logits")
    want = _np(jc)
    leaves, paths = tree.flatten(tc)
    assert sorted(paths) == sorted(
        tuple(k.key for k in p)
        for p, _ in jax.tree_util.tree_leaves_with_path(want))
    for leaf, path in zip(leaves, paths):
        w = want
        for key in path:
            w = w[key]
        _close(leaf, w, TOL, "/".join(path))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.05)])
def test_decode_matches_prefill_continuation(dtype, tol):
    """As the reference's ``test_smoke_archs.py``: decode after prefill(S)
    equals a fresh prefill(S+1)'s last-token logits."""
    cfg = TARCHS[ARCH].reduced(dtype=dtype, **CUTS["hd80x2"])
    m = Model(cfg, device="cpu")
    params = m.init(0)
    S, B = 21, 2
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(B, S + 1))).long()
    pos = torch.arange(S + 1)[None].expand(B, S + 1)
    _, caches = m.prefill(params, {"tokens": toks[:, :S],
                                   "positions": pos[:, :S]},
                          m.init_cache(B, S + 8))
    dec, _ = m.decode_step(params, toks[:, S:], pos[:, S:], caches, S)
    pref, _ = m.prefill(params, {"tokens": toks, "positions": pos},
                        m.init_cache(B, S + 8))
    a, b = dec.float(), pref.float()
    assert float((a - b).abs().max() / b.abs().max()) < tol
    assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_paged_decode_at_zamba2_head_shape_matches_pallas():
    """The paged decode at zamba2's attention shape (head_dim 80, one
    query head per kv head, 32 heads) over a permuted pool with int8
    side-pool frames: the port's plain version against the reference's
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(0)
    B, H, hd, page, pp = 2, 32, 80, 8, 3
    P = B * pp + 1
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, page, H, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, H, hd)).astype(np.float32)
    pm = rng.permutation(P - 1)[:B * pp].reshape(B, pp).astype(np.int32)
    pm[0, -1] = P - 1
    side = {k: [] for k in ("kq_pool", "vq_pool", "k_scale", "v_scale")}
    for ci, fr in enumerate(pm[:, :2].reshape(-1)[:2].tolist()):
        for pool, qn, sn in ((kp, "kq_pool", "k_scale"),
                             (vp, "vq_pool", "v_scale")):
            qq, sc = tref.int8_pack_ref(
                torch.from_numpy(pool[fr].reshape(page * H, hd)), page * H)
            side[qn].append(qq.numpy().reshape(page, H, hd))
            side[sn].append(sc.numpy())
        pm[pm == fr] = P + ci
    side = {k: np.stack(v) for k, v in side.items()}
    for idx in (0, 7, 13, 23):
        got = paged_decode_attention(
            *(torch.from_numpy(a) for a in (q, kp, vp, pm)), idx,
            **{k: torch.from_numpy(v) for k, v in side.items()})
        want = jpaged(*(jnp.asarray(a) for a in (q, kp, vp, pm)),
                      jnp.int32(idx), interpret=True,
                      **{k: jnp.asarray(v) for k, v in side.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=PAGED_TOL, atol=PAGED_TOL)


# ---------------------------------------------------------------------------
# (c) the serving engine
def _streams(engine_cls, request_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, **kw)
    for uid, prompt, n in reqs:
        eng.submit(request_cls(uid=uid, prompt=prompt, max_new_tokens=n))
    done = sorted(eng.run(), key=lambda r: r.uid)
    return [r.out_tokens for r in done], eng.traffic_report()


def _requests():
    """Prompts across chunk and page boundaries (16-row chunks, 8-row
    pages), more sessions than slots."""
    rng = np.random.default_rng(3)
    return [(i, rng.integers(0, 512, size=(n,)).astype(np.int32), 8)
            for i, n in enumerate((7, 20, 13, 33, 9))]


#: scenario -> (engine kwargs shared by both packages, fair quantum or
#: None, tenant codec or None)
SCENARIOS = {
    # 5 frames (the longest session's 40 rows) for 2 slots of 8 pages,
    # first come first served: when a growing session finds every frame
    # hot the other one is paused, and its pages are evicted and refetched
    "overcommitted_pool": (dict(batch=2, max_len=64, page_size=8, pages=5,
                                spill="host"), None, None),
    # the full pool, sessions of mixed lengths swapped every 3 tokens:
    # steps decode at two lengths, slots park their SSM state
    "fair_mixed_lengths": (dict(batch=2, max_len=64, page_size=8,
                                spill="host"), 3, None),
    # both, with 12 frames: cold pages through the int8 codec's pack /
    # unpack
    "int8_spill": (dict(batch=2, max_len=64, page_size=8, pages=12,
                        spill="host"), 3, "int8"),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_paged_engine_streams_match_reference(name):
    """The paged engine (gather path) against the reference's paged
    engine: bit-identical greedy streams, the same spill bytes and page
    counters; the in-place kernel path streams exactly the same."""
    jm, jp, tm, tp = _models()
    kw, quantum, codec = SCENARIOS[name]

    def extra(fair, quota):
        out = {}
        if quantum:
            out["scheduler"] = fair(quantum=quantum)
        if codec:
            out["quota"] = quota(codec=codec)
        return out

    want, jrep = _streams(JEngine, JRequest, jm, jp, _requests(),
                          **extra(JFair, JQuota), **kw)
    got, trep = _streams(Engine, Request, tm, tp, _requests(),
                         **extra(FairScheduler, TenantQuota), **kw)
    on, krep = _streams(Engine, Request, tm, tp, _requests(),
                        decode_kernel=True,
                        **extra(FairScheduler, TenantQuota), **kw)
    assert got == want
    assert on == want
    for key in ("kv_stash", "kv_fetch", "pages"):
        assert trep[key] == jrep[key], key
    assert trep["slots"]["parks"] > 0
    assert krep["kv_stash"] == jrep["kv_stash"]
    assert krep["pages"] == jrep["pages"]
    if kw.get("pages"):
        assert jrep["pages"]["evictions"] > 0
    if codec:
        assert krep["decode_io"]["compressed_adopts"] > 0


def test_kernel_path_held_to_reference_monolithic_streams():
    """ROADMAP C5: the reference's in-place paged decode cannot run a
    hybrid model (its side pool skips the SSM groups, then the decode
    reads ``cpool[group]["k"]`` for every group: KeyError).  Its
    monolithic and paged gather paths agree; the port's in-place kernel
    path streams exactly what they do."""
    jm, jp, tm, tp = _models()
    kw = dict(batch=2, max_len=64, spill="host")
    mono, _ = _streams(JEngine, JRequest, jm, jp, _requests(),
                       scheduler=JFair(quantum=3), **kw)
    paged, _ = _streams(JEngine, JRequest, jm, jp, _requests(),
                        scheduler=JFair(quantum=3), page_size=8, pages=12,
                        **kw)
    assert paged == mono
    with pytest.raises(KeyError):
        _streams(JEngine, JRequest, jm, jp, _requests()[:1], page_size=8,
                 decode_kernel=True, **kw)
    got, rep = _streams(Engine, Request, tm, tp, _requests(),
                        scheduler=FairScheduler(quantum=3), page_size=8,
                        pages=12, decode_kernel=True, **kw)
    assert got == mono
    assert rep["decode_io"]["in_place"] and rep["slots"]["parks"] > 0


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_reused_slot_never_leaks_ssm_state(decode_kernel):
    """The port's version of the reference's
    ``test_hybrid_prefill_never_reads_stale_slot_state``, on the paged
    path: sessions one after another through one slot stream what each
    streams alone."""
    _, _, tm, tp = _models()
    prompts = [(np.arange(4 + i, dtype=np.int32) * (i + 2) + 1) % 512
               for i in range(3)]
    kw = dict(batch=1, max_len=32, page_size=8,
              decode_kernel=decode_kernel)
    alone = [_streams(Engine, Request, tm, tp, [(0, p, 5)], **kw)[0][0]
             for p in prompts]
    together, _ = _streams(Engine, Request, tm, tp,
                           [(i, p, 5) for i, p in enumerate(prompts)], **kw)
    assert together == alone


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_paged_decode_keeps_other_slots_state(decode_kernel):
    """A decode step at one length changes the conv / ssm state of the
    slots it decodes and leaves every other slot's bit for bit as it
    was, on both paged paths; the other slot's pages are not written."""
    _, _, tm, tp = _models()
    eng = Engine(tm, tp, batch=3, max_len=64, page_size=8,
                 decode_kernel=decode_kernel)
    for uid, n in ((0, 5), (1, 12)):
        eng.submit(Request(uid=uid, prompt=np.arange(n, dtype=np.int32) + 3,
                           max_new_tokens=8))
    eng.step()          # admits both, one decode step at each length
    a, b = eng.cache.slots[0], eng.cache.slots[1]
    assert a.length != b.length
    before = tree.map(torch.clone, eng.cache.slot_tree)
    pool = tree.map(torch.clone, eng.cache.pool)
    mask = np.array([True, False, False])
    tok = torch.zeros((3, 1), dtype=torch.long)
    eng._decode(tok, a.length, mask)
    for (new, old), path in zip(zip(tree.leaves(eng.cache.slot_tree),
                                    tree.leaves(before)),
                                tree.flatten(before)[1]):
        assert not torch.equal(new[:, 0], old[:, 0]), path
        assert torch.equal(new[:, 1:], old[:, 1:]), path
    row = [p for p in eng.cache.page_map_host()[1]
           if p != eng.cache.scratch_id]
    for new, old in zip(tree.leaves(eng.cache.pool), tree.leaves(pool)):
        assert torch.equal(new[:, row], old[:, row])


def test_paged_pool_splits_kv_from_slot_state():
    """Only the shared block's k/v are paged; the SSM groups' state is one
    row per decode slot beside the pool."""
    _, _, tm, _ = _models()
    cfg = tm.cfg
    pool, slots = ttfm.paged_pool(cfg, 5, 8, torch.float32, "cpu", batch=3)
    k = cfg.hybrid_attn_every
    assert list(pool) == [f"sub_{k}"]
    assert tuple(pool[f"sub_{k}"]["k"].shape) == (
        cfg.num_layers // k, 6, 8, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert sorted(slots) == [f"sub_{j}" for j in range(k)]
    for sub in slots.values():
        assert sorted(sub) == ["conv", "ssm"]
        assert sub["ssm"].shape[:2] == (cfg.num_layers // k, 3)


# ---------------------------------------------------------------------------
# (d) training: forward_train over the Mamba2 groups and the shared
# block's sites
TRAIN_B, TRAIN_S = 2, 40          # 40 rows: the SSM blocks pad to 48


def _train_models(cut, policy):
    over = dict(CUTS[cut], dtype="float32")
    jm = jbuild(JRunConfig(model=JARCHS[ARCH].reduced(**over),
                           shape=JShapeConfig("train", TRAIN_S, TRAIN_B,
                                              "train"),
                           mesh=SINGLE, memory=JMemoryPlan(policy=policy)))
    tm = build_model(RunConfig(model=TARCHS[ARCH].reduced(**over),
                               shape=ShapeConfig("train", TRAIN_S, TRAIN_B,
                                                 "train"),
                               memory=MemoryPlan(policy=policy)),
                     device="cpu")
    return jm, tm


@pytest.mark.parametrize("policy", ["host", "none"])
@pytest.mark.parametrize("cut", sorted(CUTS))
def test_loss_fn_and_grads_match_reference(cut, policy):
    """One step's loss and every gradient leaf, the shared block's
    included (autograd's sum over its sites against ``jax.grad``'s over
    the reference's closed-over ``params["shared"]``), against the
    reference's; under ``host`` every sub-layer's input is stashed (no
    codec) and the sub-layer recomputed in backward, one stash and one
    fetch a sub-layer."""
    jm, tm = _train_models(cut, policy)
    assert tm.runtime.offloads == (policy == "host")
    jp = jm.init(jax.random.PRNGKey(0))
    batch = SyntheticLM(tm.cfg, batch=TRAIN_B, seq=TRAIN_S,
                        seed=1).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree.map(lambda t: t.requires_grad_(),
                  params_from_jax(_np(jp), "cpu"))
    tl, _ = tm.loss_fn(tp, to_device(batch, "cpu"))
    leaves, paths = tree.flatten(tp)
    tg = torch.autograd.grad(tl, leaves)
    assert abs(tl.item() - float(jl)) < LOSS_TOL
    want = _np(jg)
    assert any(p[0] == "shared" for p in paths)
    for g, path in zip(tg, paths):
        w = want
        for k in path:
            w = w[k]
        assert np.abs(w).max() > 0, path
        _close(g, w, GRAD_TOL, "/".join(path))
    rep = tm.runtime.traffic_report()
    group, n_groups = ttfm.arch_group(tm.cfg)
    calls = n_groups * len(group) if policy == "host" else 0
    assert rep.get("stash", {}).get("calls", 0) == calls
    assert rep.get("fetch", {}).get("calls", 0) == calls


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_each_site_stashes_under_the_shared_name(cut):
    """Under ``host`` + fp8 the shared block stashes once a site under
    ``shared_layer`` and each Mamba2 block once under ``ssm_layer``; each
    stash is fetched once in backward, the wire at the fp8 codec's
    nominal ratio, half the raw bytes (as the reference meters it)."""
    cfg = TARCHS[ARCH].reduced(dtype="float32", **CUTS[cut])
    tm = build_model(RunConfig(model=cfg,
                               shape=ShapeConfig("train", TRAIN_S, TRAIN_B,
                                                 "train"),
                               memory=MemoryPlan(policy="host",
                                                 compress="fp8")),
                     device="cpu")
    names = {"stash": [], "fetch": []}
    rt = tm.runtime
    for d in names:
        def spy(*a, _d=d, _fn=getattr(rt, d), **kw):
            names[_d].append(a[1].name)
            return _fn(*a, **kw)
        setattr(rt, d, spy)
    params = tm.init(0)
    for t in tree.leaves(params):
        t.requires_grad_(True)
    loss, _ = tm.loss_fn(params, to_device(SyntheticLM(
        cfg, batch=TRAIN_B, seq=TRAIN_S, seed=2).batch_at(0), "cpu"))
    loss.backward()
    group, n_groups = ttfm.arch_group(cfg)
    for d, got in names.items():
        assert got.count("shared_layer") == n_groups, d
        assert got.count("ssm_layer") == n_groups * group.count("ssm"), d
    rep = rt.traffic_report()
    raw = n_groups * len(group) * TRAIN_B * TRAIN_S * cfg.d_model * 4
    for d in names:
        assert rep[d]["raw_bytes"] == raw and rep[d]["wire_bytes"] == raw / 2
    assert torch.isfinite(loss) and all(
        t.grad is not None and torch.isfinite(t.grad).all()
        for t in tree.leaves(params))


@pytest.mark.parametrize("sites", [1, 2, 3])
def test_wrap_layer_sums_a_shared_leaf_over_its_calls(sites):
    """The same parameter leaves through ``sites`` wrapped calls: the
    input and each leaf's gradient are those of the unwrapped chain
    (autograd sums each call's parameter gradient), and the saved leaves
    are not written."""
    rt = MemoryRuntime(MeshPlan((1,), ("data",)), MemoryPlan(policy="host"),
                       device="cpu")
    assert rt.offloads
    gen = torch.Generator().manual_seed(sites)
    w0 = torch.randn((8, 8), generator=gen) / 3
    b0 = torch.randn((8,), generator=gen)
    x0 = torch.randn((2, 5, 8), generator=gen)

    def layer(p, x):
        return x + torch.tanh(x @ p["w"] + p["b"])

    def run(fn):
        p = {"w": w0.clone().requires_grad_(), "b": b0.clone()
             .requires_grad_()}
        x = x0.clone().requires_grad_()
        y = x
        for _ in range(sites):
            y = fn(p, y)
        (y.square().sum()).backward()
        return x.grad, p["w"].grad, p["b"].grad, p

    got, want = run(rt.wrap_layer(layer, "shared_layer")), run(layer)
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[3]["w"].detach(), w0)
    assert torch.equal(got[3]["b"].detach(), b0)
    assert rt.traffic_report()["stash"]["calls"] == sites


def test_bf16_train_step_keeps_f32_leaves():
    """A bf16 training step of the hybrid: the norms (the shared block's
    too) and the SSM's A_log, D, dt_bias and norm_scale stay float32
    through the step and the optimizer, each with float32 moments; the
    weights stay bf16; every leaf moves and stays finite."""
    cfg = TARCHS[ARCH].reduced(dtype="bfloat16", **CUTS["hd80x2"])
    tc = TrainConfig(total_steps=2, warmup_steps=0, learning_rate=1e-3)
    tm = build_model(RunConfig(model=cfg,
                               shape=ShapeConfig("train", TRAIN_S, TRAIN_B,
                                                 "train"),
                               memory=MemoryPlan(policy="host",
                                                 compress="fp8"),
                               train=tc), device="cpu")
    state = init_state(tm, tc)
    before = tree.map(lambda t: t.detach().clone(), state["params"])
    dtypes = {p: t.dtype for t, p in zip(*tree.flatten(before))}
    state, metrics = make_train_step(tm, tc)(state, to_device(SyntheticLM(
        cfg, batch=TRAIN_B, seq=TRAIN_S, seed=3).batch_at(0), "cpu"))
    assert np.isfinite(float(metrics["loss"]))
    f32 = {("shared", "ln1", "scale"), ("shared", "ln2", "scale"),
           ("final_norm", "scale")} | {
        ("groups", f"sub_{j}", *k) for j in range(2)
        for k in (("ln1", "scale"), ("ssm", "A_log"), ("ssm", "D"),
                  ("ssm", "dt_bias"), ("ssm", "norm_scale"))}
    leaves, paths = tree.flatten(state["params"])
    for t, old, path in zip(leaves, tree.leaves(before), paths):
        want = torch.float32 if path in f32 else torch.bfloat16
        assert dtypes[path] == t.dtype == want, path
        assert torch.isfinite(t.float()).all(), path
        assert not torch.equal(t, old), path
    for m in tree.leaves({k: state["opt"][k] for k in ("m", "v")}):
        assert m.dtype == torch.float32


def test_train_cli_smoke():
    """``launch.train --arch zamba2-2.7b`` on the CPU with the host tier
    and the fp8 stash: finite losses, every sub-layer stashed (the
    reduced twin: one group of two Mamba2 blocks and the shared block),
    equal stash and fetch bytes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "3", "--policy", "host",
         "--compress", "fp8", "--log-every", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if " loss=" in line]
    assert len(losses) == 3 and all(np.isfinite(losses)), out[-2000:]
    assert "1 of 1 layer groups stashed (3 sub-layers)" in out, out[-2000:]
    line = next(x for x in out.splitlines()
                if "memory traffic: tier=host+fp8" in x)
    per = line.split("{", 1)[1]
    stash = per.split("'stash': '")[1].split("'")[0]
    fetch = per.split("'fetch': '")[1].split("'")[0]
    assert stash == fetch and "/9x of" in stash, line


def test_serve_cli_smoke():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--batch", "2",
         "--max-len", "64", "--page-size", "8", "--pages", "12",
         "--decode-kernel", "--requests", "4", "--prompt-len", "12,20",
         "--new-tokens", "6", "--scheduler", "fair", "--quantum", "2",
         "--spill", "host", "--page-codec", "int8"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "zamba2-2.7b-smoke 2L" in proc.stdout
    assert "served 4 requests, 24 tokens" in proc.stdout
    assert "slots parked" in proc.stdout
    assert "kernel launches:" in proc.stdout
