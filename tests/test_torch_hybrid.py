"""The hybrid (zamba2) serving slice of the port against the JAX reference,
on the CPU.

Weights come from the reference's initialisers on ``zamba2_2_7b.reduced(
dtype="float32")`` — 2 Mamba2 blocks and one site of the shared attention
block, d_model 128, 4 heads of 32 over 2 kv heads — and on a second cut
closer to the full model's attention: 4 Mamba2 blocks (two sites of the
shared block, so one set of weights serves two cache rows), head_dim 80
(RoPE over halves of 40) and no GQA (4 kv heads), as zamba2-2.7b's 32
heads of 80.  They are carried over with
``repro_torch.convert.params_from_jax``.  Greedy token streams must be
bit-identical; logits and caches agree to float32 rounding.

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
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.models import transformer as ttfm
from repro_torch.models.model import Model
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.quota import TenantQuota
from repro_torch.serve.scheduler import FairScheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "zamba2-2.7b"
SINGLE = JMeshPlan((1,), ("data",))
# float32 on both sides, products summed in other orders through the
# stack: logits and cache leaves agree to a few float32 ulps of their
# scale (as tests/test_torch_ssm.py)
TOL = 1e-4
# the paged decode against the Pallas kernel (tests/test_torch_kernels.py)
PAGED_TOL = 1e-5
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
