"""The port's collectives (``repro_torch/parallel/collectives.py`` and the
mesh reshards of ``parallel/sharding.py``) against the JAX reference, on
the CPU.

The reference's ``ring_all_reduce`` and ``compressed_all_reduce`` run
under ``shard_map`` on four fake XLA devices in a subprocess, as
``tests/multidev/collectives.py`` runs them; the port's run over four
gloo ranks in subprocesses on the same numpy inputs.  The ring is equal
bit for bit in float32, on every rank.  The compressed all-reduce's
residual (``corrected - codes x scale``) is within one code of the
reference's, where the reference's jitted ``x / scale`` may round a tie
the other way (ROADMAP C2), and both means are within the reference's
``rel < 0.02`` of the exact mean.  Then the plain collectives and the
mesh reshards on a (2, 2) mesh: ``all_gather``, ``reduce_scatter``,
``all_reduce`` (sum, max, min), ``constrain`` to a pool layout and back,
``reduce_to_shard`` against the summed gradient's block.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
RANKS = 4
SPAWN_S = 240
# the reference's own limit (tests/multidev/collectives.py)
COMPRESSED_REL = 0.02

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.parallel.collectives import compressed_all_reduce, ring_all_reduce
d = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("data",))
ring = shard_map(lambda xl: ring_all_reduce(xl[0], "data")[None], mesh=mesh,
                 in_specs=P("data"), out_specs=P("data"),
                 check_vma=False)(jnp.asarray(d["x"]))
mean, err = shard_map(
    lambda xl, el: tuple(t[None] for t in
                         compressed_all_reduce(xl[0], el[0], "data")),
    mesh=mesh, in_specs=(P("data"), P("data")),
    out_specs=(P("data"), P("data")), check_vma=False)(
        jnp.asarray(d["x"]), jnp.asarray(d["err"]))
np.savez(sys.argv[2], ring=np.asarray(ring), mean=np.asarray(mean),
         err=np.asarray(err))
"""

_RANK = r"""
import datetime, os, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (PartitionSpec as P, constrain,
                                           mesh_groups, reduce_to_shard)
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
d = np.load(os.path.join(out, "inputs.npz"))
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=4, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
x = torch.from_numpy(d["x"][rank])
ring = coll.ring_all_reduce(x)
mean, err = coll.compressed_all_reduce(x, torch.from_numpy(d["err"][rank]))
# the plain collectives and the reshards on a (2, 2) mesh
mg = mesh_groups(make_host_mesh(4))
row, col = mg.coord["data"], mg.coord["model"]
data = mg.group(("data",))
column = sorted(r for r, c in mg.coords.items() if c["model"] == col)
got = coll.all_gather(x, 1, data)
assert torch.equal(got, torch.cat([torch.from_numpy(d["x"][r])
                                   for r in column], 1))
rs = coll.reduce_scatter(x, 0, data)
want = sum(torch.from_numpy(d["x"][r]) for r in column)
assert torch.allclose(rs, want.chunk(2, 0)[row], rtol=1e-6, atol=1e-6)
world = mg.group(mg.names)
assert torch.equal(coll.all_reduce(x, world, "max"),
                   torch.from_numpy(d["x"].max(0)))
assert torch.equal(coll.all_reduce(x, world, "min"),
                   torch.from_numpy(d["x"].min(0)))
whole = torch.from_numpy(d["x"][0])                # the same on every rank
pooled = constrain(whole, mg, P(("data", "model")))
assert torch.equal(pooled, whole.chunk(4, 0)[2 * row + col])
local = constrain(whole, mg, P("data", "model"))
assert torch.equal(local, whole.chunk(2, 0)[row].chunk(2, 1)[col])
assert torch.equal(constrain(pooled, mg, P(), src=P(("data", "model"))),
                   whole)
assert torch.equal(constrain(local, mg, P("data"), src=P("data", "model")),
                   whole.chunk(2, 0)[row])
try:
    constrain(whole, mg, P("model"), src=P("data"))
    raise SystemExit("a dim's axes moved without raising")
except ValueError:
    pass
# a gradient seen by the data ranks (other rows), the same over "model":
# its shard of the sum over "data"
g = torch.from_numpy(d["x"][row])
shard = reduce_to_shard(g, P("data", "model"), mg, ("data",))
total = torch.from_numpy(d["x"][0] + d["x"][1])
assert torch.allclose(shard, total.chunk(2, 0)[row].chunk(2, 1)[col],
                      rtol=1e-6, atol=1e-6)
np.savez(os.path.join(out, f"rank{rank}.npz"), ring=ring.numpy(),
         mean=mean.numpy(), err=err.numpy())
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("collectives"))
    rng = np.random.default_rng(0)
    # magnitudes spread over the ranks, so the sums' roundings matter
    x = (rng.standard_normal((RANKS, 16, 32)) *
         np.array([1.0, 3e-3, 7e2, 0.5])[:, None, None]).astype(np.float32)
    err = (0.01 * rng.standard_normal((RANKS, 16, 32))).astype(np.float32)
    inputs = os.path.join(out, "inputs.npz")
    np.savez(inputs, x=x, err=err)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                               str(port), out], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(RANKS)]
    ref = subprocess.run([sys.executable, "-c", _REFERENCE, inputs,
                          os.path.join(out, "reference.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=SPAWN_S)
    deadline = time.monotonic() + SPAWN_S
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert ref.returncode == 0, ref.stderr[-4000:]
    for r, (p, e) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}: {e[-4000:]}"
    port_out = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                for r in range(RANKS)]
    return x, err, dict(np.load(os.path.join(out, "reference.npz"))), \
        port_out


def test_ring_all_reduce_bit_for_bit(runs):
    x, _, ref, port = runs
    for r in range(RANKS):
        assert port[r]["ring"].dtype == np.float32
        assert np.array_equal(port[r]["ring"], ref["ring"][r]), r
        assert np.array_equal(port[r]["ring"], port[0]["ring"])
    np.testing.assert_allclose(port[0]["ring"], x.sum(0), rtol=1e-5,
                               atol=1e-5)


def test_compressed_all_reduce_against_reference(runs):
    x, err, ref, port = runs
    corrected = x + err
    scales = np.maximum(np.abs(corrected).max(axis=(1, 2)) / 127, 1e-30)
    exact = x.mean(0)
    for r in range(RANKS):
        # the residual: the same codes but at a rounding tie, one code off
        gap = np.abs(port[r]["err"] - ref["err"][r])
        assert gap.max() <= scales[r] * (1 + 1e-5), (r, gap.max())
        assert np.mean(gap > scales[r] * 1e-3) < 0.01
        # each member adds the ring's payloads from its own onwards, as
        # the reference's does: its mean within one code a member of the
        # reference member's
        np.testing.assert_allclose(
            port[r]["mean"], ref["mean"][r],
            atol=float(scales.sum()) / RANKS * (1 + 1e-5))
        for got in (port[r]["mean"], ref["mean"][r]):
            rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
            assert rel < COMPRESSED_REL, rel
