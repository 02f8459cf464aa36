"""The port's sharding planner and mesh helpers against the JAX reference,
on the CPU.

Every ``(shape, assignment, name)`` the reference's ``ShardingPlanner.spec``
sees while ``param_specs`` and ``cache_specs`` build the specs of the ten
configurations, at the single-pod, multi-pod and host-test plans, is
replayed through the port's planner: the same specs and the same
``fallbacks``, bit for bit.  Then ``logical_to_spec`` for every role,
``plan_for``, ``make_host_mesh`` (``None`` on one device; a DeviceMesh
over a two-rank gloo group) and the DTensor placements of a spec.
"""
import itertools
import os
import socket
import subprocess
import sys

import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import HOST_TEST as JHOST_TEST
from repro.configs.base import MULTI_POD as JMULTI_POD
from repro.configs.base import SINGLE_POD as JSINGLE_POD
from repro.launch import mesh as jmesh
from repro.models import transformer as jtfm
from repro.parallel import sharding as jsharding
from repro_torch.configs.base import HOST_TEST, MULTI_POD, SINGLE_POD
from repro_torch.launch import mesh as tmesh
from repro_torch.parallel import sharding as tsharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANS = {"single_pod": (JSINGLE_POD, SINGLE_POD),
         "multi_pod": (JMULTI_POD, MULTI_POD),
         "host_test": (JHOST_TEST, HOST_TEST)}
# (batch, seq) of the caches: the decode cells and an odd batch
CACHE_SHAPES = [(128, 32768), (1, 524288), (3, 1000)]


class _Recording(jsharding.ShardingPlanner):
    """The reference's planner, keeping every call to ``spec``."""

    def __init__(self, plan):
        super().__init__(plan)
        self.calls = []

    def spec(self, shape, assignment, name="?"):
        self.calls.append((tuple(shape), tuple(assignment), name))
        return super().spec(shape, assignment, name)


def _as_tuple(spec):
    return tuple(spec)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_specs_and_fallbacks_bit_for_bit(arch, plan):
    jplan, tplan = PLANS[plan]
    ref = _Recording(jplan)
    want = [jtfm.param_specs(JARCHS[arch], ref)]
    want += [jtfm.cache_specs(JARCHS[arch], ref, b, s)
             for b, s in CACHE_SHAPES]
    assert ref.calls, "the reference built no spec"
    port = tsharding.ShardingPlanner(tplan)
    check = jsharding.ShardingPlanner(jplan)
    for shape, assignment, name in ref.calls:
        got = port.spec(shape, assignment, name)
        assert isinstance(got, tsharding.PartitionSpec)
        assert _as_tuple(got) == _as_tuple(
            check.spec(shape, assignment, name)), (shape, assignment, name)
    assert port.fallbacks == ref.fallbacks == check.fallbacks


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_logical_to_spec_every_role(plan):
    jplan, tplan = PLANS[plan]
    roles = [None, "batch", "fsdp", "tensor", "expert", "seq"]
    jp, tp = jsharding.ShardingPlanner(jplan), tsharding.ShardingPlanner(
        tplan)
    for logical in itertools.product(roles, repeat=2):
        for shape in [(512, 4096), (9, 576), (36, 32), (2, 1)]:
            got = tsharding.logical_to_spec(tp, shape, logical, "x")
            want = jsharding.logical_to_spec(jp, shape, logical, "x")
            assert _as_tuple(got) == _as_tuple(want), (logical, shape)
    assert tp.fallbacks == jp.fallbacks
    assert tp.axes.batch == jp.axes.batch
    assert tp.axes.size(tp.axes.batch) == jp.axes.size(jp.axes.batch)


def test_plan_for_and_host_mesh_of_one():
    for multi in (False, True):
        got, want = tmesh.plan_for(multi_pod=multi), jmesh.plan_for(
            multi_pod=multi)
        assert (got.shape, got.axes) == (want.shape, want.axes)
    assert jmesh.make_host_mesh(1) is None
    assert tmesh.make_host_mesh(1) is None
    assert tmesh.make_host_mesh() is None          # no process group: one
    with pytest.raises(NotImplementedError, match="A8"):
        tmesh.make_production_mesh()
    with pytest.raises(NotImplementedError, match="A8"):
        tmesh.make_production_mesh(multi_pod=True)


class _Mesh:
    """What ``placements`` reads of a DeviceMesh."""

    def __init__(self, names, size=1):
        self.mesh_dim_names, self.ndim, self._size = names, len(names), size

    def size(self):
        return self._size


def test_placements_and_constrain_off_mesh():
    from torch.distributed.tensor import Replicate, Shard
    P = tsharding.PartitionSpec
    mesh = _Mesh(("pod", "data", "model"))
    assert tsharding.placements(mesh, P(("pod", "data"), None, "model")) \
        == (Shard(0), Shard(0), Shard(2))
    assert tsharding.placements(mesh, P()) == (Replicate(),) * 3
    assert tsharding.placements(_Mesh(("data", "model")), P(None, "data")) \
        == (Shard(1), Replicate())
    with pytest.raises(ValueError):
        tsharding.placements(_Mesh(("data",)), P("model"))
    x = torch.ones(3)
    assert tsharding.constrain(x, None, P("data")) is x
    assert tsharding.constrain(x, _Mesh(("data",), 1), P("data")) is x
    # on a larger mesh constrain slices or gathers a local shard
    # (tests/test_torch_collectives.py runs it over four gloo ranks)
    assert repr(P("data", None)) == "PartitionSpec('data', None)"


_TWO_RANKS = r"""
import sys, torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch.configs.base import HOST_TEST
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel.sharding import ShardingPlanner
dist.init_process_group("gloo", init_method="tcp://localhost:{port}",
                        world_size=2, rank=int(sys.argv[1]))
mesh = make_host_mesh(2)
pl = ShardingPlanner(HOST_TEST).named(mesh, (8, 6), [("data",), "model"])
print(tuple(mesh.shape), mesh.mesh_dim_names, pl, flush=True)
dist.destroy_process_group()
"""


def test_host_mesh_over_two_gloo_ranks():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = _TWO_RANKS.format(src=os.path.join(REPO, "src"), port=port)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        # HOST_TEST's model axis (2) divides 6: dim 1 is split over it
        assert out.strip() == ("(2, 1) ('data', 'model') "
                               "(Shard(dim=0), Shard(dim=1))"), out
