"""The port's copy of the paper's analytic simulator against the JAX
reference's, on the CPU.

The simulator is host arithmetic over Python floats (``math``), copied
line for line, so every table must equal the reference's exactly: the
Table III workload DAGs, ``simulate`` and the Fig. 13 ``speedup_table``
in data- and model-parallel mode over every workload and design point
(so the port gives the paper's 3.5x / 2.1x / 2.8x band as the
reference's ``tests/test_sim.py`` states it), ``harmonic_mean``, the
Table IV power model, ``checkpoint_table``, ``simulate_pipeline`` and
``serving_table`` on a seeded ``generate_traffic`` trace.  These are
modelled figures of the paper's device, not measurements.
"""
import dataclasses

import pytest

from repro.sim import power as jpower
from repro.sim import simulator as jsim
from repro.sim import topology as jtopo
from repro.sim import workloads as jwork
from repro_torch import sim as tsim_pkg
from repro_torch.sim import power as tpower
from repro_torch.sim import simulator as tsim
from repro_torch.sim import topology as ttopo
from repro_torch.sim import workloads as twork


def _systems(topo):
    return topo.ALL_SYSTEMS


@pytest.fixture(scope="module")
def dags():
    return ({k: f() for k, f in twork.WORKLOADS.items()},
            {k: f() for k, f in jwork.WORKLOADS.items()})


def test_exports_and_workloads_match_reference(dags):
    for name in ("StepResult", "simulate", "speedup_table", "harmonic_mean",
                 "ALL_SYSTEMS", "SYSTEMS_BY_NAME", "DC_DLA", "DC_DLA_GEN4",
                 "DC_DLA_O", "HC_DLA", "MC_DLA_B", "MC_DLA_L", "MC_DLA_S",
                 "SystemConfig", "WORKLOADS", "CNNS", "RNNS"):
        assert hasattr(tsim_pkg, name), name
    assert twork.CNNS == jwork.CNNS and twork.RNNS == jwork.RNNS
    got, want = dags
    assert list(got) == list(want)
    for name in want:
        assert [dataclasses.astuple(n) for n in got[name].layers] == \
            [dataclasses.astuple(n) for n in want[name].layers], name
    for batch in (128, 256, 1024):
        for name, fn in twork.WORKLOADS.items():
            assert [dataclasses.astuple(n) for n in fn(batch).layers] == \
                [dataclasses.astuple(n) for n in
                 jwork.WORKLOADS[name](batch).layers]


def test_systems_match_reference():
    tsys, jsys = _systems(ttopo), _systems(jtopo)
    assert [s.name for s in tsys] == [s.name for s in jsys]
    for t, j in zip(tsys, jsys):
        assert dataclasses.astuple(t.backing_tier) == \
            dataclasses.astuple(j.backing_tier)
        assert (t.n_devices, t.n_sockets) == (j.n_devices, j.n_sockets)
        assert dataclasses.astuple(t.device) == dataclasses.astuple(j.device)
        for n in (1, 4, 8, 16):
            assert t.backing_tier.effective_bw(n, t.n_sockets) == \
                j.backing_tier.effective_bw(n, j.n_sockets)


@pytest.mark.parametrize("parallel", ["dp", "mp"])
def test_speedup_table_equals_reference(dags, parallel):
    got = tsim.speedup_table(dags[0], _systems(ttopo), parallel)
    want = jsim.speedup_table(dags[1], _systems(jtopo), parallel)
    assert got == want
    hm = tsim.harmonic_mean([got[w]["MC-DLA(B)"] for w in got])
    assert hm == jsim.harmonic_mean([want[w]["MC-DLA(B)"] for w in want])


def test_headline_band_as_the_reference_states_it(dags):
    """The reference's ``test_headline_speedup_band`` on the port's
    tables: MC-DLA(B) 3.5x dp / 2.1x mp / 2.8x overall vs DC-DLA."""
    def hm(mode):
        tab = tsim.speedup_table(dags[0], _systems(ttopo), mode)
        return tsim.harmonic_mean([tab[w]["MC-DLA(B)"] for w in tab])
    dp, mp = hm("dp"), hm("mp")
    overall = tsim.harmonic_mean([dp, mp])
    assert 3.0 <= dp <= 5.0 and 1.4 <= mp <= 2.8 and 2.0 <= overall <= 3.6


@pytest.mark.parametrize("virtualize", [True, False])
def test_simulate_breakdowns_equal_reference(dags, virtualize):
    for name in dags[1]:
        for t, j in zip(_systems(ttopo), _systems(jtopo)):
            for parallel in ("dp", "mp"):
                for n in (None, 1, 4, 8):
                    got = tsim.simulate(dags[0][name], t, parallel,
                                        n_devices=n, virtualize=virtualize)
                    want = jsim.simulate(dags[1][name], j, parallel,
                                         n_devices=n, virtualize=virtualize)
                    assert dataclasses.astuple(got) == \
                        dataclasses.astuple(want)


def test_harmonic_mean_equals_reference():
    for xs in ([1.0], [2.0, 4.0], [5.46, 14.92, 11.65, 13.31], [0.3] * 7):
        assert tsim.harmonic_mean(xs) == jsim.harmonic_mean(xs)


def test_power_model_equals_reference():
    assert tpower.table4() == jpower.table4()
    assert [dataclasses.astuple(d) for d in tpower.DIMM_OPTIONS] == \
        [dataclasses.astuple(d) for d in jpower.DIMM_OPTIONS]
    for t, j in zip(tpower.DIMM_OPTIONS, jpower.DIMM_OPTIONS):
        assert tpower.system_overhead(t) == jpower.system_overhead(j)
        for speedup in (1.0, 2.1, 2.8, 3.5):
            assert tpower.perf_per_watt(speedup, t) == \
                jpower.perf_per_watt(speedup, j)


@pytest.mark.parametrize("async_saves", [True, False])
def test_checkpoint_table_equals_reference(dags, async_saves):
    def state(name):
        return 14.0 * sum(n.weight_bytes for n in dags[1][name].layers)
    for mtbf in (10, 10_000):
        got = tsim.checkpoint_table(dags[0], _systems(ttopo), state,
                                    mtbf_steps=mtbf, async_saves=async_saves)
        want = jsim.checkpoint_table(dags[1], _systems(jtopo), state,
                                     mtbf_steps=mtbf,
                                     async_saves=async_saves)
        assert {w: {s: dataclasses.astuple(c) for s, c in row.items()}
                for w, row in got.items()} == \
            {w: {s: dataclasses.astuple(c) for s, c in row.items()}
             for w, row in want.items()}


def test_simulate_pipeline_equals_reference(dags):
    for name in ("VGG-E", "ResNet", "RNN-GRU"):
        for t, j in zip(_systems(ttopo), _systems(jtopo)):
            for stages, micro in ((2, 4), (4, 8), (4, 32)):
                for schedule in ("1f1b", "gpipe"):
                    got = tsim.simulate_pipeline(dags[0][name], t, stages,
                                                 micro, schedule)
                    want = jsim.simulate_pipeline(dags[1][name], j, stages,
                                                  micro, schedule)
                    assert dataclasses.astuple(got) == \
                        dataclasses.astuple(want)


def test_serving_table_equals_reference():
    spec = dict(sessions=400, horizon_s=600.0, seed=3)
    ttrace = twork.generate_traffic(twork.TrafficSpec(**spec))
    jtrace = jwork.generate_traffic(jwork.TrafficSpec(**spec))
    got = tsim.serving_table(ttrace, _systems(ttopo), engines=4)
    want = jsim.serving_table(jtrace, _systems(jtopo), engines=4)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert [r.rows() for r in got] == [r.rows() for r in want]
