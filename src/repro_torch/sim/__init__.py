"""The paper's evaluation, reproduced: analytic event-timeline simulator
over the DC/HC/MC system design points (§IV-§V), the 8 Table-III workloads,
and the Table-IV power model.  Host arithmetic, line for line the
reference's; its figures model the paper's device (``hw.PAPER_DEVICE``),
they are not measurements of the card."""
from repro_torch.sim.simulator import (StepResult, harmonic_mean, simulate,
                                      speedup_table)
from repro_torch.sim.topology import (ALL_SYSTEMS, SYSTEMS_BY_NAME, DC_DLA,
                                      DC_DLA_GEN4, DC_DLA_O, HC_DLA, MC_DLA_B,
                                      MC_DLA_L, MC_DLA_S, SystemConfig)
from repro_torch.sim.workloads import CNNS, RNNS, WORKLOADS
