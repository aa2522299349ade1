"""Analytical NeuRRAM energy / latency / EDP model (port of
`repro/core/energy.py`, the same arithmetic in plain Python).

Calibrated to the paper's measured curves (Extended Data Fig. 10 and Methods
'Power and throughput measurements'); all numbers are MODELED, not
measured on RRAM. The model reproduces the structural facts the paper reports:

  * input stage: (n-1) pulse phases and 2^(n-1)-1 sample/integrate cycles for
    n-bit signed inputs; 1-bit and 2-bit cost the same (binary is a special
    case of ternary);
  * WL switching of thick-oxide I/O FETs dominates input-stage power;
  * output stage energy grows ~2^(m-1) with m output bits (charge-decrement);
  * 256x256 4-bit-in/8-bit-out MVM latency ~2.1 us, dominated by the neuron
    amplifier settle;
  * 5-8x EDP advantage over prior RRAM CIM macros, 20-61x peak throughput;
  * ~8x energy and ~95x latency improvement projected at 7 nm -> ~760x EDP.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .types import EnergyConfig


@dataclasses.dataclass(frozen=True)
class MVMCost:
    energy_pj: float
    latency_ns: float
    macs: int

    @property
    def ops(self) -> int:           # 1 MAC = 2 ops (convention of the paper)
        return 2 * self.macs

    @property
    def tops_per_w(self) -> float:
        return self.ops / self.energy_pj  # ops/pJ == 1e12 ops/J == TOPS/W

    @property
    def edp(self) -> float:         # pJ * ns (per full MVM)
        return self.energy_pj * self.latency_ns


def input_stage(n_bits: int, rows: int, cfg: EnergyConfig):
    """Energy (pJ) and latency (ns) of the MVM input phase on one core."""
    phases = max(n_bits - 1, 1)
    cycles = (1 << max(n_bits - 1, 1)) - 1
    row_frac = rows / 256.0
    e = phases * (cfg.e_wl_switch + cfg.e_drv_pulse) * row_frac \
        + cycles * cfg.e_samp_cycle + phases * cfg.e_digital
    t = phases * cfg.t_pulse + cycles * cfg.t_samp
    return e, t


def output_stage(m_bits: int, cols: int, cfg: EnergyConfig,
                 mean_util: float = 0.5):
    """Energy/latency of ADC conversion. Early-stop makes the *average* number
    of decrement steps ~ mean_util * 2^(m-1); worst-case sets latency."""
    steps_max = (1 << max(m_bits - 1, 0))
    col_frac = cols / 256.0
    e = steps_max * mean_util * cfg.e_decr_step * col_frac + cfg.e_digital
    t = steps_max * cfg.t_decr
    return e, t


def mvm_cost(rows: int, cols: int, in_bits: int, out_bits: int,
             cfg: EnergyConfig = EnergyConfig(), node: str = "130nm") -> MVMCost:
    """Cost of one rows x cols MVM (possibly spanning multiple 256-row
    segments, whose partial sums are accumulated digitally)."""
    import math
    row_segs = math.ceil(rows / 256)
    col_segs = math.ceil(cols / 256)
    e_in, t_in = input_stage(in_bits, min(rows, 256), cfg)
    e_out, t_out = output_stage(out_bits, min(cols, 256), cfg)
    # segments run on parallel cores: energy sums, latency does not
    e = (e_in + e_out) * row_segs * col_segs
    t = t_in + t_out
    if node == "7nm":
        e /= cfg.scale_energy_7nm
        t /= cfg.scale_latency_7nm
    return MVMCost(energy_pj=e, latency_ns=t, macs=rows * cols)


# Prior-art RRAM-CIM EDP reference points (normalized to the paper's Fig. 1d
# benchmark workload: one 1024x1024 MVM, units pJ*ns). These are PLACED to
# reproduce the paper's reported 5-8x EDP advantage cloud — both sides of the
# comparison are models here (no silicon in this container); the benchmark
# verifies the precision-scaling *structure*, not independent measurements.
PRIOR_ART_EDP: Dict[str, float] = {
    "ISSCC18-Chen(1b/3b)": 6.3e9,
    "NatElec19-Chen": 5.6e9,
    "ISSCC19-Xue": 5.0e9,
    "ISSCC20-Xue(2b/10b)": 4.4e9,
    "NatElec20-Cai": 6.1e9,
    "ISSCC20-Liu": 4.2e9,
    "NatElec21-Xue(4b/14b)": 3.9e9,
}


def neurram_edp(in_bits: int, out_bits: int,
                cfg: EnergyConfig = EnergyConfig(), node: str = "130nm"):
    """EDP of the benchmark workload the paper uses for Fig. 1d: a 1024x1024
    MVM (16 cores of 256x256 in parallel, digital partial-sum accumulation)."""
    c = mvm_cost(1024, 1024, in_bits, out_bits, cfg, node)
    return c.edp, c
