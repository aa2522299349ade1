"""Configuration dataclasses for the NeuRRAM behavioral model (PyTorch port
of `repro/core/types.py`).

All configs are frozen (hashable). Units follow the paper: conductance in
microsiemens (uS), voltage in volts.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """RRAM device-level parameters (paper Methods, 'RRAM write-verify...')."""
    g_min: float = 1.0      # uS — low conductance state
    g_max: float = 40.0     # uS — 40 for CNNs, 30 for LSTM/RBM in the paper
    # Conductance relaxation: Gaussian, sigma peaks ~3.87uS near 12uS state,
    # ~2.8uS average after 1 programming iteration, ~2.0uS after 3 iterations.
    relax_sigma_peak: float = 3.87      # uS
    relax_sigma_peak_g: float = 12.0    # uS, conductance where sigma peaks
    relax_sigma_floor: float = 0.5      # uS, sigma near g_min / g_max
    # Write-verify programming (paper: 1.2V SET / 1.5V RESET, 0.1V increments,
    # +-1uS acceptance, 30 polarity-reversal timeout).
    accept_range: float = 1.0           # uS
    max_reversals: int = 30
    set_v0: float = 1.2
    reset_v0: float = 1.5
    v_increment: float = 0.1


@dataclasses.dataclass(frozen=True)
class NonIdealityConfig:
    """Switches for hardware non-idealities (i)-(vii) of paper Fig. 3a."""
    ir_drop_alpha: float = 0.0       # (i)+(ii): driver droop per unit total
                                     # activated conductance (1/uS)
    wire_r_alpha: float = 0.0        # (iii): crossbar wire IR drop
    coupling_sigma: float = 0.0      # (vi): capacitive coupling noise
    adc_offset_sigma: float = 0.0    # (vii): per-neuron ADC offset spread (V)


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    """One CIM MVM configuration = one NeuRRAM core operating point."""
    in_bits: int = 4                 # 1..8 (signed: 1 sign + in_bits-1 magnitude)
    out_bits: int = 8                # 1..8 (signed: 1 sign + out_bits-1 magnitude)
    v_read: float = 0.5              # V (paper: 0.5V read voltage at 130nm)
    activation: str = "none"         # none | relu | tanh | sigmoid | stochastic
    device: DeviceConfig = DeviceConfig()
    nonideal: NonIdealityConfig = NonIdealityConfig()

    def __post_init__(self):
        # the serving knob (--cim-bits) sweeps the paper's Fig. 1d range;
        # out of it the bit-serial folding / ADC count model is meaningless
        if not 1 <= self.in_bits <= 8:
            raise ValueError(f"in_bits must be in 1..8, got {self.in_bits}")
        if not 1 <= self.out_bits <= 8:
            raise ValueError(f"out_bits must be in 1..8, got {self.out_bits}")

    @property
    def in_mag_bits(self) -> int:
        return max(self.in_bits - 1, 1)

    @property
    def out_mag_levels(self) -> int:
        # paper: N_max = 128 decrement steps -> at most 1 sign + 7 magnitude bits
        return (1 << max(self.out_bits - 1, 0)) - 1 if self.out_bits > 1 else 1

    @property
    def in_max(self) -> int:
        return (1 << (self.in_bits - 1)) - 1 if self.in_bits > 1 else 1


@dataclasses.dataclass(frozen=True)
class CoreSpec:
    """Physical geometry of one CIM core (TNSA)."""
    rows: int = 256
    cols: int = 256
    n_cores: int = 48


@dataclasses.dataclass(frozen=True)
class EnergyConfig:
    """Analytical energy/latency model calibrated to Extended Data Fig. 10.

    All constants are per-256-wire core events, modeled (fit to the
    paper's measured curves), not measured on any device.
    """
    # Input stage (per input pulse phase, 256 rows). Calibrated so that (a) WL
    # switching of the thick-oxide I/O FETs dominates (Ext. Data Fig. 10c),
    # (b) TOPS/W lands in the paper's measured range (~30 at 4b/8b, >100 at
    # binary/ternary), (c) 256x256 4b-in MVM latency ~2.1 us.
    e_wl_switch: float = 450.0    # pJ — WL on/off (dominant; thick-oxide I/O FETs)
    e_drv_pulse: float = 150.0    # pJ — BL/SL driver pulse on active rows
    e_samp_cycle: float = 60.0    # pJ — sample+integrate cycle, all 256 neurons
    # Output stage (per comparison/charge-decrement step, 256 neurons):
    e_decr_step: float = 26.0     # pJ
    e_digital: float = 70.0       # pJ — control/readout per phase
    # Latency (neuron amplifier settle dominates — paper Methods):
    t_pulse: float = 50.0         # ns — WL pulse + settle (voltage-mode: short)
    t_samp: float = 200.0         # ns — sample/integrate cycle (amp settle)
    t_decr: float = 80.0          # ns — compare + decrement step
    # 7nm projection factors (paper Methods):
    scale_energy_7nm: float = 8.0
    scale_latency_7nm: float = 95.0
