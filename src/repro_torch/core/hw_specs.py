"""FPGA descriptions for the port's DSE screen: ``FPGASpec``, the paper's
four boards, ``FPGAS`` and ``alpha_for``.

A line-for-line copy of the FPGA part of ``repro/core/hw_specs.py``, kept
here so that the port imports nothing of ``repro``;
``tests/test_torch_screen.py`` checks that the two agree.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FPGASpec:
    name: str
    dsp: int            # DSP48 slices
    bram18k: int        # 18-Kb BRAM blocks
    bw_gbps: float      # external memory bandwidth, GB/s
    freq_mhz: float = 200.0
    # Place-and-route headroom: the paper's best designs use <=85% of DSPs
    # (Table 3 peaks at 4686 of 5520) — routing congestion caps utilization.
    usable_frac: float = 0.85
    # Board power and hourly dollar proxy for the normalized objectives.
    tdp_watts: float = 75.0
    usd_per_hour: float = 1.0

    @property
    def freq(self) -> float:
        return self.freq_mhz * 1e6

    @property
    def dsp_usable(self) -> int:
        return int(self.dsp * self.usable_frac)

    @property
    def bram_usable(self) -> int:
        return int(self.bram18k * self.usable_frac)

    @property
    def bram_bits(self) -> int:
        return self.bram18k * 18 * 1024

    def peak_gops(self, alpha: int = 2) -> float:
        """Peak throughput (GOP/s) per Eq. 1: alpha ops per DSP per cycle."""
        return alpha * self.dsp_usable * self.freq / 1e9


# Specs from Xilinx datasheets; BW = one effective DDR4-2400 channel per
# accelerator (calibrated so the batch=1 small-input cases of Table 3 are
# bandwidth-bound at the paper's measured throughput). Power = typical
# board TDP; dollars = cloud FPGA proxy (VU9P anchors at the AWS F1 rate,
# the others scale by fabric size).
KU115 = FPGASpec("ku115", dsp=5520, bram18k=4320, bw_gbps=19.2,
                 tdp_watts=75.0, usd_per_hour=1.35)
ZC706 = FPGASpec("zc706", dsp=900, bram18k=1090, bw_gbps=12.8,    # DDR3-1600
                 tdp_watts=20.0, usd_per_hour=0.35)
VU9P = FPGASpec("vu9p", dsp=6840, bram18k=4320, bw_gbps=38.4,     # 2 channels
                tdp_watts=85.0, usd_per_hour=1.65)
ZCU102 = FPGASpec("zcu102", dsp=2520, bram18k=1824, bw_gbps=19.2,
                  tdp_watts=40.0, usd_per_hour=0.60)

FPGAS = {f.name: f for f in (KU115, ZC706, VU9P, ZCU102)}


def alpha_for(bits: int) -> int:
    """MAC-ops per DSP per cycle (Eq. 1): 2 for 16-bit, 4 for 8-bit inputs."""
    if bits <= 8:
        return 4
    return 2


