"""Hardware descriptions for the three device families DNNExplorer's DSE
runs against.

* ``FPGASpec`` — the paper's own domain (Xilinx parts; resource units match
  the paper: DSP48 slices, 18-Kb BRAM blocks, external-memory GB/s).
* ``TPUSpec`` — the retarget domain for the JAX runtime (per-chip peak
  FLOP/s, HBM capacity/bandwidth, ICI link bandwidth), used by
  ``core/tpu_planner.py`` and the roofline analysis.
* ``GPUSpec`` — the CUDA retarget domain (per-GPU SM peak FLOP/s, HBM
  capacity/bandwidth, NVLink/InfiniBand interconnect), used by
  ``core/gpu_model.py`` / ``core/gpu_planner.py``.

Every family also carries a TDP and an hourly dollar proxy (cloud
on-demand list prices, board-power estimates for the FPGAs) so the
``repro.dse`` normalized objectives (throughput per watt / per dollar /
per peak TFLOP) can compare designs ACROSS families; the proxies are
deliberately coarse — they normalize frontiers, they don't bill anyone.
"""
from __future__ import annotations

import dataclasses


# ---------------------------------------------------------------------------
# Budget metadata (shared by repro.dse.placement)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostEnvelope:
    """A placement budget: joint caps on the hourly dollar proxy and on
    board power. ``None`` leaves that axis uncapped. The dollar/watt
    terms come from the per-part ``usd_per_hour``/``tdp_watts`` fields
    below, so a budget is expressed in the same (deliberately coarse)
    units the normalized objectives already use."""

    usd_per_hour: float | None = None
    watts: float | None = None

    #: Relative slack when testing a cost against a cap, so float sums
    #: that are *exactly* at budget don't flap infeasible.
    _REL_EPS = 1e-9

    def admits(self, usd_per_hour: float, watts: float) -> bool:
        """True iff a (dollars/hour, watts) total fits under both caps."""
        if self.usd_per_hour is not None and \
                usd_per_hour > self.usd_per_hour * (1 + self._REL_EPS):
            return False
        if self.watts is not None and \
                watts > self.watts * (1 + self._REL_EPS):
            return False
        return True

    def capped_axes(self) -> tuple[str, ...]:
        """The budgeted axis names, in (dollars, watts) order."""
        out = []
        if self.usd_per_hour is not None:
            out.append("usd_per_hour")
        if self.watts is not None:
            out.append("watts")
        return tuple(out)

    def describe(self) -> str:
        parts = []
        if self.usd_per_hour is not None:
            parts.append(f"${self.usd_per_hour:g}/h")
        if self.watts is not None:
            parts.append(f"{self.watts:g} W")
        return " and ".join(parts) if parts else "unbounded"


def pod_cost(spec, count: int = 1) -> tuple[float, float]:
    """(watts, usd_per_hour) of ``count`` instances of one part. Works for
    any spec class below — they all carry ``tdp_watts``/``usd_per_hour``
    — so placement costs FPGAs, TPU pods, and GPU pods the same way."""
    return count * spec.tdp_watts, count * spec.usd_per_hour


def scaled_spec(spec, compute_scale: float = 1.0, bw_scale: float = 1.0):
    """A copy of ``spec`` with its delivered compute rate and external
    memory bandwidth multiplied by measured correction factors — the hook
    :mod:`repro.calib` applies fitted corrections through. Family-aware:

    * ``FPGASpec`` — compute scales the clock (Eq. 1's ``freq`` term, the
      one knob that moves every pipeline/generic latency together),
      bandwidth scales ``bw_gbps``;
    * ``TPUSpec`` / ``GPUSpec`` — compute scales ``peak_flops``,
      bandwidth scales ``hbm_bw``.

    Identity scales return ``spec`` itself (not a copy), so uncalibrated
    paths stay byte-identical to passing the table spec directly."""
    if compute_scale == 1.0 and bw_scale == 1.0:
        return spec
    if isinstance(spec, FPGASpec):
        return dataclasses.replace(spec, freq_mhz=spec.freq_mhz * compute_scale,
                                   bw_gbps=spec.bw_gbps * bw_scale)
    if isinstance(spec, (TPUSpec, GPUSpec)):
        return dataclasses.replace(spec, peak_flops=spec.peak_flops * compute_scale,
                                   hbm_bw=spec.hbm_bw * bw_scale)
    raise TypeError(f"scaled_spec: unknown spec family {type(spec).__name__}")


# ---------------------------------------------------------------------------
# FPGA (faithful reproduction domain)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# TPU (retarget domain)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPUSpec:
    name: str
    peak_flops: float       # per-chip, bf16
    hbm_bytes: float        # per-chip capacity
    hbm_bw: float           # per-chip, bytes/s
    ici_bw: float           # per-link, bytes/s
    vmem_bytes: float = 128 * 2 ** 20
    # 2D torus: each chip has links on both mesh axes.
    links_per_chip: int = 4
    # Chip power and hourly dollar proxy for the normalized objectives.
    tdp_watts: float = 200.0
    usd_per_hour: float = 1.20


TPU_V5E = TPUSpec(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm_bytes=16 * 2 ** 30,
    hbm_bw=819e9,
    ici_bw=50e9,
)

TPUS = {TPU_V5E.name: TPU_V5E}


# ---------------------------------------------------------------------------
# GPU (CUDA retarget domain)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    """One NVIDIA datacenter part, as the analytic roofline in
    ``core/gpu_model.py`` sees it: SM compute peak, HBM capacity and
    bandwidth, and a two-tier interconnect — NVLink within a node of
    ``node_size`` GPUs, InfiniBand per GPU across nodes."""

    name: str
    peak_flops: float       # per-GPU, bf16 tensor-core dense
    hbm_bytes: float        # per-GPU capacity
    hbm_bw: float           # per-GPU, bytes/s
    nvlink_bw: float        # per-GPU NVLink bandwidth (one direction), bytes/s
    ib_bw: float            # per-GPU inter-node bandwidth, bytes/s
    sm_count: int
    tdp_watts: float
    usd_per_hour: float     # cloud on-demand proxy, $/GPU-hr
    node_size: int = 8      # GPUs sharing an NVLink/NVSwitch domain


# Datasheet peaks (bf16 dense, no sparsity); NVLink = per-direction
# aggregate (NVLink3: 600 GB/s bidir -> 300; NVLink4: 900 -> 450); IB = one
# NIC per GPU (DGX A100: 200 Gb/s; DGX H100: 400 Gb/s). Dollars = typical
# cloud on-demand per-GPU rates.
A100_40G = GPUSpec("a100-40g", peak_flops=312e12, hbm_bytes=40 * 2 ** 30,
                   hbm_bw=1555e9, nvlink_bw=300e9, ib_bw=25e9, sm_count=108,
                   tdp_watts=400.0, usd_per_hour=3.05)
A100_80G = GPUSpec("a100-80g", peak_flops=312e12, hbm_bytes=80 * 2 ** 30,
                   hbm_bw=2039e9, nvlink_bw=300e9, ib_bw=25e9, sm_count=108,
                   tdp_watts=400.0, usd_per_hour=3.67)
H100 = GPUSpec("h100", peak_flops=989e12, hbm_bytes=80 * 2 ** 30,
               hbm_bw=3350e9, nvlink_bw=450e9, ib_bw=50e9, sm_count=132,
               tdp_watts=700.0, usd_per_hour=6.98)

GPUS = {g.name: g for g in (A100_40G, A100_80G, H100)}
