"""Hardware cost model for StruM configurations (paper Fig. 13 + Eq. 1/2),
a torch-free copy of ``repro.autotune.costmodel``.

This promotes the PE / PE-array / DPU area & power arithmetic that used to
live inside ``benchmarks/fig13_efficiency.py`` into importable library code,
so the schedule search (:mod:`repro.autotune.search`) can price every
candidate ``StruMConfig`` — not just render one figure.  The paper's numbers
are post-PnR silicon results (Chisel → 3 nm) that no software container can
measure; everything here is an analytic model normalized to one INT8×INT8
multiplier = 1.0 (area and energy).

Component model (unchanged from the Fig.-13 benchmark):

  * a barrel shifter costs a small fraction of a multiplier (shift networks
    are O(b·log b) muxes vs O(b²) partial-product cells); the reduced-range
    L=5 shifter is cheaper than full-range L=7;
  * the PE also carries RFs (208 B, paper §VI), find-first sparsity logic
    and control that StruM does not touch;
  * the DPU adds 1.5 MB SRAM + load/drain units.

New here: a per-config cost estimate combining the MAC-level energy/area
with an HBM traffic term from Eq. 1/2 — decode serving is weight-bandwidth
bound (the roofline's memory leg), so the bytes a config streams per use of
the tensor dominate its deployment energy.  ``HBM_ENERGY_PER_BYTE`` is the
DRAM-access energy in multiplier units (off-chip access is ~2 orders of
magnitude above an int8 MAC at modern nodes); it only needs to be *ordered*
correctly for the search — candidate ranking, not absolute joules.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.policy import StruMConfig

__all__ = [
    "SHIFT", "GATED_LEAK", "DYN_ROUTE_AREA", "PE_OVERHEAD", "DPU_OVERHEAD",
    "N_MULS", "P_REPLACED", "HBM_ENERGY_PER_BYTE",
    "CostEstimate", "shift_cost", "low_unit_cost", "pe_mac_cost",
    "config_cost", "level_savings",
]

# normalized component costs relative to one INT8 multiplier
SHIFT = {7: dict(area=0.16, power=0.13),   # full-range barrel shifter
         5: dict(area=0.07, power=0.05)}   # reduced range [-5,5]
GATED_LEAK = 0.02                          # clock-gated multiplier residual
DYN_ROUTE_AREA = 0.43                      # per-MAC operand mux/route network
#   (the dynamically-configurable PE of Fig. 9 needs operand steering between
#    each multiplier and its shadow shifter + the config register fabric)
# non-MAC PE overhead (RFs, find-first, control), per unit of baseline MACs
PE_OVERHEAD = dict(area=0.80, power=0.40)
# DPU uncore (SRAM, load/drain, NoC), per unit of baseline PE cost
DPU_OVERHEAD = dict(area=8.50, power=1.95)

N_MULS = 8          # MACs per PE (paper §VI)
P_REPLACED = 0.5    # Fig.-13 reference point: half the multipliers shift

# HBM access energy per byte, in INT8-multiplier-energy units.  DRAM reads
# cost pJ while an int8 MAC costs tens of fJ; 60x keeps decode serving
# firmly memory-dominated, matching the roofline's verdict for weight
# streaming (benchmarks/roofline.py).
HBM_ENERGY_PER_BYTE = 60.0


def shift_cost(L: int, metric: str) -> float:
    """Barrel-shifter cost for max shift ``L`` (area or power).

    L ∈ {5, 7} are the paper-calibrated points; other ranges extrapolate
    linearly in (L+1) — mux depth grows with the representable range.
    """
    if L in SHIFT:
        return SHIFT[L][metric]
    base = 0.16 / 8.0 if metric == "area" else 0.13 / 8.0
    return base * (L + 1)


def low_unit_cost(cfg: StruMConfig, metric: str) -> float:
    """Cost of the unit processing one *low-precision* element.

    sparsity — zeros are skipped entirely (the find-first logic that does
    the skipping sits in PE_OVERHEAD); dliq — a q×8 multiplier, whose
    partial-product array scales ~quadratically in the narrow operand's
    width; mip2q — the barrel shifter.
    """
    if cfg.method == "sparsity":
        return 0.0
    if cfg.method == "dliq":
        return (cfg.q / 8.0) ** 2
    return shift_cost(cfg.L, metric)


def pe_mac_cost(cfg: Optional[StruMConfig], metric: str) -> float:
    """Normalized MAC-cluster cost of one statically-configured 8-MAC PE.

    ``None`` (plain INT8) keeps all N_MULS multipliers.  Otherwise a
    p-fraction of the multipliers is replaced by the config's low-precision
    unit — the paper's static PE, generalized beyond p = 0.5.
    """
    if cfg is None:
        return N_MULS * 1.0
    n_low_units = int(round(cfg.p * N_MULS))
    return (N_MULS - n_low_units) * 1.0 + n_low_units * low_unit_cost(cfg, metric)


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Deployment cost of serving one tensor under one config.

    energy  — normalized: compute (per-element MAC mix) + HBM stream
              (bytes × HBM_ENERGY_PER_BYTE) per full use of the tensor.
    area    — normalized PE area (MAC cluster + overhead) of a static PE
              built for this config.
    bytes   — HBM bytes of the packed tensor (Eq. 1/2 × the int8 baseline).
    """

    energy: float
    area: float
    bytes: int

    def astuple(self) -> tuple:
        return (self.energy, self.area, self.bytes)


def config_cost(cfg: Optional[StruMConfig], n_elements: int) -> CostEstimate:
    """Price one tensor of ``n_elements`` int8 weights under ``cfg``.

    ``cfg=None`` is the plain-INT8 fallback (ratio 1.0, full multipliers).
    """
    ratio = 1.0 if cfg is None else cfg.compression_ratio
    nbytes = int(round(n_elements * ratio))
    if cfg is None:
        compute = float(n_elements)
    else:
        compute = n_elements * ((1.0 - cfg.p) * 1.0
                                + cfg.p * low_unit_cost(cfg, "power"))
    energy = compute + nbytes * HBM_ENERGY_PER_BYTE
    area = pe_mac_cost(cfg, "area") + PE_OVERHEAD["area"] * N_MULS
    return CostEstimate(energy=energy, area=area, bytes=nbytes)


# ---------------------------------------------------------------------------
# Fig.-13 reference arithmetic (p = 0.5, mip2q), verbatim from the benchmark
# ---------------------------------------------------------------------------

def _costs(L: int, metric: str, dynamic: bool) -> tuple:
    """(baseline_pe, strum_pe, baseline_mac, strum_mac) normalized costs."""
    n_shift = int(N_MULS * P_REPLACED)
    base_mac = N_MULS * 1.0
    if dynamic and metric == "area":
        # shifters instantiated ON TOP of all 8 multipliers (Fig. 9),
        # plus the operand-steering network
        strum_mac = (N_MULS * 1.0 + n_shift * SHIFT[L]["area"]
                     + N_MULS * DYN_ROUTE_AREA)
    else:
        strum_mac = (N_MULS - n_shift) * 1.0 + n_shift * SHIFT[L][metric]
        if dynamic:  # power: gated multipliers still leak a little
            strum_mac += n_shift * GATED_LEAK
    ovh = PE_OVERHEAD[metric] * base_mac
    return base_mac + ovh, strum_mac + ovh, base_mac, strum_mac


def level_savings(L: int, dynamic: bool = False) -> dict:
    """Fractional area/power savings at PE / MAC-cluster / DPU level.

    The two overhead ratios are calibrated so the BASELINE structure matches
    the paper's dilution pattern (PE-level savings ≫ DPU-level savings);
    with them fixed, the L=7 vs L=5 and static vs dynamic deltas are
    predictions that land inside every range the paper reports:
    PE 23-26% area / 31-34% power, DPU 2-3% area (static), ~+3% area
    (dynamic), 10-12% power — asserted in tests/test_benchmarks.py.
    """
    out = {}
    for metric in ("area", "power"):
        base_pe, strum_pe, base_mac, strum_mac = _costs(L, metric, dynamic)
        uncore = DPU_OVERHEAD[metric] * base_pe
        out[metric] = {
            "pe": 1 - strum_pe / base_pe,
            "mac_cluster": 1 - strum_mac / base_mac,
            "dpu": 1 - (strum_pe + uncore) / (base_pe + uncore),
        }
    return out
