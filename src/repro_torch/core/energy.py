"""Analytic time/energy model (port of ``repro.core.energy``).

The same first-order model as the reference:

    t_compute    = FLOPs / (chips * peak_flops * f_scale)
    t_hbm        = HBM_bytes / (chips * hbm_bw)
    t_ici        = ICI_bytes / (chips * ici_bw * ici_links)
    t            = max(t_compute, t_hbm, t_ici)           (perfect overlap)
    t_no_overlap = t_compute + t_hbm + t_ici              (pessimistic bound)

    E = FLOPs*e_flop*v(f)^2 + HBM_bytes*e_hbm + ICI_bytes*e_ici
        + t * P_static * chips

with V linear in f between (f_min, v_min) and (1, 1).  Memory bandwidth
and memory energy do not scale with the core clock.

The port ships one preset, :data:`H100`, and it is :class:`HW`'s
default.  Its rates and sizes are NVIDIA's H100 SXM5 80 GB data sheet's
(NVIDIA H100 80GB HBM3, 700 W); its energy constants are NOT fitted:
they are placeholders of the right order until a fit to the card's NVML
readings (``chip_smoke.py``'s ``study_energy`` and ``serve_modes``
lines print the measurements to fit them to).  The field names are the
reference's, so a caller can build any other part's ``HW``.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["HW", "H100", "RooflineTerms", "roofline_terms", "energy_joules",
           "clamp_f_scale", "F_SCALE_MAX"]

# highest supported DVFS point; the time and the energy side of the
# model clamp to the same [f_min, F_SCALE_MAX] range
F_SCALE_MAX = 1.25


@dataclass(frozen=True)
class HW:
    """One accelerator part.  Defaults: NVIDIA H100 SXM5 80 GB, from
    NVIDIA's H100 Tensor Core GPU data sheet (SXM column: 700 W)."""

    name: str = "h100-sxm5-80gb"
    peak_flops: float = 989e12      # dense bf16 tensor-core FLOP/s
    hbm_bw: float = 3.35e12         # HBM3 B/s
    ici_bw: float = 50e9            # NVLink B/s per link (900 GB/s / 18)
    ici_links: int = 18             # NVLink 4 links per card
    # no off-node rate on the data sheet: its PCIe Gen5 rate, the link an
    # off-node byte crosses; unused by one-card runs
    dcn_bw: float = 128e9
    hbm_per_chip: float = 80e9      # bytes of HBM3
    # the on-chip budget: shared memory one thread block may use
    # (227 KB), the SFC kernels' tile store
    vmem_per_chip: float = 232448.0
    # energy constants: NOT fitted (placeholders of the right order)
    e_flop: float = (700.0 - 70.0) / 989e12   # the power limit above static, at peak
    e_hbm: float = 30e-12           # J per HBM3 byte (~4 pJ/bit)
    e_ici: float = 10e-12           # J per NVLink byte
    e_dcn: float = 60e-12           # J per off-node byte
    p_static: float = 70.0          # W the card draws idle
    # the model's first-order DVFS shape (not fitted)
    v_min: float = 0.7              # voltage fraction at f_min
    f_min: float = 0.5              # lowest f_scale


H100 = HW()


def clamp_f_scale(hw: HW, f_scale: float) -> float:
    """Clamp a requested frequency scale to the supported DVFS range."""
    return max(hw.f_min, min(f_scale, F_SCALE_MAX))


def _voltage(hw: HW, f_scale: float) -> float:
    """Linear V(f) between (f_min, v_min) and (1.0, 1.0), clamped."""
    f = clamp_f_scale(hw, f_scale)
    slope = (1.0 - hw.v_min) / (1.0 - hw.f_min)
    return hw.v_min + slope * (f - hw.f_min)


@dataclass(frozen=True)
class RooflineTerms:
    t_compute: float
    t_hbm: float
    t_ici: float
    t_dcn: float = 0.0

    @property
    def t_overlap(self) -> float:
        return max(self.t_compute, self.t_hbm, self.t_ici, self.t_dcn)

    @property
    def t_serial(self) -> float:
        return self.t_compute + self.t_hbm + self.t_ici + self.t_dcn

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_hbm,
            "collective": self.t_ici,
            "dcn": self.t_dcn,
        }
        return max(terms, key=terms.get)

    def fraction_of_roofline(self, useful_flops: float, chips: int,
                             hw: HW = H100) -> float:
        """Useful flops / (t_overlap * peak)."""
        if self.t_overlap == 0:
            return 0.0
        return useful_flops / (self.t_overlap * chips * hw.peak_flops)


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    ici_bytes: float,
    chips: int,
    hw: HW = H100,
    f_scale: float = 1.0,
    dcn_bytes: float = 0.0,
    hosts: int | None = None,
) -> RooflineTerms:
    """Three-term roofline.  ``flops``/``bytes`` are global;
    ``ici_bytes`` is the per-chip busiest-link byte count if known, else
    global/chips is used as the per-chip estimate."""
    return RooflineTerms(
        t_compute=flops / (chips * hw.peak_flops * clamp_f_scale(hw, f_scale)),
        t_hbm=hbm_bytes / (chips * hw.hbm_bw),
        t_ici=ici_bytes / (chips * hw.ici_bw * hw.ici_links),
        t_dcn=dcn_bytes / (max(hosts or chips // 4, 1) * hw.dcn_bw),
    )


def energy_joules(
    flops: float,
    hbm_bytes: float,
    ici_bytes: float,
    chips: int,
    hw: HW = H100,
    f_scale: float = 1.0,
    dcn_bytes: float = 0.0,
    overlap: bool = True,
    wall_time: float | None = None,
) -> dict:
    """Energy breakdown in joules: ``core`` (compute dynamic), ``hbm``,
    ``ici``/``dcn`` and ``static``; plus ``total`` and the wall
    ``time`` (``wall_time`` when given, else the roofline's)."""
    terms = roofline_terms(flops, hbm_bytes, ici_bytes, chips, hw,
                           f_scale=f_scale, dcn_bytes=dcn_bytes)
    t = wall_time if wall_time is not None else (
        terms.t_overlap if overlap else terms.t_serial)
    f_scale = clamp_f_scale(hw, f_scale)  # the breakdown reports what ran
    v = _voltage(hw, f_scale)
    core = flops * hw.e_flop * (v * v) / (1.0 * 1.0)
    hbm = hbm_bytes * hw.e_hbm
    ici = ici_bytes * hw.e_ici
    dcn = dcn_bytes * hw.e_dcn
    static = t * hw.p_static * chips
    return {
        "time": t,
        "core": core,
        "hbm": hbm,
        "ici": ici,
        "dcn": dcn,
        "static": static,
        "total": core + hbm + ici + dcn + static,
        "terms": terms,
        "f_scale": f_scale,
    }
