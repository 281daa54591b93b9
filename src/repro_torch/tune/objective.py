"""Tuning objectives: time, energy, energy-delay product (port of
``repro.tune.objective``).

* ``"time"``   -- modelled (or measured) seconds; the default.
* ``"energy"`` -- joules from the analytic model
  (:func:`repro_torch.core.energy.energy_joules`) fed with the
  candidate's FLOPs, its simulated traffic, and its (modelled or
  measured) time for the static-power term.
* ``"edp"``    -- energy-delay product (J*s).

With a measured time the dynamic terms still come from the traffic
model while the static term uses the real time, the recipe
:class:`repro_torch.power.ModelBackend` applies to metered regions.
"""
from __future__ import annotations

from repro_torch.core.energy import H100, energy_joules

from .cost import CostEstimate

__all__ = ["OBJECTIVES", "estimate_energy", "objective_value"]

OBJECTIVES = ("time", "energy", "edp")


def estimate_energy(est: CostEstimate, hw=H100,
                    wall_time: float | None = None) -> dict:
    """Energy breakdown for one candidate estimate (single chip).

    The candidate's DVFS point (``est.config.f_scale``) feeds the
    voltage-scaled dynamic-compute term: a lower frequency buys a
    quadratic core-energy discount, paid for in time only once the
    candidate goes compute-bound -- the paper's crossover mechanism.

    ``est.ici_bytes`` (the hop-weighted collective traffic of a
    :class:`~repro_torch.tune.cost.CommSpec`-scored candidate, DESIGN.md §15)
    feeds the ``e_ici`` term, so multi-chip winners are adjudicated on
    bytes-over-links energy too, not just local HBM traffic.
    """
    t = wall_time if wall_time is not None else est.time
    return energy_joules(est.flops, est.traffic_bytes, est.ici_bytes, 1,
                         hw=hw, f_scale=est.config.f_scale, wall_time=t)


def objective_value(est: CostEstimate, objective: str = "time", hw=H100,
                    wall_time: float | None = None) -> float:
    """Scalar score (lower is better) of ``est`` under ``objective``."""
    t = wall_time if wall_time is not None else est.time
    if objective == "time":
        return t
    if objective not in OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; choose from {OBJECTIVES}")
    e = estimate_energy(est, hw=hw, wall_time=t)["total"]
    return e if objective == "energy" else e * t
