"""Static analysis passes over kernel configs and SFC schedules (port
of ``repro.analysis``); nothing is launched.

* :mod:`repro_torch.analysis.contracts` -- kernel contract checker:
  block structure, the on-chip budget (under the H100 the port's
  kernels' own: B1's tiles, B2's shared memory), closed-form decode
  existence, grid replay (in-bounds reads, exactly-once output-tile
  writes), and the paged-attention block-table contract.
* :mod:`repro_torch.analysis.schedule` -- schedule verifier: bijection
  proofs for every ``grid_schedule`` permutation, an independent LRU
  stack-distance traffic model cross-checked against ``tune.cost``, and
  the ring all-reduce link model against a per-step simulation.

``python -m repro_torch.analysis`` runs them and emits a JSON report.
The reference's third pass, its HLO traffic auditor
(``repro/analysis/hlo_audit.py`` over ``launch/hlo.py``), reads XLA's
compiled HLO and has no counterpart here (the report names it under
``omitted``).
"""
from .contracts import (ContractReport, Violation, check_attn_contract,
                        check_gemm_contract, gemm_launch_key,
                        gemm_vmem_bytes)
from .schedule import (STATIC_DRIFT_TOL, crosscheck_cost_model,
                       crosscheck_link_model, stack_distance_traffic,
                       verify_order, verify_schedule)

__all__ = [
    "Violation", "ContractReport", "check_gemm_contract",
    "check_attn_contract", "gemm_vmem_bytes", "gemm_launch_key",
    "verify_order", "verify_schedule", "stack_distance_traffic",
    "crosscheck_cost_model", "crosscheck_link_model", "STATIC_DRIFT_TOL",
]
