# Static checks (port of repro.analysis): the kernel contract checker
# the tuner calls.  The schedule verifier's cost cross-check and the HLO
# audit are not ported (ROADMAP queue A, A14).
from .contracts import (  # noqa: F401
    ContractReport,
    Violation,
    check_attn_contract,
    check_gemm_contract,
    gemm_launch_key,
    gemm_vmem_bytes,
)
