# Energy telemetry (port of repro.power): pluggable power backends (RAPL,
# NVML through ctypes, the analytic model), the EnergyMeter region API
# and the run's JSON report.  The tuner's objectives (repro_torch.tune)
# score with the same energy model the model backend meters with.
from .backends import (  # noqa: F401
    NVML_POLL_S,
    ModelBackend,
    NvmlBackend,
    PowerBackend,
    RaplBackend,
    WorkloadHints,
    detect_backend,
)
from .meter import EnergyMeter, EnergyReading, default_backend  # noqa: F401
from .report import (  # noqa: F401
    SCHEMA_VERSION,
    EnergyReport,
    validate_bench_payload,
    validate_report,
)
