# Faults (port of repro.runtime): the deterministic chaos injector, the
# straggler watchdog and the serve-state snapshotter behind ServeLoop's
# restore-and-replay; the failure injector and the retrying step
# executor behind the train loop.
from .chaos import (  # noqa: F401
    ChaosEvent,
    ChaosInjector,
    InjectedFault,
    TransientFault,
    parse_chaos_spec,
)
from .fault import FailureInjector, InjectedFailure, StepExecutor, \
    StragglerMonitor  # noqa: F401
from .snapshot import ServeSnapshotter  # noqa: F401
