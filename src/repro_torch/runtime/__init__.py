# Serving through faults (port of repro.runtime's serving half): the
# deterministic chaos injector, the straggler watchdog and the serve-
# state snapshotter behind ServeLoop's restore-and-replay.
from .chaos import (  # noqa: F401
    ChaosEvent,
    ChaosInjector,
    InjectedFault,
    TransientFault,
    parse_chaos_spec,
)
from .fault import StragglerMonitor  # noqa: F401
from .snapshot import ServeSnapshotter  # noqa: F401
