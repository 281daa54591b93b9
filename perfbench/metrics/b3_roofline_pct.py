"""B3's share of its roofline: each launch's least time, the larger of
2 b n^3 operations at the f32 peak and 12 b n^2 bytes at HBM's peak,
summed over the window, over B3's kernel time in the device trace,
in %."""
from perfbench.harness.kernels import is_b3


def read(run):
    tr = run.get("trace")
    if tr is None or not run.get("b3_least_s"):
        return None
    t = tr.seconds(is_b3)
    return 100.0 * run["b3_least_s"] / t if t > 0 else None
