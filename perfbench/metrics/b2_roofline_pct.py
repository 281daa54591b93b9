"""B2's share of its roofline: the K/V bytes the window's decode rows
must read, at HBM's peak, over B2's kernel time in the device trace,
in %."""
from perfbench.harness.kernels import is_b2


def read(run):
    tr = run.get("trace")
    if tr is None or not run.get("b2_least_s"):
        return None
    t = tr.seconds(is_b2)
    return 100.0 * run["b2_least_s"] / t if t > 0 else None
