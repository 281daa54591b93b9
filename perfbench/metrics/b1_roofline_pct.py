"""B1's share of its roofline: the least time of the window's projection
GEMMs over the rows the requests need (closed form: each GEMM the larger
of its operations at the peak and its bytes at HBM's peak) over B1's
kernel time in the device trace, in %."""
from perfbench.harness.kernels import is_b1


def read(run):
    tr = run.get("trace")
    if tr is None or not run.get("b1_least_s"):
        return None
    t = tr.seconds(is_b1)
    return 100.0 * run["b1_least_s"] / t if t > 0 else None
