"""B5's share of its roofline: the least time of the window's routed
expert GEMMs (closed form, ``harness/flops_moe.py::expert_least_s``: per
step and moe layer the larger of the assignments' operations at the bf16
peak and the touched experts' weights plus the rows at HBM's peak, the
experts as the reference routes the step's tokens) over the time of the
kernels named ``sfc_matmul_grouped`` in the device trace, in %."""


def is_b5(name: str) -> bool:
    """The grouped kernel of ``csrc/sfc_matmul_grouped.cu``, by the base
    of its demangled name."""
    base = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    base = base.strip().removeprefix("void ").strip()
    return base.split("<", 1)[0] == "sfc_matmul_grouped"


def read(run):
    tr = run.get("trace")
    if tr is None or not run.get("b5_least_s"):
        return None
    t = tr.seconds(is_b5)
    return 100.0 * run["b5_least_s"] / t if t > 0 else None
