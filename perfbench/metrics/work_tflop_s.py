"""Useful operations completed in the window, counted in closed form
from the configuration's shapes and the work done, over the window's
seconds, in TFLOP/s."""


def read(run):
    if run.get("kind") != "gemm_study":
        return None
    return run["useful_flops"] / run["window_s"] / 1e12
