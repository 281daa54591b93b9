"""Seconds from the run's start (the interpreter's first line of
``run.py``: imports, the CUDA context, kernels built or loaded, inputs
and weights drawn on the card, every shape warmed up, serving's ramp)
to the window's start."""


def read(run):
    return run["setup_s"]
