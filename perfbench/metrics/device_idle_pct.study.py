"""Share of the traced study window in which no kernel, copy or memset
ran on the card, in %."""


def read(run):
    tr = run.get("trace")
    if run.get("kind") != "gemm_study" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
