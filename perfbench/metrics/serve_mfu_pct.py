"""The whole serving step's share of the card's peak: useful operations
of the window (prefilled and decoded tokens, closed form) over the
window's seconds at the published peak of the served dtype, in %."""


def read(run):
    if run.get("kind") != "serve" or not run.get("useful_flops"):
        return None
    return 100.0 * run["useful_flops"] / (run["window_s"] * run["peak_flops"])
