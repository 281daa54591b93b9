"""The card's joules over the whole window (NVML's energy counter) per
TFLOP of useful work counted in closed form."""


def read(run):
    if run.get("energy_j") is None or not run.get("useful_flops"):
        return None
    return run["energy_j"] / (run["useful_flops"] / 1e12)
