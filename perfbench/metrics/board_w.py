"""The card's mean draw over the window: NVML joules over seconds, W."""


def read(run):
    if run.get("energy_j") is None:
        return None
    return run["energy_j"] / run["window_s"]
