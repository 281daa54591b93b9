"""95th percentile of every gap between consecutive output tokens of one
request whose later token came in the measured seconds (host clock, ms).
A chunk step's stall of the decoding slots shows here."""
import numpy as np


def read(run):
    gaps = run.get("itl_ms")
    if run.get("kind") != "serve" or not gaps:
        return None
    return float(np.percentile(np.asarray(gaps, np.float64), 95))
