"""Median host wall time of the program's ``serve.decode`` span in the
window, ms.  The span ends in the copy of the logits to the host, so it
is the decode step's wall time; a decode step that follows a chunk step
also waits for the chunk's device work (the chunk's span only enqueues
it), which is why the median and not the mean is taken."""
import statistics


def read(run):
    d = run.get("decode_span_ms")
    if not d:
        return None
    return statistics.median(d)
