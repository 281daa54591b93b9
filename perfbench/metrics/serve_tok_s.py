"""Output tokens emitted in the measured seconds (every token of every
request, stamped on the host clock after the iteration that made it)
over those seconds."""


def read(run):
    if run.get("kind") != "serve":
        return None
    return run["tokens_out"] / run["rate_window_s"]
