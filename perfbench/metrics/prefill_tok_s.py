"""Prompt tokens prefilled in the window (the program's
``prefill_tokens_per_step`` counter) over the window's seconds."""


def read(run):
    if run.get("kind") != "serve" or not run.get("prefill_tokens"):
        return None
    return run["prefill_tokens"] / run["window_s"]
