"""Rows each touched expert's weights are read for in a decode step: the
sum of ``moe_rows`` (routed assignments, summed over layers) over the sum
of ``experts_touched`` (experts with at least one row, summed over
layers), across the window's ``serve.decode.dispatch`` spans of the
program's tracer.  1 means every expert read served one row."""


def read(run):
    spans = run.get("program_spans")
    if not spans:
        return None
    rows = touched = 0
    for s in spans:
        a = s["args"]
        if s["name"] == "serve.decode.dispatch" and "moe_rows" in a \
                and "experts_touched" in a:
            rows += a["moe_rows"]
            touched += a["experts_touched"]
    return rows / touched if touched else None
