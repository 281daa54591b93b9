"""Driver of the locality study: the paper's square GEMMs through the
port's ``DotEngine.dot_batched`` under each curve order in turn.

Traffic (``traffic/<mix>.json``): ``batch`` x ``n`` x ``n`` x ``n``
GEMMs of the configuration's dtype, over ``input_sets`` pairs (A, B)
drawn from the seed (A normal, B normal / sqrt(n)); ``variants``, each a
[schedule, table] pair (``table`` false: the tile order decoded in closed
form), take turns, each turn one launch a variant on the turn's input
pair, the order rotated by one each turn.  The host runs at most
``in_flight`` turns ahead of the card.

Set-up builds the kernel, draws the inputs and runs two turns.  The
window enqueues turns until its time is up, then waits for the card.
A sample of the outputs, drawn from the seed (a reservoir of
``check.per_variant`` launches a variant), is kept and, after the window,
compared with the plain reference (``reference/gemm.py``).
"""
from __future__ import annotations

import random
import time

import torch

from perfbench.harness import flops as F
from perfbench.harness.peaks import PEAK_FLOPS
from perfbench.harness.profile import DeviceTrace, Spans, setup_parts, \
    start_device_trace, stop_device_trace

__all__ = ["make_inputs", "engines", "run", "checks", "control"]


def make_inputs(traffic: dict, dtype: str, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    b, n = traffic["batch"], traffic["n"]
    dt = getattr(torch, dtype)
    out = []
    for _ in range(traffic["input_sets"]):
        a = torch.randn(b, n, n, generator=gen, device=device, dtype=dt)
        w = torch.randn(b, n, n, generator=gen, device=device, dtype=dt)
        out.append((a, w.mul_(n ** -0.5)))
    return out


def engines(config: dict, traffic: dict) -> list:
    """The system under test: one ``DotEngine`` a variant."""
    from repro_torch.models import DotEngine

    blk = int(config["block"])
    return [((sched, bool(table)), DotEngine(schedule=sched,
                                            block=(blk, blk, blk),
                                            use_prefetch=bool(table)))
            for sched, table in traffic["variants"]]


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        energy=None, engines_fn=None) -> dict:
    config, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    stages = [time.perf_counter()]
    if cuda:
        from repro_torch.kernels import _build
        _build.build(tuple(config["kernels"]))
        torch.cuda.reset_peak_memory_stats()
    stages.append(time.perf_counter())
    inputs = make_inputs(traffic, config["dtype"], seed, dev)
    if cuda:
        torch.cuda.synchronize()
    stages.append(time.perf_counter())
    engs = (engines_fn or engines)(config, traffic)
    stages.append(time.perf_counter())
    nv = len(engs)
    depth = int(traffic.get("in_flight", 2))
    spans = Spans(enabled=trace)

    def turn(t: int, keep=None):
        a, b = inputs[t % len(inputs)]
        rot = t % nv
        for key, eng in engs[rot:] + engs[:rot]:
            out = eng.dot_batched(a, b)
            if keep is not None:
                keep(key, t % len(inputs), out)

    for t in range(2):
        turn(t)
    if cuda:
        torch.cuda.synchronize()
    window_start_s = time.perf_counter()
    stages.append(window_start_s)
    setup_s = window_start_s - stages[0]

    rng = random.Random(f"{seed}/sample")
    k = int(traffic["check"]["per_variant"])
    seen = {key: 0 for key, _ in engs}
    kept: dict = {key: [] for key, _ in engs}

    def keep(key, idx, out):
        j = seen[key]
        seen[key] += 1
        if j < k:
            kept[key].append((idx, out))
        else:
            r = rng.randrange(j + 1)
            if r < k:
                kept[key][r] = (idx, out)

    marks = [None] * depth
    prof = start_device_trace() if trace and cuda else None
    e0 = energy.joules() if energy is not None else None
    t0 = time.time_ns()
    deadline = t0 + int(seconds * 1e9)
    turns = 0
    while time.time_ns() < deadline:
        with spans.span("bench.turn"):
            if marks[turns % depth] is not None:
                with spans.span("bench.wait"):
                    marks[turns % depth].synchronize()
            turn(turns, keep)
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                marks[turns % depth] = ev
        turns += 1
    if cuda:
        torch.cuda.synchronize()
    t1 = time.time_ns()
    e1 = energy.joules() if energy is not None else None
    t_stop = time.perf_counter()
    events = stop_device_trace(prof) if prof is not None else None
    trace_stop_s = time.perf_counter() - t_stop
    window_s = (t1 - t0) / 1e9
    launches = turns * nv
    b, n = traffic["batch"], traffic["n"]
    isz = getattr(torch, config["dtype"]).itemsize
    peak = PEAK_FLOPS[config["dtype"]]
    rec = {"kind": "gemm_study", "setup_s": setup_s,
           "window_start_s": window_start_s, "window_s": window_s,
           **setup_parts(stages, ("build", "inputs", "engines", "warm")),
           "t0_ns": t0, "t1_ns": t1, "turns": turns, "launches": launches,
           "useful_flops": launches * F.bmm_flops(b, n),
           "b3_least_s": launches * F.bmm_least_s(b, n, isz, peak),
           "energy_j": (e1 - e0) if energy is not None else None,
           "memory_peak_bytes": torch.cuda.max_memory_allocated()
           if cuda else 0,
           "peak_flops": peak, "attempted": launches, "failed": 0,
           "trace_stop_s": trace_stop_s,
           "kept": kept, "inputs": inputs, "spans": spans}
    if events is not None:
        rec["trace"] = DeviceTrace(events, t0, t1)
    return rec


def checks(cell, rec: dict) -> list[dict]:
    """The largest relative error of a kept output against the
    reference."""
    ref = cell.reference
    worst, n, wrong = 0.0, 0, 0
    lim = float(cell.traffic["check"]["max_rel_error"])
    refs = {}
    for key, outs in rec["kept"].items():
        for idx, out in outs:
            if idx not in refs:
                refs[idx] = ref.bmm(*rec["inputs"][idx])
            err = ref.rel_error(out, refs[idx])
            worst = max(worst, err)
            wrong += err > lim
            n += 1
    rec["failed"] = wrong
    return [{"name": "max_rel_error", "value": worst, "limit": lim,
             "ok": n > 0 and worst <= lim, "outputs": n}]


def control(cell, seed: int, seconds: float = 0.0, device="cuda",
            energy=None) -> dict:
    """On the cell's inputs for ``seed``: ``checks`` of every variant's
    product (the lower reading), then ``checks`` of the TF32 product put
    in the program's place (the control), which must come out not
    correct.  No window is needed."""
    ref = cell.reference
    inputs = make_inputs(cell.traffic, cell.config["dtype"], seed,
                         torch.device(device))
    prog = {key: [(i, eng.dot_batched(a, b)) for i, (a, b)
                  in enumerate(inputs)]
            for key, eng in engines(cell.config, cell.traffic)}
    low = {("tf32",): [(i, ref.bmm(a, b, precision="tf32"))
                       for i, (a, b) in enumerate(inputs)]}
    p = checks(cell, {"kept": prog, "inputs": inputs})
    c = checks(cell, {"kept": low, "inputs": inputs})
    return {"seed": seed, "program": p[0]["value"],
            "program_correct": all(x["ok"] for x in p),
            "control_tf32": c[0]["value"],
            "control_correct": all(x["ok"] for x in c)}
