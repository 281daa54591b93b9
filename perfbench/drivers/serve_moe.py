"""Driver of a served routed-moe model whose layers mix sliding-window
and full attention: closed-loop clients against the port's ``ServeLoop``
(continuous batching on the paged pool).

It takes ``drivers/serve.py``'s request stream, closed-loop clients,
ramp and token stamping by import, and differs where the model does: the
weights (a router and the experts in place of the MLP, drawn here from
the seed), the program's configuration (a layer type a layer, YaRN on
the full layers), the closed-form work (``harness/flops_moe.py``: the
routed experts, window-limited keys), the check, and on traced runs two
more records: the loop's ``serve.*`` spans with their args in
``rec["program_spans"]``, and B5's least time, from the experts the
reference routes each window step's tokens to (``reference/
moe_window_lm.py``, after the program's state is freed; nothing here
reads the program's counts).

The check (``checks``).  A bf16 row whose 8th and 9th experts nearly tie
may take the other one than the f32 reference takes, and a swap's effect
grows through the layers: judged against a reference that routes on its
own, the program's widest logit gap spread over 0.13-0.53 on 14 seeds
on an H100, near the fp8 control's 0.78-0.98.  So the loop keeps every served
position's routing (``ServeLoop.route_steps``) and the reference is
routed the same way, each expert weighted by its own renormalised
probability: ``max_logit_gap`` then holds the arithmetic alone, as
docqa's does, and ``max_route_margin`` holds the routing, the widest
amount by which an expert the program took has a reference router logit
below the reference's own k-th best, over every position and layer of
every served request.  A route row that is not k distinct experts (one
unrouted, or an expert taken twice, to which the margin is blind) fails
the check as missing.  On an H100 (7 seeds) the program reads gaps of
0.018-0.041 and margins of 0.064-0.071, the fp8 control 0.49-0.61 and
0.82-0.95: the limits, 0.15 and 0.25, sit ~3.5 x from each.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.drivers.serve import _DTYPE, _Clients, _ramp
from perfbench.harness import flops_moe as FM
from perfbench.harness.peaks import HBM_BYTES_S, PEAK_FLOPS
from perfbench.harness.profile import DeviceTrace, Spans, setup_parts, \
    start_device_trace, stop_device_trace
# the program this driver needs: a parent without it fails here, at once
from repro_torch.models.config import LayeredArchConfig, YarnRope

__all__ = ["make_weights", "run", "checks", "control", "step_routing"]

_SERVE_SPANS = {"serve.step", "serve.admit", "serve.prefill_chunk",
                "serve.decode"}


def make_weights(arch: dict, seed: int, device) -> dict:
    """The benchmark's weights in the program's layout, drawn on
    ``device`` from ``seed``: one normal draw per stacked tensor in the
    served dtype (the router in float32), linears and the router scaled
    by 1 / sqrt(fan-in), the embedding by 0.02, norm scales 1 + 0.1 x
    normal."""
    dt = _DTYPE[arch["dtype"]]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    n, d = arch["n_layers"], arch["d_model"]
    e, f = arch["experts"], arch["expert_dim"]

    def draw(*shape, scale=1.0, shift=0.0, dtype=dt):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return t.mul_(scale).add_(shift) if shift else t.mul_(scale)

    attn = {name: draw(n, k, nn, scale=k ** -0.5)
            for name, k, nn in FM.attn_projections(arch)}
    moe = {"router": draw(n, d, e, scale=d ** -0.5, dtype=torch.float32),
           "w1": draw(n, e, d, f, scale=d ** -0.5),
           "w3": draw(n, e, d, f, scale=d ** -0.5),
           "w2": draw(n, e, f, d, scale=f ** -0.5)}
    v = arch["padded_vocab"]
    return {"layers": {"norm1": draw(n, d, scale=0.1, shift=1.0),
                       "norm2": draw(n, d, scale=0.1, shift=1.0),
                       "attn": attn, "moe": moe},
            "final_norm": draw(d, scale=0.1, shift=1.0),
            "embed": draw(v, d, scale=0.02),
            "lm_head": draw(d, v, scale=d ** -0.5)}


def _program(config: dict, traffic: dict, weights, device, trace: bool):
    """The system under test: the port's loop over the weights."""
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.obs import Tracer
    from repro_torch.serve import ServeConfig

    a = config["arch"]
    cfg = LayeredArchConfig(
        name=config["name"], family="moe", n_layers=a["n_layers"],
        d_model=a["d_model"], vocab=a["vocab"], n_heads=a["n_heads"],
        n_kv_heads=a["n_kv_heads"], d_head=a["d_head"],
        moe_experts=a["experts"], moe_topk=a["top_k"],
        moe_dff=a["expert_dim"], rope_theta=a["rope_theta"],
        layer_types=tuple(a["layer_types"]),
        sliding_window=a["sliding_window"],
        full_rope_yarn=YarnRope(**a["yarn"]),
        param_dtype=a["dtype"], act_dtype=a["dtype"])
    if cfg.padded_vocab != a["padded_vocab"]:
        raise ValueError(f"the program pads the vocab to {cfg.padded_vocab}, "
                         f"the configuration says {a['padded_vocab']}")
    tracer = Tracer(enabled=True) if trace else None
    return ServeLoop(cfg, weights, ServeConfig(**traffic["serve"]),
                     tracer=tracer, device=device)


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        energy=None) -> dict:
    """One run of the cell; returns the run record the metric readers
    read."""
    config, traffic = cell.config, cell.traffic
    arch = config["arch"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    stages = [time.perf_counter()]
    if cuda:
        from repro_torch.kernels import _build
        _build.build(tuple(config["kernels"]))
        torch.cuda.reset_peak_memory_stats()
    stages.append(time.perf_counter())
    weights = make_weights(arch, seed, dev)
    if cuda:
        torch.cuda.synchronize()
    stages.append(time.perf_counter())
    loop = _program(config, traffic, weights, dev, trace)
    loop.route_steps = []
    spans = Spans(enabled=trace)
    clients = _Clients(loop, traffic, seed, arch["vocab"], spans)
    stages.append(time.perf_counter())
    ramp_iters = _ramp(clients, int(traffic["clients"]),
                       int(traffic["ramp_limit"]))
    if cuda:
        torch.cuda.synchronize()
    window_start_s = time.perf_counter()
    stages.append(window_start_s)

    prof = start_device_trace() if trace and cuda else None
    e0 = energy.joules() if energy is not None else None
    t0 = time.time_ns()
    deadline = t0 + int(seconds * 1e9)
    steps = []
    while time.time_ns() < deadline:
        steps.append(clients.iterate())
    if cuda:
        torch.cuda.synchronize()
    t1 = time.time_ns()
    e1 = energy.joules() if energy is not None else None
    t_stop = time.perf_counter()
    events = stop_device_trace(prof) if prof is not None else None
    trace_stop_s = time.perf_counter() - t_stop
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    rec = _account(arch, clients, steps, t0, deadline)
    rec.update(kind="serve", setup_s=window_start_s - stages[0],
               window_start_s=window_start_s, window_s=(t1 - t0) / 1e9,
               **setup_parts(stages, ("build", "weights", "program", "ramp")),
               rate_window_s=seconds, t0_ns=t0, t1_ns=t1,
               memory_peak_bytes=peak,
               energy_j=(e1 - e0) if energy is not None else None,
               peak_flops=PEAK_FLOPS[arch["dtype"]], iterations=len(steps),
               chunk_iterations=sum(1 for s in steps if s["prefill"]),
               ramp_iterations=ramp_iters, trace_stop_s=trace_stop_s)
    if trace:
        mono_off = time.time_ns() - time.monotonic_ns()
        rec["program_spans"] = [
            {"name": ev["name"], "t_ns": int(ev["ts"] * 1e3) + mono_off,
             "dur_ms": ev["dur"] / 1e3, "args": dict(ev.get("args") or {})}
            for ev in loop.tracer.events
            if ev.get("ph") == "X" and ev["name"].startswith("serve.")
            and t0 <= int(ev["ts"] * 1e3) + mono_off <= t1]
        rec["decode_span_ms"] = [s["dur_ms"] for s in rec["program_spans"]
                                 if s["name"] == "serve.decode"]
        spans.add_program_events(loop.tracer.events, mono_off,
                                 names=_SERVE_SPANS)
        rec["spans"] = spans
        if events is not None:
            rec["trace"] = DeviceTrace(events, t0, t1)
    done = [r for r in clients.reqs.values()
            if any(t0 < t <= t1 for t in r.tok_ns)]
    served = [r for r in done if r.rid not in loop.errors]
    rec["served"] = [(r.prompt, loop.out[r.rid][len(r.prompt):])
                     for r in served]
    rec["routes"] = _request_routes(
        loop.route_steps, [(r.rid, len(r.prompt) + len(p[1]))
                           for r, p in zip(served, rec["served"])])
    rec["attempted"] = len(done)
    rec["failed"] = sum(1 for r in done if r.rid in loop.errors)
    rec["finished"] = sum(1 for r in done if r.finish_ns)
    rec["weights"] = weights
    seqs = {rid: (_fed(clients.reqs[rid], loop.out.get(rid, [])),
                  len(clients.reqs[rid].prompt))
            for rid in {rid for s in steps for rid, _ in s["decode"]}
            | {rid for s in steps for rid, _, _ in s["prefill_spans"]}}
    # the program's state goes before the reference runs
    del loop, clients
    if trace:
        if cuda:
            torch.cuda.empty_cache()
        rec["b5_least_s"] = _b5_least_s(cell, weights, steps, seqs)
    return rec


def _fed(req, out: list[int]) -> list[int]:
    """The tokens the loop fed for a request, in position order, as far
    as the harness saw it go: its prompt, then (once it decodes) the
    prompt's last token again and each new token but the last."""
    if not req.tok_ns:
        return list(req.prompt[:req.prefilled])
    new = out[len(req.prompt):len(req.prompt) + len(req.tok_ns)]
    return list(req.prompt) + [req.prompt[-1]] + list(new[:-1])


def _account(arch, clients, steps, t0, deadline) -> dict:
    """Closed-form work of the window's iterations (useful operations,
    B1's least time over the useful rows, the window-limited K/V bytes
    the decode rows must read), and the tokens and the gaps between
    tokens that came in the measured seconds, (t0, deadline]."""
    bytes_in = _DTYPE[arch["dtype"]].itemsize
    flops = b1_least = kv = 0.0
    tokens = prefill = 0
    for s in steps:
        for rid, a, take in s["prefill_spans"]:
            flops += FM.prefill_flops(arch, a, take)
        if s["prefill"]:
            prefill += s["prefill"]
            b1_least += FM.rows_least_s(arch, s["prefill"], False, bytes_in)
        rows = len(s["decode"])
        if rows:
            b1_least += FM.rows_least_s(arch, rows, True, bytes_in)
        for rid, i in s["decode"]:
            keys = len(clients.reqs[rid].prompt) + 1 + i
            flops += FM.token_flops(arch, keys, head=True)
            kv += FM.kv_bytes(arch, keys, bytes_in)
        if s["t"] <= deadline:
            tokens += rows
    gaps = []
    for r in clients.reqs.values():
        for a, b in zip(r.tok_ns, r.tok_ns[1:]):
            if t0 < b <= deadline:
                gaps.append((b - a) / 1e6)
    return {"tokens_out": tokens, "prefill_tokens": prefill,
            "useful_flops": flops, "b1_least_s": b1_least,
            "b2_least_s": kv / HBM_BYTES_S, "itl_ms": gaps}


def step_routing(cell, weights, seqs: dict) -> dict:
    """The reference's top-k experts of every fed position of each
    request: ``{rid: (n_layers, S, k) int array}``, from float32 hidden
    states, requests in blocks."""
    ref, arch = cell.reference, cell.config["arch"]
    dev = weights["embed"].device
    out = {}
    rids = sorted(seqs)
    per = int(cell.traffic["check"].get("block", 4))
    for b in range(0, len(rids), per):
        part = rids[b:b + per]
        got = {rid: [None] * arch["n_layers"] for rid in part}

        def hook(i, j, h, part=part, got=got):
            _, idx = ref.routing(h, weights["layers"]["moe"]["router"][i],
                                 arch["top_k"])
            got[part[j]][i] = idx.to(torch.int16).cpu().numpy()

        ref._hidden(weights, arch, [torch.tensor(seqs[r], device=dev)
                                    for r in part], "f32", hook)
        for rid in part:
            out[rid] = np.stack(got[rid])
    return out


def _b5_least_s(cell, weights, steps, seqs) -> float:
    """B5's least time over the window: per step and moe layer
    (``harness/flops_moe.py::expert_least_s``) with the experts the
    reference routes the step's tokens to.  A decode row of request r
    and new token i fed position len(prompt) + i."""
    arch = cell.config["arch"]
    bytes_in = _DTYPE[arch["dtype"]].itemsize
    routes = step_routing(cell, weights,
                          {r: fed for r, (fed, _) in seqs.items() if fed})
    total = 0.0
    for s in steps:
        rows = list(s["prefill_spans"])
        rows += [(rid, seqs[rid][1] + i, 1) for rid, i in s["decode"]]
        picks = [routes[rid][:, a:a + take] for rid, a, take in rows
                 if rid in routes]
        if not picks:
            continue
        tokens = sum(p.shape[1] for p in picks)
        allp = np.concatenate([p.reshape(p.shape[0], -1) for p in picks],
                              axis=1)
        for layer in range(arch["n_layers"]):
            touched = len(np.unique(allp[layer]))
            total += FM.expert_least_s(arch, tokens, touched, bytes_in)
    return total


def _request_routes(steps, wanted) -> list:
    """Per (request id, fed length) of ``wanted``, the (n_layers, length,
    k) int16 experts the program took at each fed position (-1 where no
    step routed it), from the loop's ``route_steps``."""
    length = dict(wanted)
    out = {}
    for rids, positions, dev in steps:
        rows = [(j, rid, p) for j, (rid, p) in
                enumerate(zip(rids.tolist(), positions.tolist()))
                if rid in length and p < length[rid]]
        if not rows:
            continue
        host = dev.cpu().numpy()
        for j, rid, p in rows:
            if rid not in out:
                out[rid] = np.full((host.shape[0], length[rid],
                                    host.shape[2]), -1, np.int16)
            out[rid][:, p] = host[:, j]
    return [out.get(rid) for rid, _ in wanted]


def _bad_routes(r, experts: int) -> int:
    """Route rows (one a layer and position) of ``r`` (..., k) that are not
    k distinct experts in [0, ``experts``): unrouted (-1), out of range, or
    an expert taken twice, which would drop an assignment that a
    reference routed the same way could not see."""
    s = np.sort(r, axis=-1)
    bad = (s[..., 0] < 0) | (s[..., -1] >= experts) | \
        (s[..., 1:] == s[..., :-1]).any(-1)
    return int(bad.sum())


def _judge(cell, weights, served, routes, chosen) -> dict:
    """The widest logit gap of the ``chosen`` tokens (per request; the
    served ones when None) and the widest route margin, against the
    reference routed as ``routes`` says (requests in blocks)."""
    ref, arch = cell.reference, cell.config["arch"]
    router = weights["layers"]["moe"]["router"]
    k = arch["top_k"]
    out = {"max_gap": float("inf") if not served else 0.0, "tokens": 0,
           "margin": 0.0, "positions": 0, "missing": 0}
    per = int(cell.traffic["check"].get("block", 4))
    for i in range(0, len(served), per):
        part, rts = served[i:i + per], routes[i:i + per]
        missing = sum(1 if r is None else _bad_routes(r, arch["experts"])
                      for r in rts)
        if missing:
            out["missing"] += missing
            out["max_gap"] = out["margin"] = float("inf")
            continue

        def hook(layer, j, h, rts=rts):
            with torch.no_grad():
                logits = h @ router[layer].float()
                kth = logits.topk(k, dim=-1).values[:, -1]
                took = logits.gather(1, torch.as_tensor(
                    rts[j][layer], device=h.device).long())
                deficit = (kth - took.min(-1).values).clamp(min=0)
                out["margin"] = max(out["margin"], float(deficit.max()))
                out["positions"] += len(h)

        logits = ref.served_logits(weights, arch, part, routes=rts,
                                   on_layer=hook)
        ch = chosen[i:i + per] if chosen is not None \
            else [n for _, n in part]
        g = ref.gap_report(logits, ch)
        out["tokens"] += g["tokens"]
        out["max_gap"] = max(out["max_gap"], g["max_gap"])
        del logits
    return out


def checks(cell, rec: dict) -> list[dict]:
    """The numbers compared, each beside its limit: the served tokens'
    widest logit gap and the program's widest route margin, against the
    reference routed as the program was (``rec["judged"]`` and
    ``rec["judged_routes"]``, where present, judge those in their
    place)."""
    routes = rec.get("judged_routes", rec["routes"])
    g = _judge(cell, rec["weights"], rec["served"], routes,
               rec.get("judged"))
    lim = cell.traffic["check"]
    return [{"name": "max_logit_gap", "value": g["max_gap"],
             "limit": float(lim["max_logit_gap"]),
             "ok": g["max_gap"] <= lim["max_logit_gap"] and g["tokens"] > 0,
             "tokens": g["tokens"], "requests": len(rec["served"])},
            {"name": "max_route_margin", "value": g["margin"],
             "limit": float(lim["max_route_margin"]),
             "ok": g["margin"] <= lim["max_route_margin"]
             and g["missing"] == 0 and g["positions"] > 0,
             "positions": g["positions"], "missing": g["missing"]}]


def control(cell, seed: int, seconds: float, device="cuda", energy=None,
            ) -> dict:
    """One run of the program and its ``checks`` (the lower reading);
    then the same ``checks`` with the tokens judged at every served
    position those the fp8 reference puts first, routed as the fp8
    reference routes (the control), which must come out not correct."""
    import gc

    rec = run(cell, seed, seconds, False, device=device, energy=energy)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref, arch = cell.reference, cell.config["arch"]
    per = int(cell.traffic["check"].get("block", 4))
    served = rec["served"]
    prog = checks(cell, rec)
    judged, judged_routes = [], []
    router = rec["weights"]["layers"]["moe"]["router"]
    for i in range(0, len(served), per):
        part = served[i:i + per]
        rts = [np.zeros((arch["n_layers"], len(p) + len(n), arch["top_k"]),
                        np.int16) for p, n in part]

        def hook(layer, j, h, rts=rts):
            _, idx = ref.routing(h, router[layer], arch["top_k"], "fp8")
            rts[j][layer] = idx.cpu().numpy()

        low = ref.served_logits(rec["weights"], arch, part, "fp8", hook)
        judged += [x.argmax(-1).tolist() for x in low]
        judged_routes += rts
        del low
    rec["judged"], rec["judged_routes"] = judged, judged_routes
    ctrl = checks(cell, rec)
    return {"seed": seed, "requests": len(served),
            "tokens_out": rec["tokens_out"],
            "program": prog, "program_correct": all(c["ok"] for c in prog),
            "control_fp8": ctrl,
            "control_correct": all(c["ok"] for c in ctrl)}
