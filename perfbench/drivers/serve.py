"""Driver of a served model: closed-loop clients against the port's
``ServeLoop``.

Set-up draws the weights on the device from the seed (one call a
stacked tensor, in the served dtype), builds the loop from the traffic
mix's ``serve`` block and runs the ramp: every client sends its first
request at once, and the window opens after the first iteration that
emits a token.  By then every shape the window uses has run: the chunk
step (one fixed gang) and the decode step (every slot).  The prompts
are prefilled one after another, oldest admission first, so the
requests reach decode spread out in time, and completions spread
through the window: each iteration of the window runs a chunk step and
a decode step, and emits a token for every slot that decodes.

Traffic (``traffic/<mix>.json``): ``clients`` closed-loop clients; each
sends its next request when its last one finishes.  Prompt lengths are a
fixed multiset, ``prompts.block`` quantiles of a log-uniform law on
[``prompts.min``, ``prompts.max``]; requests are taken in blocks of that
size, each block the multiset in the mix's fixed order, so every seed
offers the same load; token ids are drawn from the seed, every prompt
distinct.  Each request asks ``max_new`` greedy tokens; the
``serve`` block's ``eos_id`` of -1 matches no sampled id, so none ends
early.

The window drives ``ServeLoop.submit`` and ``ServeLoop._run_iteration``,
stamps every new token on the host clock after the iteration that made
it (the decode step ends in a copy of its logits to the host), and
counts the work done in closed form (``harness/flops.py``).  After the
window every request served a token in it, finished or still decoding,
is checked with all it was served against the plain reference
(``reference/dense_lm.py``), once the program's state is freed: the
widest gap by which a served token's reference logit lies below the
reference's best.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.harness import flops as F
from perfbench.harness.peaks import HBM_BYTES_S, PEAK_FLOPS
from perfbench.harness.profile import DeviceTrace, Spans, setup_parts, \
    start_device_trace, stop_device_trace

__all__ = ["prompt_lengths", "RequestStream", "make_weights", "run",
           "widest_gap", "checks", "control"]

_DTYPE = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def prompt_lengths(p: dict) -> list[int]:
    """The block's multiset: quantiles (i + 1/2) / block of a log-uniform
    law on [min, max]."""
    lo, hi, n = math.log(p["min"]), math.log(p["max"]), p["block"]
    return [int(round(math.exp(lo + (i + 0.5) / n * (hi - lo))))
            for i in range(n)]


class RequestStream:
    """The mix's requests in order: blocks of the length multiset, each
    in the mix's fixed order (``prompts.order``, indices of the sorted
    quantiles, rotated ``prompts.rotate`` places more each block), with
    token ids drawn from the seed, every prompt distinct.  The order is
    the same for every seed: it decides which prompts share a chunk step
    and which fall in the window, so a seeded order would change the
    work from seed to seed."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        p = traffic["prompts"]
        self.rng = np.random.default_rng([seed, 0x5e7e])
        self.lengths = prompt_lengths(p)
        self.order = list(p["order"])
        if sorted(self.order) != list(range(len(self.lengths))):
            raise ValueError(f"prompts.order {self.order} is not a "
                             f"permutation of the {len(self.lengths)} "
                             f"quantiles")
        self.rotate = int(p.get("rotate", 0))
        self.vocab = vocab
        self.lo = int(p.get("first_id", 2))
        self._blocks = 0
        self._block: list[int] = []
        self._seen: set[tuple] = set()

    def next_length(self) -> int:
        if not self._block:
            r = (self._blocks * self.rotate) % len(self.order)
            self._block = [self.lengths[i]
                           for i in self.order[r:] + self.order[:r]]
            self._blocks += 1
        return self._block.pop(0)

    def tokens(self, n: int) -> list[int]:
        while True:
            t = self.rng.integers(self.lo, self.vocab, size=n).tolist()
            if tuple(t) not in self._seen:
                self._seen.add(tuple(t))
                return t

    def next(self) -> list[int]:
        return self.tokens(self.next_length())


def make_weights(arch: dict, seed: int, device) -> dict:
    """The benchmark's weights in the program's layout, drawn on
    ``device`` from ``seed``: one normal draw per stacked tensor in the
    served dtype, linears scaled by 1 / sqrt(fan-in), the embedding by
    0.02, norm scales 1 + 0.1 x normal."""
    dt = _DTYPE[arch["dtype"]]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    n = arch["n_layers"]

    def draw(*shape, scale=1.0, shift=0.0):
        t = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return t.mul_(scale).add_(shift) if shift else t.mul_(scale)

    layers = {"norm1": draw(n, arch["d_model"], scale=0.1, shift=1.0),
              "norm2": draw(n, arch["d_model"], scale=0.1, shift=1.0),
              "attn": {}, "mlp": {}}
    for name, k, nn in F.projections(arch):
        group = "attn" if name in ("wq", "wk", "wv", "wo") else "mlp"
        layers[group][name] = draw(n, k, nn, scale=k ** -0.5)
    d, v = F.head_shape(arch)
    return {"layers": layers,
            "final_norm": draw(d, scale=0.1, shift=1.0),
            "embed": draw(v, d, scale=0.02),
            "lm_head": draw(d, v, scale=d ** -0.5)}


def _program(config: dict, traffic: dict, weights, device, trace: bool):
    """The system under test: the port's loop over the weights."""
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.models.config import ArchConfig
    from repro_torch.obs import Tracer
    from repro_torch.serve import ServeConfig

    a = config["arch"]
    cfg = ArchConfig(name=config["name"], family="dense",
                     n_layers=a["n_layers"], d_model=a["d_model"],
                     vocab=a["vocab"], n_heads=a["n_heads"],
                     n_kv_heads=a["n_kv_heads"], d_head=a["d_head"],
                     d_ff=a["d_ff"], rope_theta=a["rope_theta"],
                     param_dtype=a["dtype"], act_dtype=a["dtype"])
    if cfg.padded_vocab != a["padded_vocab"]:
        raise ValueError(f"the program pads the vocab to {cfg.padded_vocab}, "
                         f"the configuration says {a['padded_vocab']}")
    tracer = Tracer(enabled=True) if trace else None
    return ServeLoop(cfg, weights, ServeConfig(**traffic["serve"]),
                     tracer=tracer, device=device)


class _Req:
    __slots__ = ("rid", "client", "prompt", "tok_ns", "finish_ns",
                 "prefilled")

    def __init__(self, rid, client, prompt):
        self.rid, self.client, self.prompt = rid, client, prompt
        self.tok_ns: list[int] = []
        self.finish_ns = None
        self.prefilled = 0


class _Clients:
    """Closed-loop clients and the harness's view of their requests."""

    def __init__(self, loop, traffic, seed, vocab, spans: Spans):
        self.loop, self.traffic, self.spans = loop, traffic, spans
        self.stream = RequestStream(traffic, seed, vocab)
        self.max_new = int(traffic["max_new"])
        self.reqs: dict[int, _Req] = {}
        self.live: list[int] = []
        self._next_rid = 0

    def submit(self, client: int):
        r = _Req(self._next_rid, client, self.stream.next())
        self._next_rid += 1
        self.reqs[r.rid] = r
        self.live.append(r.rid)
        self.loop.submit(r.rid, r.prompt)
        return r

    def iterate(self) -> dict:
        """One scheduler iteration, then the harness's bookkeeping:
        stamps of new tokens, prefill attribution, completions (each
        client's next request).  Returns what the iteration did."""
        loop = self.loop
        with self.spans.span("bench.iteration"):
            loop._run_iteration(self.max_new)
        t = time.time_ns()
        with self.spans.span("bench.clients"):
            pf = loop.prefill_tokens_per_step[-1] \
                if loop.prefill_tokens_per_step else 0
            step = {"t": t, "prefill": pf, "decode": [],
                    "prefill_spans": self._attribute_prefill(pf)}
            finished = []
            for rid in self.live:
                r = self.reqs[rid]
                n = loop.request_emitted.get(rid, 0)
                while len(r.tok_ns) < n:
                    step["decode"].append((rid, len(r.tok_ns)))
                    r.tok_ns.append(t)
                    r.prefilled = len(r.prompt)
                if rid in loop.finish_s:
                    r.finish_ns = t
                    finished.append(r)
            for r in finished:
                self.live.remove(r.rid)
                self.submit(r.client)
        return step

    def _attribute_prefill(self, n: int) -> list:
        """Give an iteration's prefilled tokens to the admitted requests
        still prefilling, oldest admission first (the loop's order);
        returns (rid, first position, count) spans."""
        out = []
        if n <= 0:
            return out
        for rid in self.loop.admitted:
            r = self.reqs.get(rid)
            if r is None or r.prefilled >= len(r.prompt) or r.tok_ns:
                continue
            take = min(n, len(r.prompt) - r.prefilled)
            out.append((rid, r.prefilled, take))
            r.prefilled += take
            n -= take
            if n <= 0:
                break
        return out


def _ramp(clients: _Clients, n_clients: int, limit: int) -> int:
    """Every client sends its first request at once; returns the
    iterations run until one has emitted a token (it ran a chunk step
    and a decode step)."""
    for c in range(n_clients):
        clients.submit(c)
    for it in range(1, limit + 1):
        if clients.iterate()["decode"]:
            return it
    raise RuntimeError(f"the ramp did not end in {limit} iterations")


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        energy=None) -> dict:
    """One run of a serving cell; returns the run record the metric
    readers read."""
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
    spans = Spans(enabled=trace)
    clients = _Clients(loop, traffic, seed, arch["vocab"], spans)
    stages.append(time.perf_counter())
    ramp_iters = _ramp(clients, int(traffic["clients"]),
                       int(traffic["ramp_limit"]))
    if cuda:
        torch.cuda.synchronize()
    window_start_s = time.perf_counter()
    stages.append(window_start_s)
    setup_s = window_start_s - stages[0]

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
    window_s = (t1 - t0) / 1e9
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    rec = _account(arch, clients, steps, t0, deadline)
    rec.update(kind="serve", setup_s=setup_s,
               window_start_s=window_start_s, window_s=window_s,
               **setup_parts(stages, ("build", "weights", "program", "ramp")),
               rate_window_s=seconds,
               t0_ns=t0, t1_ns=t1, memory_peak_bytes=peak,
               energy_j=(e1 - e0) if energy is not None else None,
               peak_flops=PEAK_FLOPS[arch["dtype"]], iterations=len(steps),
               chunk_iterations=sum(1 for s in steps if s["prefill"]),
               ramp_iterations=ramp_iters, trace_stop_s=trace_stop_s)
    if trace:
        mono_off = time.time_ns() - time.monotonic_ns()
        decode = [ev["dur"] / 1e3 for ev in loop.tracer.events
                  if ev.get("ph") == "X" and ev["name"] == "serve.decode"
                  and t0 <= int(ev["ts"] * 1e3) + mono_off <= t1]
        rec["decode_span_ms"] = decode
        spans.add_program_events(
            loop.tracer.events, mono_off,
            names={"serve.step", "serve.admit", "serve.prefill_chunk",
                   "serve.decode"})
        rec["spans"] = spans
        if events is not None:
            rec["trace"] = DeviceTrace(events, t0, t1)
    # every request served a token in the window, finished or still
    # decoding, with all it was served
    done = [r for r in clients.reqs.values()
            if any(t0 < t <= t1 for t in r.tok_ns)]
    rec["served"] = [(r.prompt, loop.out[r.rid][len(r.prompt):])
                     for r in done if r.rid not in loop.errors]
    rec["attempted"] = len(done)
    rec["failed"] = sum(1 for r in done if r.rid in loop.errors)
    rec["finished"] = sum(1 for r in done if r.finish_ns)
    rec["weights"] = weights
    # the program's state goes before the reference runs
    del loop, clients
    return rec


def _account(arch, clients, steps, t0, deadline) -> dict:
    """Closed-form work of the window's iterations (useful operations,
    the least time of B1's GEMMs over the useful rows, the K/V bytes the
    decode rows must read), and the tokens and the gaps between tokens
    that came in the measured seconds, (t0, deadline]."""
    bytes_in = _DTYPE[arch["dtype"]].itemsize
    peak = PEAK_FLOPS[arch["dtype"]]
    flops = b1_least = kv = 0.0
    tokens = prefill = 0
    attn_per_key = F.attention_flops(arch, 1)
    dense = 2.0 * F.nonembed_params(arch)
    for s in steps:
        for rid, a, take in s["prefill_spans"]:
            b = a + take
            keys = (b * (b + 1) - a * (a + 1)) // 2
            flops += take * dense + attn_per_key * keys
        if s["prefill"]:
            prefill += s["prefill"]
            b1_least += F.rows_least_s(arch, s["prefill"], False, bytes_in,
                                       peak)
        rows = len(s["decode"])
        if rows:
            b1_least += F.rows_least_s(arch, rows, True, bytes_in, peak)
        for rid, i in s["decode"]:
            keys = len(clients.reqs[rid].prompt) + 1 + i
            flops += F.token_flops(arch, keys, head=True)
            kv += F.kv_bytes(arch, keys, bytes_in)
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


def widest_gap(cell, rec: dict) -> dict:
    """The widest logit gap of the served tokens against the reference
    (requests in blocks, to bound the reference's memory).  Where the
    record holds ``judged`` (per request, a token at each served
    position), those tokens are judged at the served positions instead
    of the served ones."""
    ref = cell.reference
    arch = cell.config["arch"]
    served = rec["served"]
    judged = rec.get("judged")
    widest = {"max_gap": float("inf") if not served else 0.0, "tokens": 0}
    per = int(cell.traffic["check"].get("block", 4))
    for i in range(0, len(served), per):
        part = served[i:i + per]
        logits = ref.served_logits(rec["weights"], arch, part)
        chosen = judged[i:i + per] if judged is not None \
            else [n for _, n in part]
        g = ref.gap_report(logits, chosen)
        widest["tokens"] += g["tokens"]
        widest["max_gap"] = max(widest["max_gap"], g["max_gap"])
        del logits
    return widest


def checks(cell, rec: dict) -> list[dict]:
    """The numbers compared, each beside its limit."""
    g = widest_gap(cell, rec)
    lim = float(cell.traffic["check"]["max_logit_gap"])
    return [{"name": "max_logit_gap", "value": g["max_gap"], "limit": lim,
             "ok": g["max_gap"] <= lim and g["tokens"] > 0,
             "tokens": g["tokens"], "requests": len(rec["served"])}]


def control(cell, seed: int, seconds: float, device="cuda", energy=None,
            ) -> dict:
    """One run of the program and its ``checks`` (the lower reading);
    then the same ``checks`` with the tokens judged at every served
    position those the fp8 reference puts first (the control), which
    must come out not correct."""
    import gc

    rec = run(cell, seed, seconds, False, device=device, energy=energy)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref, arch = cell.reference, cell.config["arch"]
    per = int(cell.traffic["check"].get("block", 4))
    served = rec["served"]
    prog = checks(cell, rec)
    judged = []
    for i in range(0, len(served), per):
        low = ref.served_logits(rec["weights"], arch, served[i:i + per],
                                "fp8")
        judged += [x.argmax(-1).tolist() for x in low]
        del low
    rec["judged"] = judged
    ctrl = checks(cell, rec)
    return {"seed": seed, "requests": len(served),
            "tokens_out": rec["tokens_out"],
            "program": prog[0], "program_correct": all(c["ok"] for c in prog),
            "control_fp8": ctrl[0],
            "control_correct": all(c["ok"] for c in ctrl)}
