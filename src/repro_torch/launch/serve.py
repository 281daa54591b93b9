"""Batched serving loop, lockstep scheduler over the paged KV cache
(port of the lockstep paged path of ``repro.launch.serve.ServeLoop``).

A fixed pool of decode slots shares one paged KV pool (Morton-ordered
physical pages, per-slot block tables, copy-free release).  A request's
whole prompt is prefilled at admission, token by token through the
decode step with a one-hot row mask; live slots then decode together,
each on its own position.  Pool exhaustion mid-decode preempts the most
recently admitted other slot, which rejoins the queue with its full
context.  Every projection runs through the SFC GEMM kernel and every
layer's attention through the paged decode kernel when the engine has a
curve schedule and the device is ``cuda``.

Not ported yet (ROADMAP.md): continuous batching, copy-on-write prefix
sharing, chaos injection, snapshots, energy metering, observability,
the tuner, the NaN guard and deadlines.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \\
      --layout paged --requests 4 --max-new 16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import DotEngine, decode_step, init_model
from repro_torch.serve import PoolExhausted, ServeConfig
from repro_torch.serve.paged_kv import init_paged_serving, \
    page_permutation, pages_needed


class ServeLoop:
    """Lockstep serving over the paged KV pool.

    ``params`` must already live on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``).  ``engine`` defaults to
    ``DotEngine()``, the Morton-scheduled SFC GEMM."""

    def __init__(self, cfg, params, config: ServeConfig | None = None, *,
                 engine: DotEngine | None = None, device=None):
        sc = config if config is not None else ServeConfig()
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the loop serves on {self.device}")
        self.cfg = cfg
        self.params = params
        self.engine = engine or DotEngine()
        self.slots = sc.slots
        self.page_size = sc.page_size
        self.temperature = sc.temperature
        self.eos_id = sc.eos_id
        self.rng = np.random.default_rng(sc.seed)
        self.alloc, self.state = init_paged_serving(
            cfg, sc.slots, sc.cache_len, page_size=sc.page_size,
            num_pages=sc.num_pages, device=self.device)
        self._perm_np = page_permutation(cfg.n_layers, self.alloc.num_pages)
        self.pos = np.zeros(sc.slots, np.int32)   # next position per slot
        self.active = np.zeros(sc.slots, bool)
        self.out: dict[int, list[int]] = {}
        self.slot_req = [-1] * sc.slots
        self.queue: list[tuple[int, list[int]]] = []
        # per-request generation budget survives preemption; admission
        # order picks the preemption victim (most recently admitted)
        self.request_emitted: dict[int, int] = {}
        self._admit_seq = [0] * sc.slots
        self._admit_counter = 0
        self.preemptions = 0
        self.admitted: list[int] = []   # request ids in admission order
        self.steps = 0                  # decode_step calls, prefill included

    # ------------------------------------------------------ paged helpers --
    def _sync_tables(self):
        self.state["block_tables"] = torch.tensor(
            self.alloc.block_table, device=self.device)

    def _scrub_pages(self, page_ids):
        """Zero the physical rows (all layers) of newly allocated pages
        that were freed before; a fresh pool is already zero."""
        dirty = [pid for pid in page_ids if self.alloc.was_freed(pid)]
        rows = [int(r) for pid in dirty for r in self._perm_np[:, pid]]
        if rows:
            idx = torch.as_tensor(rows, device=self.device)
            self.state["k_pages"][idx] = 0
            self.state["v_pages"][idx] = 0

    def _step(self, toks: np.ndarray, pos, mask: np.ndarray):
        dev = self.device
        logits, self.state = decode_step(
            self.params, self.cfg, self.state,
            torch.tensor(toks, device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev),
            self.engine, row_mask=torch.tensor(mask, device=dev))
        self.steps += 1
        return logits

    def _preempt_victim(self, needer: int) -> bool:
        """Requeue the most recently admitted other active slot with its
        full context as a new prompt (its generation budget carries
        over) and release its pages.  False when the needer is the only
        active slot."""
        cands = [s for s in range(self.slots) if s != needer and self.active[s]]
        if not cands:
            return False
        victim = max(cands, key=lambda s: self._admit_seq[s])
        req = self.slot_req[victim]
        self.active[victim] = False
        self.alloc.release(victim)
        self._sync_tables()
        self.preemptions += 1
        self.queue.insert(0, (req, list(self.out[req])))
        return True

    # -------------------------------------------------------- scheduling --
    def submit(self, req_id: int, prompt: list[int]):
        self.queue.append((req_id, list(prompt)))

    def _admit(self):
        """Lockstep admission: whole-prompt prefill, token by token
        through the decode step with only the admitted slot writing."""
        for slot in range(self.slots):
            if self.active[slot] or not self.queue:
                continue
            req_id, prompt = self.queue[0]
            need = pages_needed(len(prompt), self.page_size)
            if need > self.alloc.num_pages:
                raise RuntimeError(
                    f"prompt of {len(prompt)} tokens exceeds the whole page "
                    f"pool ({self.alloc.num_pages} pages x {self.page_size} "
                    f"tokens)")
            # +1 decode-headroom page when the pool can ever supply it
            want = min(need + 1, self.alloc.num_pages)
            if want > self.alloc.free_pages:
                break   # head-of-line blocks until a release frees pages
            self.queue.pop(0)
            self.admitted.append(req_id)
            self._scrub_pages(self.alloc.ensure_range(slot, len(prompt)))
            self._sync_tables()
            mask = np.zeros(self.slots, bool)
            mask[slot] = True
            for i, tok in enumerate(prompt):
                toks = np.zeros((self.slots, 1), np.int32)
                toks[slot, 0] = tok
                self._step(toks, i, mask)
            self.pos[slot] = len(prompt)
            self.active[slot] = True
            self.slot_req[slot] = req_id
            self.out[req_id] = list(prompt)
            self.request_emitted.setdefault(req_id, 0)
            self._admit_seq[slot] = self._admit_counter
            self._admit_counter += 1

    def _sample(self, logits_row: np.ndarray) -> int:
        if self.temperature <= 0:
            return int(np.argmax(logits_row))
        p = np.exp(logits_row / self.temperature -
                   np.max(logits_row / self.temperature))
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def _decode_once(self, max_new: int):
        """One decode step over the live slots: page allocation (with
        preemption on exhaustion), the step, then sampling and
        retirement."""
        new: list[int] = []
        for s in range(self.slots):
            while self.active[s]:
                try:
                    new += self.alloc.ensure(s, int(self.pos[s]))
                    break
                except PoolExhausted:
                    if not self._preempt_victim(s):
                        raise
        if new:
            self._scrub_pages(new)
            self._sync_tables()
        toks = np.zeros((self.slots, 1), np.int32)
        for s in range(self.slots):
            if self.active[s]:
                toks[s, 0] = self.out[self.slot_req[s]][-1]
        logits = self._step(toks, self.pos, self.active)
        logits = logits[:, 0].float().cpu().numpy()
        for s in range(self.slots):
            if not self.active[s]:
                continue
            tok = self._sample(logits[s])
            r = self.slot_req[s]
            self.out[r].append(tok)
            self.request_emitted[r] += 1
            self.pos[s] += 1
            if tok == self.eos_id or self.request_emitted[r] >= max_new:
                self.active[s] = False
                self.alloc.release(s)   # copy-free: metadata only
                self._sync_tables()

    def run(self, max_new: int = 32) -> dict[int, list[int]]:
        """Decode until queue and slots drain (max_new tokens per
        request, tracked per request so a preempted request resumes its
        budget).  Returns request id -> prompt + generated tokens."""
        while self.queue or self.active.any():
            self._admit()
            if self.active.any():
                self._decode_once(max_new)
        return self.out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--layout", default="paged",
                    choices=["contiguous", "paged"],
                    help="KV cache layout (only paged is ported)")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--mode", default="lockstep",
                    choices=["lockstep", "continuous"],
                    help="scheduler (only lockstep is ported)")
    ap.add_argument("--schedule", default="morton",
                    help="GEMM tile schedule of the SFC kernel, or 'xla' "
                         "for the torch.matmul baseline")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    serve_cfg = ServeConfig(
        slots=args.slots, cache_len=args.cache_len,
        temperature=args.temperature, seed=args.seed, layout=args.layout,
        page_size=args.page_size, num_pages=args.num_pages, mode=args.mode)
    if dev.type == "cuda" and args.schedule != "xla":
        from repro_torch.kernels import _build
        secs = _build.build()   # first-use nvcc, kept out of the timing
        print(f"[serve] kernels built in {max(secs.values()):.1f}s")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_model(cfg, gen, device=dev)
    loop = ServeLoop(cfg, params, serve_cfg,
                     engine=DotEngine(schedule=args.schedule), device=dev)
    rng = np.random.default_rng(args.seed)
    for r in range(args.requests):
        loop.submit(r, rng.integers(2, cfg.vocab, size=args.prompt_len).tolist())
    t0 = time.perf_counter()
    out = loop.run(max_new=args.max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total_new = sum(len(v) - args.prompt_len for v in out.values())
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} on {where}: {args.requests} requests "
          f"(lockstep, paged p{args.page_size}), {total_new} tokens, "
          f"{loop.steps} decode steps in {dt:.2f}s "
          f"({total_new / max(dt, 1e-9):.1f} tok/s), "
          f"{loop.preemptions} preemptions")
    for r, toks in sorted(out.items()):
        print(f"  req {r}: {toks[:args.prompt_len]} -> "
              f"{toks[args.prompt_len:][:8]}...")
    return out


if __name__ == "__main__":
    main()
