"""End-to-end training (port of ``repro.launch.train``), on one device
or on a mesh of ranks.

Composes the config registry (``--arch``), synthetic packed data with a
prefetching loader, the train step (``launch/steps.py``: every
projection's forward, dgrad and wgrad GEMM through the engine, AdamW
with f32 master weights), asynchronous checkpoints with resume from the
latest one, the retrying step executor with failure injection, the
straggler monitor, an energy meter per step and the span trace.  Runs
on the card unless ``--device cpu`` is given; the GEMMs run the SFC
kernel in ``--schedule`` order (default Morton; ``auto`` with
``--objective``; ``xla`` for the library baseline).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_1_7b \\
      --smoke --device cpu --steps 4 --batch 4 --seq 32

``--mesh 2,2,2`` trains on a (pod, data, model) mesh (fewer numbers
name the last axes): the one command starts ``prod(dims)`` ranks itself
(gloo ranks with ``--device cpu``, one NCCL rank per card otherwise; a
mesh larger than the visible cards raises), or, inside a world already
joined, runs as its ranks.  Every rank builds the full model from the
seed and keeps its shards (``distributed.sharding``); the step is
``launch/steps.py``'s sharded one, ``--pod-compress`` its error-feedback
bf16 cross-pod mean, ``--device-order`` the curve the ranks are laid
along (``launch/mesh.py``).  Checkpoints hold full trees, gathered to
rank 0 and written there; a resume slices them for the mesh.

``main`` returns the final state (``params``, ``opt``, ``last_loss`` and
``history``: each step's loss, host ms and joules); a command that
started its own ranks returns rank 0's ``last_loss``.
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, \
    load_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.energy import H100
from repro_torch.data import PackedSyntheticData, PrefetchLoader
from repro_torch.data.pipeline import batch_to_device
from repro_torch.device import resolve_device
from repro_torch.launch.steps import _engine_for, build_train_step, \
    make_train_step, sharded_opt_state
from repro_torch.models import DotEngine, fused_epilogue_savings_bytes, \
    init_model
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.obs import Tracer, default_registry, null_registry, \
    set_default_tracer, trace_span
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.optim.adamw import tree_leaves
from repro_torch.power import EnergyMeter, EnergyReport, WorkloadHints, \
    detect_backend
from repro_torch.runtime import FailureInjector, StepExecutor, \
    StragglerMonitor
from repro_torch.tune.objective import OBJECTIVES


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2,2,2' for a (pod, data, model) mesh of "
                         "ranks")
    ap.add_argument("--device-order", default="rowmajor",
                    help="lay the mesh's ranks along this curve "
                         "(rowmajor|hilbert|morton)")
    ap.add_argument("--pod-compress", action="store_true",
                    help="error-feedback bf16 gradients across pods")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--power-backend", default=None,
                    choices=["rapl", "nvml", "model"],
                    help="pin the energy telemetry backend (default: auto, "
                         "which prefers RAPL, the CPU package, where it is "
                         "readable; nvml is the card)")
    ap.add_argument("--energy-report", default=None, metavar="PATH",
                    help="write the per-step energy report JSON here")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the span trace as JSONL here (convert / "
                         "validate with python -m repro_torch.obs.trace)")
    ap.add_argument("--metrics-report", default=None, metavar="PATH",
                    help="write the metrics registry snapshot JSON here")
    ap.add_argument("--no-obs", action="store_true",
                    help="disable the metrics and span layer")
    ap.add_argument("--objective", default=None, choices=list(OBJECTIVES),
                    help="route every GEMM through the autotuner "
                         "adjudicated on this metric")
    ap.add_argument("--schedule", default=None,
                    help="GEMM tile schedule of the SFC kernel, 'xla' for "
                         "the library baseline, or 'auto' for the tuner "
                         "(default: morton, auto with --objective)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def _f_scales(cfg, args, tokens: int, backend: str) -> dict:
    """The DVFS point of the tuned winner of each GEMM family (with an
    objective), keyed as the reference keys them."""
    f_scales = {"proj": 1.0, "attn": 1.0, "mlp": 1.0, "vocab": 1.0}
    if not args.objective:
        return f_scales
    from repro_torch.tune import EpilogueSpec, resolved_f_scale

    kw = dict(objective=args.objective, backend=backend)
    f_scales["proj"] = resolved_f_scale(
        tokens, cfg.d_model, cfg.d_model, cfg.act_dtype,
        epilogue=EpilogueSpec(residual=True), **kw)
    if cfg.has_attention and cfg.n_heads:
        f_scales["attn"] = resolved_f_scale(
            tokens, cfg.d_model, cfg.n_heads * cfg.d_head, cfg.act_dtype,
            epilogue=EpilogueSpec(residual=True), **kw)
    if cfg.d_ff:
        f_scales["mlp"] = resolved_f_scale(
            tokens, cfg.d_ff, cfg.d_model, cfg.act_dtype,
            epilogue=EpilogueSpec(activation="silu"), **kw)
    if cfg.vocab:
        f_scales["vocab"] = resolved_f_scale(
            tokens, cfg.padded_vocab, cfg.d_model, cfg.act_dtype, **kw)
    return f_scales


def _mesh_dims(args) -> tuple | None:
    return tuple(int(x) for x in args.mesh.split(",")) if args.mesh \
        else None


def _spawn_ranks(argv, args, dev) -> dict:
    """Start ``prod(dims)`` ranks of this command and return rank 0's
    final loss: gloo ranks on the CPU, one NCCL rank per card."""
    from repro_torch.distributed.ctx import spawn

    n = math.prod(_mesh_dims(args))
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(
            f"--mesh {args.mesh} needs {n} cards; "
            f"{torch.cuda.device_count()} are visible (--device cpu runs "
            f"it on CPU ranks)")
    return spawn(_rank_main, n, list(argv), device=dev.type)


def _rank_main(argv) -> dict:
    return {"last_loss": main(argv)["last_loss"]}


class _MeshRun:
    """The mesh half of a run: the mesh, the sharded step and the
    conversions between this rank's shards and the full trees."""

    def __init__(self, args, cfg, shape, opt_cfg, engine, dev):
        from repro_torch.launch.mesh import link_distance, make_smoke_mesh

        dims = _mesh_dims(args)
        names = ("pod", "data", "model")[-len(dims):]
        self.mesh = make_smoke_mesh(dims, names,
                                    device_order=args.device_order)
        self.rank0 = dist.get_rank() == 0
        if args.device_order != "rowmajor" and self.rank0:
            hops = link_distance(self.mesh)
            print("[train] device_order=%s ring-neighbour hops %s" % (
                args.device_order,
                " ".join(f"{a}={h:.2f}" for a, h in hops.items())))
        SHAPES[shape.name] = shape
        self.pod_compress = args.pod_compress and "pod" in names
        self.step_fn, (self.ps, self.os, self.bs), _ = build_train_step(
            cfg, self.mesh, shape.name, opt_cfg=opt_cfg,
            grad_accum=args.grad_accum, pod_compress=self.pod_compress,
            engine=engine, objective=args.objective)
        self.cfg, self.dev = cfg, dev

    def init(self, seed: int):
        """This rank's parameter shards and AdamW state, each leaf drawn
        in the unsharded run's order and sliced as soon as it is drawn
        (the full tree never exists on the card)."""
        from repro_torch.distributed.sharding import shard_leaf

        self.n_params = 0

        def place(path, leaf):
            spec = self.ps
            for k in path:
                spec = spec[k]
            self.n_params += leaf.numel()
            return shard_leaf(spec, leaf, self.mesh)

        params = init_model(self.cfg, torch.Generator(
            device=self.dev).manual_seed(seed), device=self.dev,
            moe_pad=self.mesh.shape["model"], place=place)
        return params, sharded_opt_state(self.cfg, self.mesh, params,
                                          pod_compress=self.pod_compress)

    def full(self, params, opt):
        """The full trees in rank 0's host memory, leaf by leaf (None on
        the other ranks, which send their shards)."""
        from repro_torch.distributed.sharding import gather_to_root
        return gather_to_root({"params": params, "opt": opt},
                              {"params": self.ps, "opt": self.os},
                              self.mesh)

    def shards(self, tree):
        """This rank's shards of a loaded (host) tree, sliced on the host
        and moved to the card."""
        from repro_torch.checkpoint import restore_with_shardings
        return (_to_device(restore_with_shardings(
                    tree["params"], self.ps, self.mesh), self.dev),
                _to_device(restore_with_shardings(
                    tree["opt"], self.os, self.mesh), self.dev))

    def put(self, batch):
        from repro_torch.distributed.sharding import shard_tree
        return shard_tree(batch_to_device(batch, self.dev), self.bs,
                          self.mesh)


def main(argv=None):
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.mesh:
        from repro_torch.launch.mesh import DEVICE_ORDERS
        if args.device_order not in DEVICE_ORDERS:
            raise ValueError(
                f"unknown device_order {args.device_order!r}; supported "
                f"orders: {', '.join(DEVICE_ORDERS)}")
    if args.mesh and not dist.is_initialized():
        return _spawn_ranks(sys.argv[1:] if argv is None else argv, args,
                            dev)
    if args.mesh and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    # per-step spans (energy attributed to them by the meter) and a
    # step-latency histogram, written out on request
    tracer = None
    if args.trace and not args.no_obs:
        tracer = Tracer(enabled=True)
        set_default_tracer(tracer)
    metrics = null_registry() if args.no_obs else default_registry()
    m_step_ms = metrics.histogram("train.step_ms")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeSpec("cli", seq_len=args.seq, global_batch=args.batch,
                      kind="train")
    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup=min(10, args.steps // 5),
                          total_steps=args.steps)
    if dev.type == "cuda" and args.schedule != "xla":
        from repro_torch.kernels import _build
        secs = _build.build()   # first-use nvcc, kept out of the steps
        print(f"[train] kernels built in {max(secs.values()):.1f}s")
    engine = _engine_for(DotEngine(schedule=args.schedule)
                         if args.schedule else None, args.objective)
    run = _MeshRun(args, cfg, shape, opt_cfg, engine, dev) if args.mesh \
        else None
    rank0 = run is None or run.rank0
    if run is None:
        step_fn = make_train_step(cfg, None, opt_cfg,
                                  grad_accum=args.grad_accum, engine=engine,
                                  objective=args.objective)
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(
            args.seed), device=dev)
        opt_state = init_opt_state(params)
    else:
        step_fn = run.step_fn
        params, opt_state = run.init(args.seed)

    def to_state(tree):
        if run is None:
            return (_to_device(tree["params"], dev),
                    _to_device(tree["opt"], dev))
        return run.shards(tree)

    # a mesh run saves full trees, gathered to rank 0 (every rank joins
    # the gather) and written there
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir and rank0 \
        else None
    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            tree, _ = load_checkpoint(args.ckpt_dir, last,
                                      {"params": params, "opt": opt_state})
            params, opt_state = to_state(tree)
            start = last
            if rank0:
                print(f"[train] resumed from step {start}")

    data = PackedSyntheticData(cfg, shape, seed=args.seed)
    loader = PrefetchLoader(data, start_step=start, put_fn=(
        run.put if run is not None else lambda b: batch_to_device(b, dev)))
    loader_iter = iter(loader)

    injector = FailureInjector(
        {args.inject_failure_at: "simulated-node-loss"}
        if args.inject_failure_at is not None else {})
    monitor = StragglerMonitor()
    state = {"params": params, "opt": opt_state, "last_loss": None}

    # per-step energy: NVML on the card, the analytic model (static
    # power x step time + 6 N tokens FLOPs) where no counter is readable
    power = detect_backend(args.power_backend)
    n_params = run.n_params if run is not None \
        else sum(p.numel() for p in tree_leaves(params))
    tokens = args.batch * args.seq
    step_flops = 6.0 * n_params * tokens
    # device-memory passes the forward no longer makes (fused epilogues)
    ep_saved = fused_epilogue_savings_bytes(cfg, tokens)
    # DVFS hints per GEMM shape: the report carries each, the scalar hint
    # the dominant projection's
    f_scales = _f_scales(cfg, args, tokens, dev.type)
    f_scale = f_scales["proj"]
    step_hints = WorkloadHints(flops=step_flops, f_scale=f_scale)
    energy = EnergyReport(backend=power.name, meta={
        "driver": "train", "arch": args.arch, "steps": args.steps,
        "batch": args.batch, "seq": args.seq, "params": n_params,
        "objective": args.objective or "time", "f_scale": f_scale,
        "f_scale_per_shape": dict(f_scales),
        "fused_epilogue_saved_bytes_fwd": ep_saved,
        "schedule": engine.schedule,
        "device": str(dev)})

    history: dict[int, dict] = {}   # the last attempt of each step

    def one_step(state, step):
        _, batch = next(loader_iter)
        t0 = time.perf_counter()
        with trace_span("train.step", step=step), \
                EnergyMeter(f"step-{step}", backend=power, reporter=energy,
                            hints=step_hints) as em:
            p, o, met = step_fn(state["params"], state["opt"], batch)
            state = {"params": p, "opt": o, "last_loss": float(met["loss"])}
        ms = (time.perf_counter() - t0) * 1e3
        m_step_ms.observe(ms)
        history[step] = {"loss": state["last_loss"], "ms": ms,
                         "joules": em.reading.joules}
        if rank0 and (step % args.log_every == 0
                      or step == start + args.steps - 1):
            print(f"[train] step {step} loss {state['last_loss']:.4f} "
                  f"gnorm {float(met['grad_norm']):.3f} "
                  f"lr {float(met['lr']):.2e} "
                  f"E {em.reading.joules:.2f}J "
                  f"EDP {em.reading.edp:.3e}Js", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            tree = {"params": p, "opt": o} if run is None \
                else run.full(p, o)
            if ckpt:   # rank 0's gathered tree is a host copy already
                ckpt.save(step + 1, tree, copy=run is None)
        return state

    def restore(step):
        if not args.ckpt_dir:
            return state
        if ckpt:
            ckpt.wait()
        if run is not None:   # rank 0's write is done before any reads
            dist.barrier()
        last = latest_step(args.ckpt_dir)
        if last is None:
            return state
        tree, _ = load_checkpoint(
            args.ckpt_dir, last,
            {"params": state["params"], "opt": state["opt"]})
        if rank0:
            print(f"[train] restored step {last} after failure", flush=True)
        params, opt = to_state(tree)
        return {"params": params, "opt": opt, "last_loss": None}

    executor = StepExecutor(one_step, restore, injector=injector,
                            monitor=monitor, metrics=metrics)
    t0 = time.time()
    final_state, _ = executor.run(state, start, args.steps)
    final_state["history"] = [history[k] for k in sorted(history)]
    dt = time.time() - t0
    loader.close()
    if ckpt:
        ckpt.close()
    if hasattr(power, "close"):   # NVML's sampling thread
        power.close()
    if not rank0:
        return final_state
    totals = energy.totals()
    print(f"[train] done: {args.steps} steps in {dt:.1f}s "
          f"({dt / max(args.steps, 1) * 1e3:.0f} ms/step) on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
          f", final loss {final_state['last_loss']:.4f}, "
          f"retries {len(executor.retries)}, "
          f"straggler events {len(monitor.events)}")
    n_steps = max(args.steps, 1)
    print(f"[train] energy ({power.name}, objective="
          f"{args.objective or 'time'}, f_scale proj {f_scales['proj']:g}"
          f" / attn {f_scales['attn']:g} / mlp {f_scales['mlp']:g} / "
          f"vocab {f_scales['vocab']:g}): "
          f"{totals['joules']:.1f} J total, "
          f"{totals['joules'] / n_steps:.2f} J/step, "
          f"{totals['joules'] * totals['seconds'] / n_steps ** 2:.3e} "
          f"Js EDP/step, "
          f"{totals['joules'] / max(totals['seconds'], 1e-9):.1f} W avg")
    print(f"[train] fused epilogues: ~{ep_saved / 1e6:.1f} MB/fwd of "
          f"device-memory traffic eliminated (~{ep_saved * H100.e_hbm:.3f} "
          f"J/fwd at the H100 model's e_hbm)")
    if args.energy_report:
        energy.write(args.energy_report)
        print(f"[train] wrote energy report to {args.energy_report}")
    if args.metrics_report:
        metrics.write(args.metrics_report)
        print(f"[train] wrote metrics snapshot to {args.metrics_report}")
    if tracer is not None:
        tracer.write_jsonl(args.trace)
        print(f"[train] wrote {len(tracer.events)} trace events to "
              f"{args.trace}")
    return final_state


if __name__ == "__main__":
    main()
