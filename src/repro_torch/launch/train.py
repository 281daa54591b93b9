"""End-to-end training on one device (port of
``repro.launch.train``).

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

The mesh (``--mesh``, ``--device-order``) and pod compression
(``--pod-compress``) wait for the distributed slice (ROADMAP.md queue
A, A15) and raise.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, \
    load_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.energy import H100
from repro_torch.data import PackedSyntheticData, PrefetchLoader
from repro_torch.data.pipeline import batch_to_device
from repro_torch.device import resolve_device
from repro_torch.launch.steps import _engine_for, make_train_step
from repro_torch.models import DotEngine, fused_epilogue_savings_bytes, \
    init_model
from repro_torch.models.config import ShapeSpec
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
                    help="not ported yet (ROADMAP.md queue A, A15)")
    ap.add_argument("--device-order", default=None,
                    help="not ported yet (ROADMAP.md queue A, A15)")
    ap.add_argument("--pod-compress", action="store_true",
                    help="not ported yet (ROADMAP.md queue A, A15)")
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


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.mesh or args.device_order or args.pod_compress:
        raise NotImplementedError(
            "--mesh, --device-order and --pod-compress are not ported yet "
            "(ROADMAP.md queue A, A15)")
    dev = resolve_device(args.device)

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
    step_fn = make_train_step(cfg, None, opt_cfg, grad_accum=args.grad_accum,
                              engine=engine, objective=args.objective)

    params = init_model(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)
    opt_state = init_opt_state(params)

    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            tree, _ = load_checkpoint(args.ckpt_dir, last,
                                      {"params": params, "opt": opt_state})
            params = _to_device(tree["params"], dev)
            opt_state = _to_device(tree["opt"], dev)
            start = last
            print(f"[train] resumed from step {start}")

    data = PackedSyntheticData(cfg, shape, seed=args.seed)
    loader = PrefetchLoader(data, start_step=start,
                            put_fn=lambda b: batch_to_device(b, dev))
    loader_iter = iter(loader)

    injector = FailureInjector(
        {args.inject_failure_at: "simulated-node-loss"}
        if args.inject_failure_at is not None else {})
    monitor = StragglerMonitor()
    state = {"params": params, "opt": opt_state, "last_loss": None}

    # per-step energy: NVML on the card, the analytic model (static
    # power x step time + 6 N tokens FLOPs) where no counter is readable
    power = detect_backend(args.power_backend)
    n_params = sum(p.numel() for p in tree_leaves(params))
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

    def one_step(state, step):
        _, batch = next(loader_iter)
        t0 = time.perf_counter()
        with trace_span("train.step", step=step), \
                EnergyMeter(f"step-{step}", backend=power, reporter=energy,
                            hints=step_hints) as em:
            p, o, met = step_fn(state["params"], state["opt"], batch)
            state = {"params": p, "opt": o, "last_loss": float(met["loss"])}
        m_step_ms.observe((time.perf_counter() - t0) * 1e3)
        if step % args.log_every == 0 or step == start + args.steps - 1:
            print(f"[train] step {step} loss {state['last_loss']:.4f} "
                  f"gnorm {float(met['grad_norm']):.3f} "
                  f"lr {float(met['lr']):.2e} "
                  f"E {em.reading.joules:.2f}J "
                  f"EDP {em.reading.edp:.3e}Js", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": p, "opt": o})
        return state

    def restore(step):
        if not args.ckpt_dir:
            return state
        ckpt.wait()
        last = latest_step(args.ckpt_dir)
        if last is None:
            return state
        tree, _ = load_checkpoint(
            args.ckpt_dir, last,
            {"params": state["params"], "opt": state["opt"]})
        print(f"[train] restored step {last} after failure", flush=True)
        return {"params": _to_device(tree["params"], dev),
                "opt": _to_device(tree["opt"], dev), "last_loss": None}

    executor = StepExecutor(one_step, restore, injector=injector,
                            monitor=monitor, metrics=metrics)
    t0 = time.time()
    final_state, _ = executor.run(state, start, args.steps)
    dt = time.time() - t0
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
    loader.close()
    if ckpt:
        ckpt.close()
    return final_state


if __name__ == "__main__":
    main()
