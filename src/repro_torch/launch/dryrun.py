"""Multi-pod dry-run (port of ``repro.launch.dryrun``).

For every (arch x runnable shape x mesh) cell: run one rank's real
train, prefill or serve step (``launch/steps.py``'s builders) on the
production mesh, (16, 16) or (2, 16, 16), and write what the roofline
needs to ``<out>/<arch>__<shape>__<mesh>.json``.

Nothing is allocated and no card is needed.  The mesh is an
:class:`~repro_torch.distributed.ctx.AbstractMesh` seen from rank 0
(no world, no process group); the step's inputs are the builder's meta
tensors sliced to that rank's shards (``distributed.sharding.
shard_tree``); the step runs under :func:`repro_torch.launch.opcount.
count_step`, which takes the role of the reference's lowering,
compiling and ``launch/hlo.py``: its FLOPs, traffic, collectives and
memory are this rank's, per chip, as the reference's post-SPMD module's
are.  The record keeps the reference's keys; those that only a compiled
HLO module has are listed under ``omitted``.  ``t_lower_s`` is the
seconds the counted step took.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_1_7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --sweep --jobs 6     # everything, parallel
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

__all__ = ["run_cell", "cell_record", "cell_inputs", "DEFAULT_GRAD_ACCUM",
           "OMITTED", "AUDIT_OMITTED", "main"]

# per-arch microbatching: the smallest accumulation that bounds the
# per-chip saved-activation stack (the reference's defaults)
DEFAULT_GRAD_ACCUM = {"llava_next_34b": 8, "deepseek_coder_33b": 8,
                      "glm4_9b": 4}

# the reference's record keys that only a compiled HLO module has
OMITTED = {
    "cost_analysis": "XLA's cost analysis of the compiled module",
    "memory_analysis.generated_code_size_in_bytes":
        "the size of XLA's generated code",
    "weighted.whiles": "the HLO while loops and their trip counts; the "
                       "port's loops run in Python and are counted as run",
    "t_compile_s": "XLA's compile time",
    "audit": "analysis/hlo_audit.py has no counterpart",
}

AUDIT_OMITTED = ("--audit is not available: the HLO audit reads XLA's "
                 "compiled HLO (the reference's analysis/hlo_audit.py "
                 "over launch/hlo.py), which has no counterpart in the "
                 "port: its kernels are hand-written CUDA and its library "
                 "baseline is torch, so there is no HLO to audit")


def cell_inputs(cfg, mesh, shape: str, *, grad_accum: int = 1,
                pod_compress: bool = False):
    """``(fn, args)``: the step of ``shape``'s kind from the builders on
    ``mesh`` and its meta inputs sliced to the mesh rank's shards."""
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.launch.steps import build_prefill_step, \
        build_serve_step, build_train_step
    from repro_torch.models import SHAPES

    kind = SHAPES[shape].kind
    if kind == "decode":
        fn, (ps, ss, ts, _), (p, s, tokens, pos) = build_serve_step(
            cfg, mesh, shape)
        args = (shard_tree(p, ps, mesh), shard_tree(s, ss, mesh),
                shard_tree(tokens, ts, mesh), pos)
    elif kind == "prefill":
        fn, (ps, bs, _), (p, batch) = build_prefill_step(cfg, mesh, shape)
        args = (shard_tree(p, ps, mesh), shard_tree(batch, bs, mesh))
    else:
        fn, (ps, os_, bs), (p, o, batch) = build_train_step(
            cfg, mesh, shape, grad_accum=grad_accum,
            pod_compress=pod_compress)
        args = (shard_tree(p, ps, mesh), shard_tree(o, os_, mesh),
                shard_tree(batch, bs, mesh))
    return fn, args


def cell_record(arch: str, shape: str, mesh_kind: str,
                grad_accum: int | None = None,
                device_order: str = "rowmajor") -> dict:
    """The record's fields that need no step: the cell, ``status``
    ("ok", or "skipped" with the reference's ``reason`` where the shape
    is not in ``cfg.runnable_shapes()``), the mesh, the shape and the
    config's sizes, with the reference's per-arch ``grad_accum``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh, mesh_chips
    from repro_torch.models import SHAPES

    cfg = get_config(arch)
    if shape not in cfg.runnable_shapes():
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "skipped",
                "reason": f"not runnable for {cfg.family} (DESIGN.md §4)"}
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_order=device_order, abstract=True)
    spec = SHAPES[shape]
    ga = None
    if spec.kind == "train":
        ga = grad_accum if grad_accum is not None \
            else DEFAULT_GRAD_ACCUM.get(arch, 4)
    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "status": "ok",
        "chips": mesh_chips(mesh),
        "mesh_shape": dict(zip(mesh.axis_names, mesh.devices.shape)),
        "kind": spec.kind,
        "seq_len": spec.seq_len, "global_batch": spec.global_batch,
        "grad_accum": ga,
        "family": cfg.family,
        "params": cfg.params_count(),
        "active_params": cfg.active_params_count(),
    }


def run_cell(arch: str, shape: str, mesh_kind: str, outdir: str,
             grad_accum: int | None = None, device_order: str = "rowmajor",
             extra_tag: str = "", audit: bool = False) -> dict:
    """One cell: its record (:func:`cell_record`), and for a runnable
    cell rank 0's step counted on the abstract production mesh; the
    record is written to ``outdir`` and returned."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.opcount import count_step

    if audit:
        raise SystemExit(AUDIT_OMITTED)
    rec = cell_record(arch, shape, mesh_kind, grad_accum, device_order)
    if rec["status"] != "ok":
        return _write(outdir, arch, shape, mesh_kind, extra_tag, rec)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_order=device_order, abstract=True)
    fn, args = cell_inputs(get_config(arch), mesh, shape,
                           grad_accum=rec["grad_accum"] or 1,
                           pod_compress=(mesh_kind == "multi"))
    t0 = time.time()
    count = count_step(fn, *args)
    t_run = time.time() - t0
    print(f"[{arch} x {shape} x {mesh_kind}] memory: {count['memory']}")
    print(f"[{arch} x {shape} x {mesh_kind}] flops={count['flops']:.3e} "
          f"bytes={count['traffic_bytes']:.3e}")
    rec.update({
        "memory_analysis": count["memory"],
        "collectives": count["collectives"],
        "op_census": count["op_census"],
        "weighted": {
            "flops_per_chip": count["flops"],
            "traffic_bytes_per_chip": count["traffic_bytes"],
            "traffic_bytes_upper_per_chip": count["traffic_bytes_upper"],
            "collectives": count["collectives"],
        },
        "kernels": count["kernels"],
        "t_lower_s": t_run,
        "device_order": device_order,
        "omitted": OMITTED,
    })
    return _write(outdir, arch, shape, mesh_kind, extra_tag, rec)


def _write(outdir, arch, shape, mesh_kind, extra_tag, rec) -> dict:
    """Write the cell's record (a skipped cell's too, so a sweep leaves
    one file per cell of the grid); returns it."""
    os.makedirs(outdir, exist_ok=True)
    tag = f"{arch}__{shape}__{mesh_kind}" + (
        f"__{extra_tag}" if extra_tag else "")
    with open(os.path.join(outdir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _sweep(args):
    """Fan the full (arch x shape x mesh) grid out over subprocesses."""
    import itertools
    import subprocess
    import sys

    from repro_torch.configs import ARCHS
    from repro_torch.models import SHAPES

    cells = [(a, s, m) for a, s, m in itertools.product(
        ARCHS, SHAPES, ("single", "multi"))]
    if args.mesh != "both":
        cells = [c for c in cells if c[2] == args.mesh]
    procs: list = []
    results = []

    def reap(block=False):
        for p, cell, fh in procs[:]:
            if p.poll() is not None or block:
                p.wait()
                fh.close()
                procs.remove((p, cell, fh))
                results.append((cell, p.returncode))
                status = "ok" if p.returncode == 0 else "FAIL"
                print(f"[sweep] {cell} -> {status}", flush=True)

    logs = os.path.join(args.out, "logs")
    os.makedirs(logs, exist_ok=True)
    for arch, shape, mesh in cells:
        while len(procs) >= args.jobs:
            reap()
            time.sleep(0.5)
        tag = f"{arch}__{shape}__{mesh}"
        # held open across the child's lifetime; closed in reap()
        fh = open(os.path.join(logs, tag + ".log"), "w")  # noqa: SIM115
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--out", args.out]
        p = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT,
                             env=os.environ)
        procs.append((p, (arch, shape, mesh), fh))
    while procs:
        reap()
        time.sleep(0.5)
    fails = [c for c, rc in results if rc != 0]
    print(f"[sweep] done: {len(results) - len(fails)} ok, "
          f"{len(fails)} failed {fails}")
    return 1 if fails else 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--device-order", default="rowmajor",
                    choices=("rowmajor", "hilbert"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--audit", action="store_true",
                    help="the reference's HLO traffic audit: refused here "
                         "(no HLO)")
    args = ap.parse_args(argv)

    if args.audit:
        raise SystemExit(AUDIT_OMITTED)
    if args.sweep:
        raise SystemExit(_sweep(args))

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    for mk in meshes:
        try:
            rec = run_cell(args.arch, args.shape, mk, args.out,
                           grad_accum=args.grad_accum,
                           device_order=args.device_order,
                           extra_tag=args.tag)
            print(f"[dryrun] {args.arch} x {args.shape} x {mk}: "
                  f"{rec['status']}")
        except Exception:
            traceback.print_exc()
            raise SystemExit(1) from None


if __name__ == "__main__":
    main()
