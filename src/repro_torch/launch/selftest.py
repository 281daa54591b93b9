"""Distributed correctness checks (port of ``repro.launch.selftest``):
the reference's eight checks, with its names and bounds, over the port.

    PYTHONPATH=src python -m repro_torch.launch.selftest [check ...] \\
        [--device cpu|cuda]

``--device cpu`` starts the
ranks a check needs, each with one thread, on gloo: 8 for the (2,2,2)
meshes, 4 for the moe's (2,2).  ``--device cuda`` runs every check on
one card, a world of one NCCL rank, each mesh cut to size 1 on every
axis.  Each check holds the sharded result to the port's single-device
result, as the reference holds its GSPMD steps to its single-device
ones, and rank 0 prints ``OK <check> ...``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.distributed import ctx as dctx
from repro_torch.distributed.sharding import gather_to_root, gather_tree, \
    shard_tree
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import build_serve_step, build_train_step, \
    make_serve_step, make_train_step
from repro_torch.models import SHAPES, DotEngine, init_decode_state, \
    init_model, make_batch
from repro_torch.models.config import ShapeSpec
from repro_torch.models.transformer import decode_step
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.optim.adamw import _tree_map, tree_leaves

SHAPE = ShapeSpec("st_train", 32, 8, "train")
SHAPES[SHAPE.name] = SHAPE
DEC_SHAPE = ShapeSpec("st_dec", 32, 8, "decode")
SHAPES[DEC_SHAPE.name] = DEC_SHAPE

# ranks each check needs on the CPU
WORLD = {"moe_ep_matches_capacity": 4}


def _dims(shape) -> tuple:
    """The check's mesh shape, or all ones in a world of one rank."""
    return tuple(shape) if dist.get_world_size() > 1 else (1,) * len(shape)


def _device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")


def _say(msg: str) -> None:
    if dist.get_rank() == 0:
        print(msg, flush=True)


def _shared_tmpdir() -> str:
    """A temporary directory rank 0 makes, known to every rank."""
    box = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _train_setup(arch, mesh, **kw):
    dev = _device()
    cfg = get_smoke_config(arch)
    fn, specs, _ = build_train_step(
        cfg, mesh, SHAPE.name, opt_cfg=AdamWConfig(peak_lr=1e-2, warmup=0),
        **kw)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev, moe_pad=mesh.shape["model"])
    opt = init_opt_state(params)
    if kw.get("pod_compress"):
        pods = mesh.shape.get("pod", 1)
        opt["ef"] = _tree_map(lambda p: torch.zeros(
            (pods,) + tuple(p.shape), device=dev), params)
    batch = make_batch(cfg, SHAPE, seed=1, device=dev)
    return cfg, fn, specs, params, opt, batch


def check_dp_tp_matches_single(arch="qwen3_1_7b"):
    """Sharded step == single-device step (same loss, ~same params)."""
    mesh = make_smoke_mesh(_dims((2, 2, 2)))
    cfg, fn, (ps, os_, bs), params, opt, batch = _train_setup(arch, mesh)
    pd, _, md = fn(shard_tree(params, ps, mesh), shard_tree(opt, os_, mesh),
                   shard_tree(batch, bs, mesh))
    full = gather_tree(pd, ps, mesh)
    ref_step = make_train_step(cfg, None, AdamWConfig(peak_lr=1e-2,
                                                      warmup=0))
    pr, _, mr = ref_step(params, opt, batch)
    lm, lr_ = float(md["loss"]), float(mr["loss"])
    assert abs(lm - lr_) / max(abs(lr_), 1e-6) < 5e-3, (lm, lr_)
    for a, b in zip(tree_leaves(full), tree_leaves(pr)):
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().cpu().numpy(),
                                   rtol=5e-2, atol=5e-2)
    _say(f"OK dp_tp_matches_single {arch} loss {lm:.4f}~{lr_:.4f}")


def check_sp_decode_matches_local(arch="qwen3_1_7b"):
    """Sequence-parallel decode == single-device decode, step by step."""
    dev = _device()
    mesh = make_smoke_mesh(_dims((2, 2, 2)))
    cfg = dataclasses.replace(get_smoke_config(arch), remat=False)
    fn, (ps, ss, ts, ls), _ = build_serve_step(cfg, mesh, DEC_SHAPE.name,
                                               cache_len=32)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev, moe_pad=mesh.shape["model"])
    state_d = shard_tree(init_decode_state(cfg, 8, 32, device=dev), ss,
                         mesh)
    params_d = shard_tree(params, ps, mesh)
    state_l = init_decode_state(cfg, 8, 32, device=dev)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for pos in range(6):
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1))
                                    .astype(np.int32)).to(dev)
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            ld, state_d = fn(params_d, state_d, shard_tree(toks, ts, mesh), p)
            ld = gather_tree(ld, ls, mesh)
            ll, state_l = decode_step(params, cfg, state_l, toks, p)
            np.testing.assert_allclose(ld.cpu().numpy(), ll.cpu().numpy(),
                                       rtol=3e-3, atol=3e-3)
    _say(f"OK sp_decode_matches_local {arch}")


def check_moe_ep_matches_capacity():
    """EP (all_to_all) MoE == single-device capacity dispatch."""
    from repro_torch.models.moe import init_moe, moe_capacity, moe_ep

    dev = _device()
    mesh = make_smoke_mesh(_dims((2, 2)), ("data", "model"))
    cfg = get_smoke_config("granite_moe_1b_a400m")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_moe(gen, cfg, device=dev,
                      model_axis_size=mesh.shape["model"])
    x = torch.randn((4, 8, cfg.d_model), generator=gen, device=dev)
    eng = DotEngine()
    espec = ("model", None, None)
    pspec = {"router": (), "w1": espec, "w3": espec, "w2": espec}
    xspec = ("data", "model", None)
    with torch.no_grad(), dctx.mesh_context(mesh):
        y_ep, _ = moe_ep(shard_tree(x, xspec, mesh),
                         shard_tree(params, pspec, mesh), cfg, mesh, eng,
                         capacity_factor=8.0, data_axes=("data",))
        y_ep = gather_tree(y_ep, xspec, mesh)
    # capacity_factor high enough that neither path drops tokens
    with torch.no_grad():
        y_c, _ = moe_capacity(x, params, cfg, eng, capacity_factor=8.0)
    np.testing.assert_allclose(y_ep.cpu().numpy(), y_c.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    _say("OK moe_ep_matches_capacity")


def check_pod_compress_converges(arch="qwen3_1_7b"):
    """EF-bf16 pod sync trains to ~the same loss as exact sync."""
    mesh = make_smoke_mesh(_dims((2, 2, 2)))
    losses = {}
    for pc in (False, True):
        cfg, fn, (ps, os_, bs), params, opt, batch = _train_setup(
            arch, mesh, pod_compress=pc)
        p = shard_tree(params, ps, mesh)
        o = shard_tree(opt, os_, mesh)
        b = shard_tree(batch, bs, mesh)
        for _ in range(8):
            p, o, m = fn(p, o, b)
        losses[pc] = float(m["loss"])
    assert abs(losses[True] - losses[False]) < 0.15 * abs(losses[False]) \
        + 0.05, losses
    _say(f"OK pod_compress_converges exact={losses[False]:.4f} "
         f"ef-bf16={losses[True]:.4f}")


def check_checkpoint_elastic_reshard():
    """Save under (2,2,2), restore under (2,1,2) with the new mesh's
    shards: bit-equal."""
    from repro_torch.checkpoint import load_checkpoint, \
        restore_with_shardings, save_checkpoint
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.runtime.elastic import plan_elastic_mesh

    dev = _device()
    cfg = get_smoke_config("qwen3_1_7b")
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev, moe_pad=2)
    specs = param_specs(cfg)
    mesh = make_smoke_mesh(_dims((2, 2, 2)))
    full = gather_to_root(shard_tree(params, specs, mesh), specs, mesh)
    d = _shared_tmpdir()
    if dist.get_rank() == 0:
        save_checkpoint(d, 3, {"params": full})
    dist.barrier()
    # plan: lose 2 chips from a (2,2,2)=8 mesh -> data 2->1
    new_sizes, scale = plan_elastic_mesh(
        ("pod", "data", "model"), (2, 2, 2), failed_chips=2)
    assert new_sizes == (2, 1, 2) and scale == 2, (new_sizes, scale)
    new_mesh = make_smoke_mesh(_dims(new_sizes))
    if new_mesh.coord is not None:
        tree, _ = load_checkpoint(d, 3, {"params": params})
        tree = _tree_map(lambda t: t.to(dev), tree["params"])
        local = restore_with_shardings(tree, specs, new_mesh)
        want = shard_tree(params, specs, new_mesh)
        for a, b in zip(tree_leaves(local), tree_leaves(want)):
            assert torch.equal(a, b)
        back = gather_tree(local, specs, new_mesh)
        for a, b in zip(tree_leaves(back), tree_leaves(params)):
            assert torch.equal(a, b)
    _say("OK checkpoint_elastic_reshard")


def check_train_cli_with_failure():
    """train.py end-to-end on a mesh with an injected failure + resume."""
    from repro_torch.launch.train import main

    d = _shared_tmpdir()
    dims = ",".join(str(x) for x in _dims((2, 2, 2)))
    state = main(["--arch", "qwen3_1_7b", "--smoke", "--steps", "30",
                  "--batch", "8", "--seq", "32", "--mesh", dims,
                  "--ckpt-dir", d, "--ckpt-every", "10",
                  "--inject-failure-at", "17", "--log-every", "10",
                  "--device", _device().type])
    assert state["last_loss"] is not None
    _say("OK train_cli_with_failure")


def check_paged_sharded_matches_replicated(arch="qwen3_1_7b"):
    """kv-head-sharded paged pool == single device: the same logits under
    a ragged slot-isolated prefill and a lockstep greedy decode, on the
    Hilbert device order.  ``REPRO_PARITY_SPEC`` (JSON: {"prompts":
    [[...], ...], "steps": N}) overrides the schedule."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.serve.paged_kv import init_paged_serving

    dev = _device()
    spec_env = os.environ.get("REPRO_PARITY_SPEC")
    spec = json.loads(spec_env) if spec_env else {
        "prompts": [[5, 6, 7, 8, 9], [3, 4, 5], [7], [2, 3, 4, 5]],
        "steps": 3}
    prompts, steps = spec["prompts"], int(spec["steps"])
    b = len(prompts)
    mesh = make_smoke_mesh(_dims((2, 2, 2)), device_order="hilbert")
    cfg = dataclasses.replace(get_smoke_config(arch), remat=False)
    m = mesh.shape["model"]
    assert cfg.n_kv_heads % m == 0, (cfg.n_kv_heads, m)
    sspec = shd.paged_decode_state_specs(cfg, mesh)
    if m > 1:
        assert sspec["k_pages"] == (None, None, "model", None), sspec
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    fn = make_serve_step(cfg, mesh, ())
    p_spec = shd.param_specs(cfg)
    alloc, state_l = init_paged_serving(cfg, b, 32, page_size=4, device=dev)
    params_d = shard_tree(params, p_spec, mesh)
    state_d = shard_tree(init_paged_serving(cfg, b, 32, page_size=4,
                                            device=dev)[1],
                         shd.paged_decode_state_specs(cfg, mesh), mesh)

    def both(toks, pos, mask):
        nonlocal state_d, state_l
        bt = torch.as_tensor(alloc.block_table, device=dev)
        state_d["block_tables"] = bt.clone()
        state_l["block_tables"] = bt.clone()
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        with torch.no_grad():
            ld, state_d = fn(params_d, state_d, toks, p, mask)
            ld = gather_tree(ld, (None, None, "model"), mesh)
            ll, state_l = decode_step(params, cfg, state_l, toks, p,
                                      row_mask=mask)
        np.testing.assert_allclose(ld.cpu().numpy(), ll.cpu().numpy(),
                                   rtol=3e-3, atol=3e-3)
        return ll

    for s, pr in enumerate(prompts):      # ragged slot-isolated prefill
        mask = torch.zeros(b, dtype=torch.bool, device=dev)
        mask[s] = True
        for i, tok in enumerate(pr):
            alloc.ensure(s, i)
            toks = torch.zeros((b, 1), dtype=torch.int32, device=dev)
            toks[s, 0] = tok
            both(toks, i, mask)
    pos = max(len(p) for p in prompts)
    toks = torch.tensor([[p[-1]] for p in prompts], dtype=torch.int32,
                        device=dev)
    mask = torch.ones(b, dtype=torch.bool, device=dev)
    for _ in range(steps):                # lockstep greedy decode
        for s in range(b):
            alloc.ensure(s, pos)
        ll = both(toks, pos, mask)
        toks = ll[:, 0].argmax(-1).to(torch.int32)[:, None]
        pos += 1
    _say(f"OK paged_sharded_matches_replicated {arch} b={b} steps={steps}")


def _tanh_stage(stage_w, x):
    for wl in stage_w:
        x = torch.tanh(x @ wl)
    return x


def check_pipeline_parallel_matches_sequential():
    """GPipe pipeline over the pod axis == sequential layers."""
    from repro_torch.launch.pp import pipeline_apply

    dev = _device()
    mesh = make_smoke_mesh(_dims((2, 2, 2)))
    n_layers, d, m, mb = 4, 16, 3, 8
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((n_layers, d, d), generator=gen, device=dev) \
        * (0.5 / np.sqrt(d))
    x = torch.randn((m, mb, d), generator=gen, device=dev)
    y_pp = pipeline_apply(_tanh_stage, w, x, mesh, axis="pod")
    y_ref = torch.stack([_tanh_stage(w, xi) for xi in x])
    np.testing.assert_allclose(y_pp.cpu().numpy(), y_ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    _say("OK pipeline_parallel_matches_sequential")


CHECKS = {k[len("check_"):]: v for k, v in globals().items()
          if k.startswith("check_")}


def run_check(name: str) -> None:
    """One check on this rank (the world already joined)."""
    CHECKS[name]()


def run(name: str, device: str) -> None:
    """Start the ranks ``name`` needs on ``device`` and run it."""
    world = 1 if torch.device(device).type == "cuda" else WORLD.get(name, 8)
    dctx.spawn(run_check, world, name, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checks", nargs="*", help=f"default: all of {list(CHECKS)}")
    ap.add_argument("--device", default=None,
                    help="cuda (default: one card, world size 1) or cpu "
                         "(gloo ranks)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type
    for name in args.checks or list(CHECKS):
        if name not in CHECKS:
            raise SystemExit(f"unknown check {name!r}; choose from "
                             f"{list(CHECKS)}")
        run(name, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
