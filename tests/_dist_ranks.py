"""Rank bodies for the port's multi-rank tests (``tests/test_torch_dist_*.py``).

Each function runs on every rank of a world that
``repro_torch.distributed.ctx.spawn`` started (gloo, one thread a rank),
takes numpy inputs the test drew or took from the reference, and returns
numpy results from rank 0.  The module imports torch and ``repro_torch``
only, so the ranks never load jax.
"""
import collections
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import ctx as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import build_serve_step, build_train_step, \
    grads_of, make_serve_step, sharded_grads
from repro_torch.models import SHAPES, DotEngine
from repro_torch.models.config import ShapeSpec
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import out_proj
from repro_torch.models.transformer import init_decode_state
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.adamw import tree_leaves

TRAIN_SHAPE = ShapeSpec("dist_train", 32, 8, "train")
DEC_SHAPE = ShapeSpec("dist_dec", 32, 8, "decode")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def train_ranks(arch, np_params, np_batch, ocfg):
    """The (2,2,2) sharded train step from the reference's weights, its
    gradients at grad_accum 1 and 2, and the single-device gradients;
    the step's parameters and AdamW state gathered, beside the port's
    single-device ``adamw_update`` on the sharded and on the
    single-device gradients (:func:`adamw_single`)."""
    SHAPES[TRAIN_SHAPE.name] = TRAIN_SHAPE
    cfg = get_smoke_config(arch)
    mesh = make_smoke_mesh((2, 2, 2))
    params = params_from_jax(np_params, device="cpu")
    batch = _torch(np_batch)
    fn, (ps, os_, bs), _ = build_train_step(
        cfg, mesh, TRAIN_SHAPE.name, opt_cfg=AdamWConfig(**ocfg))
    local_b = shd.shard_tree(batch, bs, mesh)
    engine = DotEngine()
    out = {}
    for accum in (1, 2):
        _, g = sharded_grads(cfg, mesh, engine,
                             shd.shard_tree(params, ps, mesh), local_b,
                             grad_accum=accum, dp=("pod", "data"))
        full = shd.gather_tree(_unflatten_like(params, g), ps, mesh)
        out[f"grads{accum}"] = [x.numpy() for x in tree_leaves(full)]
        single = [grads_of(cfg, params, {k: v.reshape(accum, -1,
                                                      *v.shape[1:])[i]
                                         for k, v in batch.items()},
                           engine)[2] for i in range(accum)]
        out[f"single{accum}"] = [
            (sum(tree_leaves(s)[j] for s in single) / accum).numpy()
            for j in range(len(tree_leaves(params)))]
    p_loc = shd.shard_tree(params, ps, mesh)
    o_loc = shd.shard_tree(init_opt_state(params), os_, mesh)
    p_loc, o_loc, met = fn(p_loc, o_loc, local_b)
    out["loss"] = float(met["loss"])
    out["step"] = _update_leaves(shd.gather_tree(p_loc, ps, mesh),
                                 shd.gather_tree(o_loc, os_, mesh))
    out["params"] = out["step"]["params"]
    for name in ("grads1", "single1"):
        out[f"adamw_{name}"] = adamw_single(params, out[name], ocfg)
    out["names"] = leaf_names(params)
    return out


def leaf_names(tree, prefix: str = "") -> list[str]:
    """Dotted paths of a tree's leaves in ``tree_leaves`` order."""
    if not isinstance(tree, dict):
        return [prefix.rstrip(".")]
    return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                        f"{prefix}{k}.")]


def _update_leaves(params, state) -> dict:
    """The parameters and AdamW's m, v and master as numpy leaves."""
    return {"params": [x.numpy() for x in tree_leaves(params)],
            **{k: [x.numpy() for x in tree_leaves(state[k])]
               for k in ("m", "v", "master")}}


def adamw_single(params, grads, ocfg) -> dict:
    """The port's single-device ``adamw_update`` from a fresh state on a
    copy of ``params``, given gradients as numpy leaves: the parameters
    and m, v, master after it (:func:`_update_leaves`)."""
    p = _unflatten_like(params, [t.clone() for t in tree_leaves(params)])
    state = init_opt_state(p)
    g = _unflatten_like(p, [torch.from_numpy(np.asarray(x)) for x in grads])
    adamw_update(g, state, p, AdamWConfig(**ocfg))
    return _update_leaves(p, state)


def assert_update_matches(step, same_grads, single, g_single, names,
                          lr: float, tol: float = 1e-6) -> int:
    """Hold a sharded step's update (``step``: :func:`_update_leaves`)
    to the single-device AdamW:

    * on the gradients the sharded step computed (``same_grads``):
      every element of the parameters and master within ``tol``, of m
      and v within ``tol`` of the leaf's largest magnitude;
    * on the single-device gradients (``single``; the gradients
      themselves ``g_single``, which the sharded ones equal within
      1e-5 of each leaf's largest): m within 1e-5 and v (the square)
      within 2e-5 of the leaf's largest, the parameters and master
      within ``tol`` but for the elements whose gradient is f32 noise,
      ``|g| <= 1e-3`` of the leaf's largest.
      Adam's first step moves a weight by ``lr * g / (|g| + eps)``
      whatever |g|, so a gradient that differs at the 1e-5 the
      gradients are held to (the summation order across ranks) moves
      such a weight by up to ``lr`` elsewhere (C4, ROADMAP.md); each of
      those moves is the one its own gradient predicts (the first
      check), and each lies within ``lr * (1 + wd |w|)``.

    Returns the number of parameter elements off by more than ``tol``
    from the single-device AdamW (each one of the noise elements)."""
    noise = 0
    for key in ("params", "master", "m", "v"):
        for i, name in enumerate(names):
            got, want = step[key][i], same_grads[key][i]
            scale = 1.0 if key in ("params", "master") \
                else max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(got - want).max()) if got.size else 0.0
            assert err <= tol * scale, (key, name, err, tol * scale)
            g = np.abs(g_single[i])
            quiet = g <= 1e-3 * max(float(g.max()), 1e-30)
            diff = np.abs(got - single[key][i])
            if key in ("m", "v"):
                bound = (1e-5 if key == "m" else 2e-5) * scale
                assert float(diff.max(initial=0.0)) <= bound, (key, name)
                continue
            err = float(diff[~quiet].max()) if (~quiet).any() else 0.0
            assert err <= tol, (key, name, "single", err)
            if key == "params":
                noise += int((diff[quiet] > tol).sum())
                assert float(diff[quiet].max(initial=0.0)) <= 2.1 * lr, name
    return noise


def _unflatten_like(like, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def row_parallel_ranks(x, w, residual, grad: bool):
    """``out_proj`` of a row-parallel GEMM with a residual on a (1, 1, m)
    mesh: this rank's K/m columns of x and rows of w.  With ``grad``, the
    gradients of x's shard, w's shard and the residual too (gathered)."""
    m = dist.get_world_size()
    mesh = make_smoke_mesh((1, 1, m))
    r = mesh.coord["model"]
    xs = torch.from_numpy(x).chunk(m, -1)[r].contiguous()
    ws = torch.from_numpy(w).chunk(m, 0)[r].contiguous()
    res = torch.from_numpy(residual)
    with dctx.mesh_context(mesh):
        if not grad:
            with torch.no_grad():
                return {"y": out_proj(DotEngine(), xs, ws, res).numpy()}
        xs.requires_grad_(True)
        ws.requires_grad_(True)
        res.requires_grad_(True)
        y = out_proj(DotEngine(), xs, ws, res)
        y.backward(torch.ones_like(y))
        return {"y": y.detach().numpy(),
                "dx": mesh.all_gather(xs.grad, "model", -1).numpy(),
                "dw": mesh.all_gather(ws.grad, "model", 0).numpy(),
                "dres": res.grad.numpy()}


def decode_ranks(arch, np_params, sp_tokens, paged_spec):
    """SP decode (contiguous cache, row-major (2,2,2)) over the token
    rows ``sp_tokens`` (steps, B), then the kv-head-sharded paged pool
    under the Hilbert order on the ragged schedule ``paged_spec``:
    every step's logits, gathered."""
    from repro_torch.serve.paged_kv import init_paged_serving

    SHAPES[DEC_SHAPE.name] = DEC_SHAPE
    cfg = dataclasses.replace(get_smoke_config(arch), remat=False)
    params = params_from_jax(np_params, device="cpu")
    mesh = make_smoke_mesh((2, 2, 2))
    fn, (ps, ss, ts, ls), _ = build_serve_step(cfg, mesh, DEC_SHAPE.name,
                                               cache_len=32)
    params_d = shd.shard_tree(params, ps, mesh)
    state = shd.shard_tree(init_decode_state(cfg, 8, 32, device="cpu"), ss,
                           mesh)
    sp = []
    with torch.no_grad():
        for pos, row in enumerate(sp_tokens):
            toks = torch.from_numpy(np.asarray(row, np.int32)[:, None])
            ld, state = fn(params_d, state, shd.shard_tree(toks, ts, mesh),
                           torch.tensor(pos, dtype=torch.int32))
            sp.append(shd.gather_tree(ld, ls, mesh).numpy())

    hmesh = make_smoke_mesh((2, 2, 2), device_order="hilbert")
    sspec = shd.paged_decode_state_specs(cfg, hmesh)
    step = make_serve_step(cfg, hmesh, ())
    prompts, steps = paged_spec["prompts"], paged_spec["steps"]
    b = len(prompts)
    alloc, full_state = init_paged_serving(cfg, b, 32, page_size=4,
                                           device="cpu")
    pstate = shd.shard_tree(full_state, sspec, hmesh)
    hparams = shd.shard_tree(params, shd.param_specs(cfg), hmesh)
    paged, tokens = [], []

    def run(toks, pos, mask):
        nonlocal pstate
        pstate["block_tables"] = torch.as_tensor(alloc.block_table).clone()
        with torch.no_grad():
            ld, pstate = step(hparams, pstate, toks,
                              torch.tensor(pos, dtype=torch.int32), mask)
        ld = shd.gather_tree(ld, (None, None, "model"), hmesh)
        paged.append(ld.numpy())
        return ld

    for s, pr in enumerate(prompts):
        mask = torch.zeros(b, dtype=torch.bool)
        mask[s] = True
        for i, tok in enumerate(pr):
            alloc.ensure(s, i)
            toks = torch.zeros((b, 1), dtype=torch.int32)
            toks[s, 0] = tok
            run(toks, i, mask)
    pos = max(len(p) for p in prompts)
    toks = torch.tensor([[p[-1]] for p in prompts], dtype=torch.int32)
    mask = torch.ones(b, dtype=torch.bool)
    for _ in range(steps):
        for s in range(b):
            alloc.ensure(s, pos)
        ld = run(toks, pos, mask)
        toks = ld[:, 0].argmax(-1).to(torch.int32)[:, None]
        tokens.append(toks[:, 0].numpy())
        pos += 1
    return {"sp": sp, "paged": paged, "tokens": tokens,
            "pool_spec": sspec["k_pages"],
            "pool_local": tuple(pstate["k_pages"].shape)}


def checkpoint_ranks(np_params, root: str):
    """Save under (2,2,2) (gathered to rank 0), restore under (2,1,2):
    every rank's shards against ``shard_tree`` of the original, the
    gathered tree against the original; then, on the same world,
    :func:`gather_place_ranks` (under ``"gather"``)."""
    from repro_torch.checkpoint import load_checkpoint, \
        restore_with_shardings, save_checkpoint
    from repro_torch.runtime.elastic import plan_elastic_mesh

    cfg = get_smoke_config("qwen3_1_7b")
    params = params_from_jax(np_params, device="cpu")
    specs = shd.param_specs(cfg)
    mesh = make_smoke_mesh((2, 2, 2))
    full = shd.gather_to_root(shd.shard_tree(params, specs, mesh), specs,
                              mesh)
    if dist.get_rank() == 0:
        save_checkpoint(root, 3, {"params": full})
    else:
        assert full is None
    dist.barrier()
    sizes, scale = plan_elastic_mesh(("pod", "data", "model"), (2, 2, 2),
                                     failed_chips=2)
    new = make_smoke_mesh(sizes)
    out = {"sizes": sizes, "scale": scale, "equal": None}
    if new.coord is not None:
        tree, _ = load_checkpoint(root, 3, {"params": params})
        local = restore_with_shardings(tree["params"], specs, new)
        want = shd.shard_tree(params, specs, new)
        ok = all(torch.equal(a, b) for a, b in
                 zip(tree_leaves(local), tree_leaves(want)))
        bad = torch.tensor([int(not ok)])
        new.all_reduce(bad, new.axis_names, "max")
        back = shd.gather_tree(local, specs, new)
        out["equal"] = int(bad) == 0
        out["back"] = _np(back)
    dist.barrier()
    out["gather"] = gather_place_ranks(np_params)
    return out


def gather_place_ranks(np_params):
    """Under the Hilbert order on (2,2,2): ``gather_to_root`` of the
    parameters' and the ZeRO-1 state's shards (rank 0's host tree, None
    elsewhere), and ``init_model(place=shard_leaf)`` against
    ``shard_tree`` of the full draw, on every rank."""
    from repro_torch.models import init_model

    cfg = get_smoke_config("qwen3_1_7b")
    params = params_from_jax(np_params, device="cpu")
    mesh = make_smoke_mesh((2, 2, 2), device_order="hilbert")
    specs = {"params": shd.param_specs(cfg),
             "m": shd.opt_state_specs(cfg, params, mesh)["m"]}
    m = _unflatten_like(params, [torch.randn(p.shape, generator=torch.
                                             Generator().manual_seed(i))
                                 for i, p in enumerate(tree_leaves(params))])
    full = {"params": params, "m": m}
    got = shd.gather_to_root(shd.shard_tree(full, specs, mesh), specs, mesh)
    dctx.COLLECTIVES.clear()
    shd.gather_to_root(shd.shard_tree(full, specs, mesh), specs, mesh)
    sends = torch.tensor([dctx.COLLECTIVES["send_recv"]])
    mesh.all_reduce(sends, mesh.axis_names)
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    placed = init_model(cfg, gen(), device="cpu", moe_pad=2,
                        place=lambda path, t: shd.shard_leaf(
                            _spec_at(specs["params"], path), t, mesh))
    want = shd.shard_tree(init_model(cfg, gen(), device="cpu", moe_pad=2),
                          specs["params"], mesh)
    bad = torch.tensor([int(not all(
        torch.equal(a, b) and a.shape == b.shape
        for a, b in zip(tree_leaves(placed), tree_leaves(want))))])
    mesh.all_reduce(bad, mesh.axis_names, "max")
    return {"full": None if got is None else _np(got),
            "want": _np(full), "sends": int(sends),
            "placed_equal": int(bad) == 0}


def _spec_at(specs, path):
    for k in path:
        specs = specs[k]
    return specs


def moe_ep_ranks(arch, np_params, np_x, capacity_factor):
    """``moe_ep`` on a (2, 2) ("data", "model") mesh, gathered."""
    from repro_torch.models.moe import moe_ep

    cfg = get_smoke_config(arch)
    mesh = make_smoke_mesh((2, 2), ("data", "model"))
    params = params_from_jax(np_params, device="cpu")
    espec = ("model", None, None)
    pspec = {"router": (), "w1": espec, "w3": espec, "w2": espec}
    xspec = ("data", "model", None)
    x = torch.from_numpy(np_x)
    with torch.no_grad(), dctx.mesh_context(mesh):
        y, aux = moe_ep(shd.shard_tree(x, xspec, mesh),
                        shd.shard_tree(params, pspec, mesh), cfg, mesh,
                        DotEngine(), capacity_factor=capacity_factor,
                        data_axes=("data",))
        y = shd.gather_tree(y, xspec, mesh)
    return {"y": y.numpy(), "aux": float(aux),
            "collectives": dict(dctx.COLLECTIVES)}


def _tanh_stage(stage_w, x):
    for wl in stage_w:
        x = torch.tanh(x @ wl)
    return x


def pipeline_ranks(np_w, np_x):
    """``pipeline_apply`` of tanh(h @ w) layers over the pod axis of a
    (2,2,2) mesh."""
    from repro_torch.launch.pp import pipeline_apply

    mesh = make_smoke_mesh((2, 2, 2))
    y = pipeline_apply(_tanh_stage, torch.from_numpy(np_w),
                       torch.from_numpy(np_x), mesh, axis="pod")
    return {"y": y.numpy(), "sends": dctx.COLLECTIVES["send_recv"]}


def mesh_step_ranks(arch, np_params, np_batch, ocfg, model: int):
    """``make_train_step`` given a (1, 1, model) mesh, on this rank's
    shards: the loss, the step's gradients (``sharded_grads``) and its
    parameters and AdamW state, gathered; or the error a model axis the
    heads do not divide raises."""
    from repro_torch.launch.steps import make_train_step, sharded_opt_state

    cfg = get_smoke_config(arch)
    mesh = make_smoke_mesh((1, 1, model))
    specs = shd.param_specs(cfg)
    full = params_from_jax(np_params, device="cpu")
    params = shd.shard_tree(full, specs, mesh)
    step = make_train_step(cfg, mesh, AdamWConfig(**ocfg))
    opt = sharded_opt_state(cfg, mesh, params)
    ospecs = shd.opt_state_specs(cfg, full, mesh)
    batch = _torch(np_batch)
    try:
        _, g = sharded_grads(cfg, mesh, DotEngine(), params, batch,
                             dp=("pod", "data"))
        params, opt, met = step(params, opt, batch)
    except ValueError as e:
        return {"error": str(e)}
    grads = shd.gather_tree(_unflatten_like(params, g), specs, mesh)
    out = _update_leaves(shd.gather_tree(params, specs, mesh),
                         shd.gather_tree(opt, ospecs, mesh))
    return {"loss": float(met["loss"]), "step": out,
            "params": out["params"], "names": leaf_names(full),
            "grads": [x.numpy() for x in tree_leaves(grads)]}


def gemm_dtypes_ranks(arch, ways: int):
    """The operand dtypes of every B1 call (``ops.sfc_matmul``) in one
    bf16 forward and backward (``grads_of``), counted by (x dtype, w
    dtype), on one device and on a (1, 1, ways) mesh."""
    from repro_torch.kernels import ops
    from repro_torch.models import init_model, make_batch

    cfg = dataclasses.replace(get_smoke_config(arch),
                              param_dtype="bfloat16", act_dtype="bfloat16")
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = make_smoke_mesh((1, 1, ways))
    batch = make_batch(cfg, TRAIN_SHAPE, seed=1)
    seen: collections.Counter = collections.Counter()
    real = ops.sfc_matmul

    def spy(x, w, *args, **kw):
        seen[(str(x.dtype), str(w.dtype))] += 1
        return real(x, w, *args, **kw)

    ops.sfc_matmul = spy
    try:
        grads_of(cfg, params, batch, DotEngine())
        single = dict(seen)
        seen.clear()
        sharded_grads(cfg, mesh, DotEngine(),
                      shd.shard_tree(params, shd.param_specs(cfg), mesh),
                      batch, dp=())
    finally:
        ops.sfc_matmul = real
    return {"single": single, "mesh": dict(seen)}


def moe_ffn_ranks(arch, np_params, np_x, impl):
    """``moe_ffn`` under a (1, 2) ("data", "model") mesh context, the
    experts sharded, x replicated: the gathered output."""
    from repro_torch.models.moe import moe_ffn

    cfg = get_smoke_config(arch)
    mesh = make_smoke_mesh((1, 2), ("data", "model"))
    espec = ("model", None, None)
    pspec = {"router": (), "w1": espec, "w3": espec, "w2": espec}
    params = shd.shard_tree(params_from_jax(np_params, device="cpu"), pspec,
                            mesh)
    with torch.no_grad(), dctx.mesh_context(mesh):
        y, aux = moe_ffn(torch.from_numpy(np_x), params, cfg, DotEngine(),
                         mesh=mesh, impl=impl)
    return {"y": y.numpy(), "aux": float(aux)}
