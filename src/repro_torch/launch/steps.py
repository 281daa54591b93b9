"""Train and serve step builders (port of ``repro.launch.steps``).

``make_train_step`` assembles the loss and its gradients through
autograd (every projection's forward, dgrad and wgrad GEMM through the
engine; ``repro_torch.kernels.grad``), microbatch accumulation in f32,
and AdamW in place.  Given a mesh it runs on this rank's shards
(``distributed.sharding``): the model tensor-parallel under the mesh
context, each gradient summed over the data-parallel axes, the
microbatch accumulator and AdamW's state sliced over "data" (ZeRO-1,
:func:`~repro_torch.optim.adamw.adamw_update_sharded`), and with
``pod_compress`` the cross-pod mean taken over error-feedback bf16
gradients (``optim.compress``), one residual per pod.

``build_train_step``, ``build_prefill_step`` and ``build_serve_step``
return ``(fn, specs, abstract_args)``: the step on this rank's shards,
the specs its inputs and outputs are sharded by (``shard_tree`` /
``gather_tree`` convert), and the full inputs as meta tensors.  The
serve step runs either KV layout: the contiguous cache
sequence-parallel, the paged pool sharded by kv-head.

Every builder takes ``objective``: without an explicit ``engine`` it
builds ``DotEngine(schedule="auto", objective=...)``; on a mesh whose
model axis is wider than one rank the tuner-routed engine also carries
the mesh's ``CommSpec`` (:func:`_comm_for`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.ctx import dp_axes, mesh_context
from repro_torch.models import SHAPES, DotEngine, decode_inputs, forward, \
    init_decode_state, init_model, input_specs, loss_fn
from repro_torch.models.transformer import decode_step as model_decode_step
from repro_torch.obs import trace_span
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.adamw import _tree_map, adamw_update_sharded, \
    tree_leaves
from repro_torch.optim.compress import ef_compress
from repro_torch.serve.state import DecodeState, resolve_layout

__all__ = ["make_train_step", "grads_of", "build_train_step",
           "build_prefill_step", "make_serve_step", "build_serve_step",
           "abstract_train_state", "abstract_decode_state",
           "sharded_opt_state", "sharded_grads"]


def _comm_for(mesh):
    """The :class:`repro_torch.tune.CommSpec` of the TP all-reduce this
    mesh implies, or None off-mesh or when the model axis is trivial.
    Its hops come from :func:`repro_torch.launch.mesh.link_distance` (the
    reference's TPU torus model, so the tuner's mesh keys agree); a
    chip count with no power-of-two torus model falls back to 1.0."""
    if mesh is None:
        return None
    ways = int(dict(mesh.shape).get("model", 1))
    if ways < 2:
        return None
    from repro_torch.tune import CommSpec

    from .mesh import link_distance
    try:
        hops = link_distance(mesh).get("model", 1.0)
    except ValueError:
        hops = 1.0
    return CommSpec(ways=ways, hops=max(hops, 1.0), axis="model")


def _engine_for(engine: DotEngine | None, objective: str | None,
                comm=None) -> DotEngine:
    """The step's GEMM engine: without an objective the explicit engine
    or the Morton default; with one, the tuner-routed engine under that
    metric (an explicit engine is re-stamped with it, as a copy).
    ``comm`` is stamped onto tuner-routed engines only."""
    if objective is None:
        engine = engine or DotEngine()
    else:
        from repro_torch.tune.objective import OBJECTIVES
        if objective not in OBJECTIVES:
            raise ValueError(
                f"unknown objective {objective!r}; choose from {OBJECTIVES}")
        if engine is None:
            engine = DotEngine(schedule="auto", objective=objective)
        elif engine.objective != objective:
            engine = dataclasses.replace(engine, objective=objective)
    if comm is not None and engine.schedule == "auto" \
            and engine.comm != comm:
        engine = dataclasses.replace(engine, comm=comm)
    return engine


def _unflatten(like, leaves):
    """A tree shaped like ``like`` from leaves in sorted-key order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def grads_of(cfg, params, batch, engine: DotEngine):
    """``(loss, {"ce", "aux"}, grads)`` of one batch: the loss and its
    gradient with respect to every parameter leaf, each in the leaf's
    dtype.  A leaf the loss does not read (the encoder's ``embed``) gets
    zeros, as under ``jax.grad``, so the optimizer still decays it.  The
    parameters are differentiated through aliases that require grad, so
    the caller's tensors keep their flags.  Under a mesh context the
    loss is the global one and the gradients are this rank's share."""
    alias = _unflatten(params, [p.detach().requires_grad_(True)
                                for p in tree_leaves(params)])
    leaves = tree_leaves(alias)
    with torch.enable_grad():
        loss, metrics = loss_fn(alias, cfg, batch, engine)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _unflatten(params, grads))


def _split(batch: dict, n: int, i: int) -> dict:
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
            for k, v in batch.items()}


def make_train_step(cfg, mesh, opt_cfg: AdamWConfig, *, grad_accum: int = 1,
                    engine: DotEngine | None = None,
                    pod_compress: bool = False,
                    objective: str | None = None, dp: tuple | None = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``,
    metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` (0-d
    tensors, no host sync).  ``grad_accum`` splits the batch into that
    many microbatches along its first axis: gradients summed in f32 and
    divided by ``grad_accum``, the losses likewise.  The parameters and
    the optimizer state are updated in place.

    ``mesh`` None: one device.  Otherwise the arguments are this rank's
    shards (``param_specs``, ``opt_state_specs``, ``batch_specs``) and
    ``dp`` the axes the batch is split over (default every
    data-parallel axis; ``()`` for a replicated batch).
    ``pod_compress`` applies on a mesh with a "pod" axis, as in the
    reference; ``opt_state["ef"]`` then holds this pod's residual with a
    leading pod dim of 1."""
    engine = _engine_for(engine, objective, _comm_for(mesh))
    if mesh is not None:
        return _sharded_train_step(cfg, mesh, opt_cfg, grad_accum, engine,
                                   pod_compress and "pod" in mesh.axis_names,
                                   dp_axes(mesh) if dp is None else dp)

    def accum_grads(params, batch):
        if grad_accum == 1:
            return grads_of(cfg, params, batch, engine)
        acc, sums = None, {}
        for i in range(grad_accum):
            loss, metrics, g = grads_of(cfg, params,
                                        _split(batch, grad_accum, i), engine)
            g = tree_leaves(g)
            if acc is None:
                acc = [x.to(torch.float32, copy=True) for x in g]
            else:
                for a, x in zip(acc, g):
                    a.add_(x)
            del g
            for k, v in (("loss", loss), *metrics.items()):
                sums[k] = sums[k] + v if k in sums else v
        for a in acc:
            a.div_(grad_accum)
        out = {k: v / grad_accum for k, v in sums.items()}
        return out.pop("loss"), out, _unflatten(params, acc)

    def step(params, opt_state, batch):
        loss, metrics, grads = accum_grads(params, batch)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return step


def _leaf_layout(cfg, mesh, params):
    """Per parameter leaf (``tree_leaves`` order): the ZeRO-1 ``(dim,
    axis)`` slice of its optimizer state (None: not sliced) and every
    mesh axis that slice is split over."""
    zero, splits = [], []
    for spec, p in zip(tree_leaves(shd.param_specs(cfg)),
                       tree_leaves(params)):
        # ZeRO-1 only takes a dim the spec leaves free, whose local size
        # is the global one
        z = shd.zero_slice(spec, shd.zero1_spec(spec, tuple(p.shape), mesh))
        axes = {a for s in spec if s is not None
                for a in ((s,) if isinstance(s, str) else s)}
        if z is not None:
            axes.add(z[1])
        zero.append(z)
        splits.append(tuple(a for a in mesh.axis_names if a in axes))
    return zero, splits


def _slice(g, z, mesh):
    if z is None:
        return g
    dim, axis = z
    return g.chunk(mesh.shape[axis], dim)[mesh.coord[axis]]


def sharded_grads(cfg, mesh, engine: DotEngine, params, batch, *,
                  grad_accum: int = 1, dp: tuple = (), zero=None):
    """The metrics and gradients of one step on this rank's shards:
    ``grad_accum`` microbatches of the local batch, each rank's gradient
    share summed over ``dp`` (the axes the loss normalises over) in f32,
    then sliced by ``zero`` (per leaf, the ZeRO-1 ``(dim, axis)`` or
    None; None: every leaf whole) and averaged over the microbatches.
    Returns ``(metrics, [gradient per leaf in tree_leaves order])``."""
    zero = zero or [None] * len(tree_leaves(params))
    acc, sums = None, {}
    for i in range(grad_accum):
        mb = batch if grad_accum == 1 else _split(batch, grad_accum, i)
        with mesh_context(mesh, dp=dp):
            loss, metrics, g = grads_of(cfg, params, mb, engine)
        leaves, out = tree_leaves(g), []
        del g
        for j, z in enumerate(zero):
            # one leaf at a time: its f32 copy replaces it, and a slice
            # keeps no whole leaf alive
            x = leaves[j].to(torch.float32)
            leaves[j] = None
            if dp:
                mesh.all_reduce(x, dp)
            part = _slice(x, z, mesh)
            out.append(part.clone() if part.numel() < x.numel() else part)
        if acc is None:
            acc = out
        else:
            for a, x in zip(acc, out):
                a.add_(x)
        for k, v in (("loss", loss), *metrics.items()):
            sums[k] = sums[k] + v if k in sums else v
    if grad_accum > 1:
        for a in acc:
            a.div_(grad_accum)
    return {k: v / grad_accum for k, v in sums.items()}, acc


def _sharded_train_step(cfg, mesh, opt_cfg, grad_accum, engine,
                        pod_compress, dp):
    # the loss normalises over the axes a (pod's) batch is split over;
    # each rank's gradient share is summed over the same axes
    loss_dp = tuple(a for a in dp if a != "pod") if pod_compress else dp
    layout = {}

    def step(params, opt_state, batch):
        if not layout:
            layout["zero"], layout["splits"] = _leaf_layout(cfg, mesh,
                                                            params)
        zero, splits = layout["zero"], layout["splits"]
        # under pod compression the slices are taken after the pod mean
        mets, acc = sharded_grads(cfg, mesh, engine, params, batch,
                                  grad_accum=grad_accum, dp=loss_dp,
                                  zero=None if pod_compress else zero)
        if pod_compress:
            acc, mets = _pod_mean(acc, opt_state, mets, mesh, zero)
        params, opt_state, opt_metrics = adamw_update_sharded(
            acc, opt_state, params, opt_cfg, mesh, zero, splits)
        return params, opt_state, {**mets, **opt_metrics}

    return step


def _pod_mean(grads, opt_state, mets, mesh, zero):
    """Each pod's gradients through error feedback to bf16 (its own
    residual, updated in place), then the mean across pods in f32,
    rounded to bf16 once and cast to f32 (``jnp.mean`` of bf16), sliced
    for ZeRO-1; the metrics averaged across pods."""
    pods = mesh.shape["pod"]
    out = []
    for g, e, z in zip(grads, tree_leaves(opt_state["ef"]), zero):
        c, r = ef_compress(g, e[0])
        e[0].copy_(r)
        g = mesh.all_reduce(c.to(torch.float32), "pod") / pods
        out.append(_slice(g.to(torch.bfloat16).to(torch.float32), z, mesh))
    mets = {k: mesh.all_reduce(v.clone(), "pod") / pods
            for k, v in mets.items()}
    return out, mets


def sharded_opt_state(cfg, mesh, params, *, pod_compress: bool = False):
    """This rank's AdamW state for its parameter shards ``params``, as
    ``shard_tree`` of the full state under ``opt_state_specs`` gives it
    (m and v zero, the f32 master its ZeRO-1 slice of the parameters),
    built without the full tree; with ``pod_compress`` a zero residual
    ``ef`` per leaf with a leading pod dim of 1."""
    zero, _ = _leaf_layout(cfg, mesh, params)
    masters = [_slice(p, z, mesh).to(torch.float32, copy=True)
               for p, z in zip(tree_leaves(params), zero)]
    state = {"m": _unflatten(params, [torch.zeros_like(w) for w in masters]),
             "v": _unflatten(params, [torch.zeros_like(w) for w in masters]),
             "master": _unflatten(params, masters),
             "count": torch.zeros((), dtype=torch.int32,
                                  device=masters[0].device)}
    if pod_compress:
        state["ef"] = _tree_map(lambda p: torch.zeros(
            (1,) + tuple(p.shape), dtype=torch.float32, device=p.device),
            params)
    return state


def abstract_train_state(cfg, *, pod_compress: bool = False,
                         pods: int = 1, moe_pad: int = 16):
    """(params, opt_state) as meta tensors (shapes and dtypes only)."""
    p = init_model(cfg, device="meta", moe_pad=moe_pad)
    s = init_opt_state(p)
    if pod_compress:
        s["ef"] = _tree_map(lambda x: torch.empty(
            (pods,) + tuple(x.shape), dtype=torch.float32, device="meta"), p)
    return p, s


def _pod_spec(pspec):
    """The per-pod EF residual's spec: a leading pod dim, then the
    parameter's."""
    if isinstance(pspec, dict):
        return {k: _pod_spec(v) for k, v in pspec.items()}
    return ("pod",) + tuple(pspec)


def build_train_step(cfg, mesh, shape_name: str, *,
                     opt_cfg: AdamWConfig | None = None,
                     grad_accum: int = 1, pod_compress: bool = False,
                     engine: DotEngine | None = None,
                     objective: str | None = None):
    """Returns ``(fn, (param_specs, opt_specs, batch_specs),
    (params_abs, opt_abs, batch_abs))``: the step on this rank's shards
    and the full inputs as meta tensors."""
    with trace_span("steps.build_train_step", shape=shape_name,
                    objective=objective):
        return _build_train_step(
            cfg, mesh, shape_name, opt_cfg=opt_cfg, grad_accum=grad_accum,
            pod_compress=pod_compress, engine=engine, objective=objective)


def _build_train_step(cfg, mesh, shape_name, *, opt_cfg, grad_accum,
                      pod_compress, engine, objective):
    opt_cfg = opt_cfg or AdamWConfig()
    spec = SHAPES[shape_name]
    _publish_link_gauges(cfg, mesh, spec.global_batch * spec.seq_len,
                         "train")
    pspec = shd.param_specs(cfg)
    bspec = shd.batch_specs(cfg, mesh, spec.global_batch)
    dp = _axes_of(next(iter(bspec.values()))[0])
    step = make_train_step(cfg, mesh, opt_cfg, grad_accum=grad_accum,
                           pod_compress=pod_compress, engine=engine,
                           objective=objective, dp=dp)
    pods = mesh.shape.get("pod", 1)
    params_abs, opt_abs = abstract_train_state(
        cfg, pod_compress=pod_compress, pods=pods,
        moe_pad=mesh.shape["model"])
    ospec = shd.opt_state_specs(cfg, params_abs, mesh)
    if pod_compress:
        ospec["ef"] = _pod_spec(pspec)
    return step, (pspec, ospec, bspec), (params_abs, opt_abs,
                                         input_specs(cfg, spec))


# --------------------------------------------------------------- prefill --
def build_prefill_step(cfg, mesh, shape_name: str, *,
                       engine: DotEngine | None = None,
                       objective: str | None = None):
    """Forward-only (prefill) step: batch -> logits, this rank's
    ``(dp rows, all positions, vocab shard)``."""
    with trace_span("steps.build_prefill_step", shape=shape_name,
                    objective=objective):
        return _build_prefill_step(cfg, mesh, shape_name, engine=engine,
                                   objective=objective)


def _build_prefill_step(cfg, mesh, shape_name, *, engine, objective):
    engine = _engine_for(engine, objective, _comm_for(mesh))
    spec = SHAPES[shape_name]
    icfg = dataclasses.replace(cfg, remat=False)  # no grads -> no remat
    dp = shd._dp_if_divisible(dp_axes(mesh), spec.global_batch, mesh)

    @torch.no_grad()
    def step(params, batch):
        with mesh_context(mesh, dp=dp or ()):
            logits, _ = forward(params, icfg, batch, engine)
            return logits

    pspec = shd.param_specs(cfg)
    bspec = {k: v for k, v in
             shd.batch_specs(cfg, mesh, spec.global_batch).items()
             if k not in ("labels", "loss_mask")}
    batch_abs = {k: v for k, v in input_specs(cfg, spec).items()
                 if k not in ("labels", "loss_mask")}
    out_spec = (shd._entry(dp), None, "model")
    params_abs = init_model(cfg, device="meta", moe_pad=mesh.shape["model"])
    return step, (pspec, bspec, out_spec), (params_abs, batch_abs)


# ----------------------------------------------------------------- serve --
def make_serve_step(cfg, mesh, seq_axes, engine: DotEngine | None = None,
                    objective: str | None = None, dp: tuple = ()):
    """``step(params, state, tokens, pos, row_mask=None) -> (logits,
    state)`` on this rank's shards, the state updated in place.

    Contiguous: the batch split over ``dp``, the cache's sequence over
    ``seq_axes`` (sequence-parallel attention).  Paged: the pool sharded
    by kv-head, the block tables replicated, so every rank decodes every
    slot: the tokens (and ``row_mask``) of the ``dp`` ranks are gathered
    first and this rank's rows of the logits kept.  A head-sharded SSD
    state is gathered over the model axis for the step and sliced back.
    Logits: this rank's (batch rows, 1, vocab shard)."""
    engine = _engine_for(engine, objective, _comm_for(mesh))

    @torch.no_grad()
    def step(params, state, tokens, pos, row_mask=None):
        with mesh_context(mesh, seq_axes=seq_axes, dp=dp):
            paged = state.layout.is_paged
            if paged and dp:
                tokens = mesh.all_gather(tokens, dp, 0)
                if row_mask is not None:
                    row_mask = mesh.all_gather(row_mask, dp, 0)
                if torch.is_tensor(pos) and pos.dim() > 0:
                    pos = mesh.all_gather(pos, dp, 0)
            ssm = _gather_ssm(cfg, mesh, state)
            logits, state = model_decode_step(params, cfg, state, tokens,
                                              pos, engine, row_mask=row_mask)
            if ssm is not None:
                _slice_ssm(mesh, state, ssm)
            if paged and dp:
                logits = logits.chunk(mesh.size(dp), 0)[mesh.index(dp)]
            return logits, state

    return step


def _gather_ssm(cfg, mesh, state):
    """A head-sharded ``ssm_h`` gathered whole into the state (the SSD is
    replicated); returns the local tensor to write back into, or None."""
    if not cfg.has_ssm or cfg.ssm_heads % mesh.shape["model"] \
            or mesh.shape["model"] == 1:
        return None
    local = state["ssm_h"]
    state["ssm_h"] = mesh.all_gather(local, "model", 2)
    return local


def _slice_ssm(mesh, state, local):
    m = mesh.shape["model"]
    local.copy_(state["ssm_h"].chunk(m, 2)[mesh.coord["model"]])
    state["ssm_h"] = local


def abstract_decode_state(cfg, batch: int, cache_len: int, *,
                          layout=None, page_size: int = 8):
    """The decode state as meta tensors."""
    return init_decode_state(cfg, batch, cache_len, layout=layout,
                             page_size=page_size, device="meta")


def build_serve_step(cfg, mesh, shape_name: str, *,
                     engine: DotEngine | None = None,
                     cache_len: int | None = None,
                     objective: str | None = None,
                     layout=None, page_size: int = 8):
    """Returns ``(fn, (param_specs, state_specs, tokens_spec,
    logits_spec), (params_abs, state_abs, tokens_abs, pos_abs))`` for
    one decode step of either layout (``layout``: a
    :class:`~repro_torch.serve.state.KVLayout` or its name; None is
    contiguous): the contiguous cache sequence-parallel
    (``decode_state_specs``), the paged pool sharded by kv-head
    (``paged_decode_state_specs``)."""
    with trace_span("steps.build_serve_step", shape=shape_name,
                    objective=objective):
        return _build_serve_step(
            cfg, mesh, shape_name, engine=engine, cache_len=cache_len,
            objective=objective, layout=layout, page_size=page_size)


def _publish_link_gauges(cfg, mesh, b: int, kind: str) -> None:
    """Placement telemetry: the mesh's mean model-axis hop count and the
    modeled bytes-over-links of one step's TP all-reduces (one (b,
    d_model) f32 ring all-reduce per layer), the tuner's CommSpec term,
    as gauges."""
    comm = _comm_for(mesh)
    if comm is None:
        return
    from repro_torch.obs.metrics import default_registry
    from repro_torch.tune import ring_allreduce_link_bytes
    reg = default_registry()
    reg.gauge("distributed.link_hops.model").set(comm.hops)
    per_layer = ring_allreduce_link_bytes(
        b * cfg.d_model * 4.0, comm.ways, comm.hops)
    reg.gauge(f"distributed.link_bytes.{kind}_step").set(
        cfg.n_layers * per_layer)


def _axes_of(s) -> tuple:
    return () if s is None else ((s,) if isinstance(s, str) else tuple(s))


def _build_serve_step(cfg, mesh, shape_name, *, engine, cache_len,
                      objective, layout, page_size):
    layout = resolve_layout(layout)
    spec = SHAPES[shape_name]
    b = spec.global_batch
    _publish_link_gauges(cfg, mesh, b, "decode")
    cache_len = cache_len or (
        min(spec.seq_len, cfg.swa_window)
        if cfg.swa_window is not None else spec.seq_len)
    dp = shd._dp_if_divisible(dp_axes(mesh), b, mesh)
    if layout.is_paged:
        sspec = DecodeState(shd.paged_decode_state_specs(cfg, mesh), layout)
        seq_axes = ()
    else:
        sspec = DecodeState(shd.decode_state_specs(cfg, mesh, b, cache_len),
                            layout)
        # the axes the cache's sequence really is sharded over (a
        # fallback narrows or replicates it)
        seq_axes = _axes_of(sspec["kv_pos"][0]) if cfg.has_attention \
            else ()
    step = make_serve_step(cfg, mesh, seq_axes, engine=engine,
                           objective=objective, dp=dp or ())
    pspec = shd.param_specs(cfg)
    t_spec = (shd._entry(dp), None)
    logits_spec = (shd._entry(dp), None, "model")
    state_abs = abstract_decode_state(cfg, b, cache_len, layout=layout,
                                      page_size=page_size)
    tokens_abs, pos_abs = decode_inputs(cfg, spec)
    params_abs = init_model(cfg, device="meta", moe_pad=mesh.shape["model"])
    return step, (pspec, sspec, t_spec, logits_spec), \
        (params_abs, state_abs, tokens_abs, pos_abs)
