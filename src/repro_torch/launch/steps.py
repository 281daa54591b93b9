"""The train step on one device (port of ``repro.launch.steps``'s
single-device half) and the engine resolution every launcher shares.

``make_train_step`` assembles the loss and its gradients through
autograd (every projection's forward, dgrad and wgrad GEMM through the
engine; ``repro_torch.kernels.grad``), microbatch accumulation in f32,
and :func:`~repro_torch.optim.adamw_update` in place.  The mesh-sharded
``build_train_step``, the cross-pod gradient compression and the
sequence-parallel serve step wait for the distributed slice
(ROADMAP.md queue A, A15).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import DotEngine, loss_fn
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import tree_leaves

__all__ = ["make_train_step", "grads_of"]


def _engine_for(engine: DotEngine | None,
                objective: str | None) -> DotEngine:
    """The step's GEMM engine: without an objective the explicit engine
    or the Morton default; with one, the tuner-routed engine under that
    metric (an explicit engine is re-stamped with it, as a copy)."""
    if objective is None:
        return engine or DotEngine()
    from repro_torch.tune.objective import OBJECTIVES
    if objective not in OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; choose from {OBJECTIVES}")
    if engine is None:
        return DotEngine(schedule="auto", objective=objective)
    if engine.objective != objective:
        return dataclasses.replace(engine, objective=objective)
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
    the caller's tensors keep their flags."""
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
                    objective: str | None = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on one device, metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and
    ``lr`` (0-d tensors, no host sync).  ``grad_accum`` splits the batch
    into that many microbatches along its first axis: gradients summed
    in f32 and divided by ``grad_accum``, the losses likewise.  The
    parameters and the optimizer state are updated in place
    (:func:`~repro_torch.optim.adamw_update`)."""
    if mesh is not None or pod_compress:
        raise NotImplementedError(
            "the mesh-sharded train step and pod compression are not "
            "ported yet (ROADMAP.md queue A, A15)")
    engine = _engine_for(engine, objective)

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
