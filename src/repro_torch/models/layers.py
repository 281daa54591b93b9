"""Common model layers (port of ``repro.models.layers``): plain
functions on tensors, parameters in nested dicts.

All GEMMs route through :class:`DotEngine`, the point where the paper's
technique enters the model: a curve schedule runs every projection
through the hand-written SFC GEMM kernel.

Tensor parallelism.  Under an active mesh context
(:func:`repro_torch.distributed.ctx.mesh_context`) each rank holds its
column shards (``wq``, ``wk``, ``wv``, ``w1``, ``w3``, ``lm_head``: N/m
columns) and row shards (``wo``, ``w2``: K/m rows) and runs them through
the unchanged :meth:`DotEngine.dot`, so B1 runs every shard.  The
collectives are two autograd ``Function`` pairs: :func:`copy_to`
(identity forward, all-reduce backward) where a replicated activation
enters column-parallel work, and :func:`reduce_sum` (all-reduce forward,
identity backward) after a row-parallel GEMM (:func:`out_proj`: the
partial products summed in f32, the residual added once, after the
all-reduce).  :func:`scatter` and
:func:`gather` (a slice one way, an all-gather the other) carry the moe
layer's token split and expert outputs.  Every rank then computes the
same replicated activations and the same full gradient of each
replicated parameter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["DotEngine", "rms_norm", "layer_norm", "rope", "yarn_inv_freq",
           "apply_rope",
           "swiglu_mlp", "init_linear", "init_rms", "init_swiglu",
           "copy_to", "reduce_sum", "scatter", "gather", "out_proj",
           "tp_context"]


@dataclasses.dataclass(frozen=True)
class DotEngine:
    """GEMM dispatcher.

    schedule: an SFC schedule name run by the CUDA kernel ("morton",
    "hilbert", "rowmajor", ...; the default is "morton", the serving
    path), "xla" for the library baseline (``ops.library_matmul``), or
    "auto": each GEMM's (schedule, blocks, prefetch) resolved per shape
    bucket through ``repro_torch.tune`` (the winner may be "xla").  ``block``
    is (bm, bn, bk).

    objective: the tuner's metric under "auto": "time" (default),
    "energy" or "edp".  Ignored for explicit schedules.  An "energy" or
    "edp" winner also carries a DVFS point that never changes the
    launch; the serving loop reads it back for its energy accounting
    (``repro_torch.tune.resolved_f_scale``).

    comm: the :class:`repro_torch.tune.CommSpec` of the collective each
    GEMM's output feeds on a mesh (``launch.steps._comm_for``).  Only
    read under "auto", where it keys the tuner's mesh keyspace; None
    (default) keeps every single-device cache key as it is."""
    schedule: str = "morton"
    block: tuple = (128, 128, 128)
    use_prefetch: bool = True
    objective: str = "time"
    comm: Any = None

    def dot(self, x, w, *, bias=None, activation: str = "none",
            residual=None, out_dtype=None, grad_dtype=None):
        """x: (..., d_in) @ w: (d_in, d_out) -> (..., d_out), with the
        fused epilogue ``act(x @ w + bias) + residual`` and one cast to
        ``out_dtype``.  ``grad_dtype``: the dtype the backward's GEMMs
        take the cotangent in (None: the output's).  Every schedule, "xla" included, goes through
        :func:`repro_torch.kernels.ops.sfc_matmul`; when grad is enabled
        and an operand requires it, through its autograd ``Function``
        (:func:`repro_torch.kernels.grad.sfc_matmul_grad`), whose
        backward runs the dgrad and wgrad GEMMs the same way."""
        from repro_torch.kernels.grad import GemmOpts, needs_grad, \
            sfc_matmul_grad
        from repro_torch.kernels.ops import sfc_matmul

        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        res2 = residual.reshape(-1, w.shape[-1]) \
            if residual is not None else None
        bm, bn, bk = self.block
        if needs_grad(x, w, bias, residual):
            out = sfc_matmul_grad(
                x2, w, bias=bias, activation=activation, residual=res2,
                out_dtype=out_dtype,
                opts=GemmOpts(self.schedule, bm, bn, bk, self.use_prefetch,
                              self.objective, self.comm),
                grad_dtype=grad_dtype)
        else:
            out = sfc_matmul(x2, w, schedule=self.schedule, bm=bm, bn=bn,
                             bk=bk, use_prefetch=self.use_prefetch,
                             out_dtype=out_dtype, objective=self.objective,
                             bias=bias, activation=activation,
                             residual=res2, comm=self.comm)
        return out.reshape(*lead, w.shape[-1])

    def dot_batched(self, x, w, *, bias=None, activation: str = "none",
                    residual=None, out_dtype=None):
        """Per-batch-element GEMM: x (..., M, K) @ w (..., K, N), through
        :func:`repro_torch.kernels.ops.sfc_matmul_batched` under the same
        schedule and the same fused epilogue as :meth:`dot` ("xla"
        included).  It has no backward yet: an operand that requires
        grad under grad mode raises."""
        from repro_torch.kernels.grad import needs_grad
        from repro_torch.kernels.ops import sfc_matmul_batched

        if needs_grad(x, w, bias, residual):
            raise NotImplementedError(
                "dot_batched has no backward; no ported training path "
                "runs a batched GEMM")

        bm, bn, bk = self.block
        return sfc_matmul_batched(
            x, w, schedule=self.schedule, bm=bm, bn=bn, bk=bk,
            use_prefetch=self.use_prefetch, out_dtype=out_dtype,
            objective=self.objective, bias=bias,
            activation=activation, residual=residual)


def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                dtype=torch.float32, scale=None, *, lead=(), device=None):
    """normal / sqrt(d_in) weights of shape (*lead, d_in, d_out), drawn
    one (d_in, d_out) slice of the leading axes at a time in f32 and
    cast into the stack: the f32 temporary is one layer's matrix, never
    the whole stack (deepseek-coder-33b's MLP stack is 17 GB in bf16)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    out = torch.empty((*lead, d_in, d_out), dtype=dtype, device=device)
    for w in out.view(-1, d_in, d_out):
        w.copy_(torch.randn((d_in, d_out), generator=generator,
                            dtype=torch.float32, device=device) * scale)
    return out


def init_rms(d: int, dtype=torch.float32, *, lead=(), device=None):
    return torch.ones((*lead, d), dtype=dtype, device=device)


def init_swiglu(generator: torch.Generator, d: int, d_ff: int,
                dtype=torch.float32, *, lead=(), device=None, place=None):
    """``place(name, leaf)``, when given, takes each leaf as soon as it
    is drawn and the dict holds what it returns."""
    kw = dict(lead=lead, device=device)
    put = place or (lambda _, t: t)
    return {
        "w1": put("w1", init_linear(generator, d, d_ff, dtype, **kw)),
        "w3": put("w3", init_linear(generator, d, d_ff, dtype, **kw)),
        "w2": put("w2", init_linear(generator, d_ff, d, dtype, **kw)),
    }


def rms_norm(x, gamma, eps: float = 1e-6):
    """Normalise in f32, cast back to x's dtype, then scale by gamma in
    that dtype (the reference's order; a reorder is a bf16 mismatch)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * gamma


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """Normalise by the mean and the (biased) variance in f32, cast back
    to x's dtype, then ``* gamma + beta`` in that dtype (the reference's
    order, as :func:`rms_norm`)."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dt) * gamma + beta


def yarn_inv_freq(d_head: int, theta: float, yarn, device=None):
    """The (d_head/2,) f32 frequencies of YaRN scaling
    (:class:`repro_torch.models.config.YarnRope` writes the formula)."""
    half = d_head // 2

    def find(b):
        return d_head * math.log(
            yarn.original_max_position_embeddings / (b * 2 * math.pi)) \
            / (2 * math.log(theta))

    low = max(math.floor(find(yarn.beta_fast)), 0)
    high = min(math.ceil(find(yarn.beta_slow)), d_head - 1)
    if high == low:
        high += 0.001
    i = torch.arange(half, dtype=torch.float32, device=device)
    ramp = torch.clamp((i - low) / (high - low), 0, 1)
    base = theta ** (-i / half)
    return (1 - ramp) * base + ramp * base / yarn.factor


def rope(positions, d_head: int, theta: float = 10000.0, yarn=None):
    """Rotary tables: positions (...,) -> cos/sin (..., d_head/2), f32;
    with ``yarn`` (a :class:`~repro_torch.models.config.YarnRope`) its
    frequencies, and both tables times its ``attention_factor``."""
    half = d_head // 2
    if yarn is None:
        freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half)
    else:
        freqs = yarn_inv_freq(d_head, theta, yarn, positions.device)
    ang = positions[..., None].float() * freqs
    if yarn is None:
        return torch.cos(ang), torch.sin(ang)
    return (torch.cos(ang) * yarn.attention_factor,
            torch.sin(ang) * yarn.attention_factor)


def apply_rope(x, cos, sin):
    """x: (B, S, H, dh); cos/sin: (B, S, dh/2) or (S, dh/2).  The
    rotation runs in f32 (bf16 x f32 promotes) and is cast back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half)
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:  # (B, S, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


def swiglu_mlp(x, params, engine: DotEngine, residual=None):
    """SwiGLU: w2(silu(w1 x) * w3 x); the silu rides the up-projection's
    fused epilogue and ``residual`` the down-projection's (on a mesh:
    w1/w3 column-parallel, w2 row-parallel, :func:`out_proj`)."""
    x = copy_to(x)
    g = engine.dot(x, params["w1"], activation="silu")
    u = engine.dot(x, params["w3"])
    return out_proj(engine, g * u, params["w2"], residual)


# ------------------------------------------------- tensor parallelism --
def tp_context():
    """The active mesh context, or None on one device."""
    from repro_torch.distributed import ctx as dctx
    return dctx.current()


def _model(c, axes):
    return (c.model_axis,) if axes is None else axes


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axes), None, None


class _ReduceSum(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Scatter(torch.autograd.Function):
    """This rank's chunk along ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return x.chunk(mesh.size(axes), dim)[mesh.index(axes)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axes, ctx.dim), None, None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward, this rank's chunk backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return (g.chunk(m.size(ctx.axes), ctx.dim)[m.index(ctx.axes)]
                .contiguous(), None, None, None)


def _grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(x, axes=None):
    """A replicated tensor entering work sharded over ``axes`` (default
    the model axis): identity, whose backward sums the ranks' partial
    gradients.  Identity off a mesh."""
    c = tp_context()
    if c is None or not _grad(x):
        return x
    return _CopyTo.apply(x, c.mesh, _model(c, axes))


def reduce_sum(x, axes=None):
    """The sum of every rank's ``x`` over ``axes`` (default the model
    axis), the gradient passed through unchanged.  Without grad the
    all-reduce runs in place on ``x``, which must be a temporary."""
    c = tp_context()
    if c is None:
        return x
    axes = _model(c, axes)
    if _grad(x):
        return _ReduceSum.apply(x, c.mesh, axes)
    return c.mesh.all_reduce(x, axes)


def scatter(x, dim: int, axes=None):
    """This rank's chunk of a replicated tensor along ``dim``."""
    c = tp_context()
    if c is None:
        return x
    axes = _model(c, axes)
    if _grad(x):
        return _Scatter.apply(x, c.mesh, axes, dim)
    return x.chunk(c.mesh.size(axes), dim)[c.mesh.index(axes)].contiguous()


def gather(x, dim: int, axes=None):
    """Every rank's chunk concatenated along ``dim`` (mesh order)."""
    c = tp_context()
    if c is None:
        return x
    axes = _model(c, axes)
    if _grad(x):
        return _Gather.apply(x, c.mesh, axes, dim)
    return c.mesh.all_gather(x, axes, dim)


def out_proj(engine: DotEngine, x, w, residual=None):
    """A row-parallel GEMM ``x @ w + residual``: one device fuses the
    residual into the GEMM's epilogue; on a mesh each rank's partial
    product (f32 out) is summed over the model axis in f32 and the
    residual is added once, after the all-reduce, with one rounding to
    the activation dtype: on one rank the fused epilogue's arithmetic,
    forward and backward."""
    if tp_context() is None:
        return engine.dot(x, w, residual=residual)
    # the backward's dgrad and wgrad take the cotangent in x's dtype, as
    # the fused GEMM's (whose output is in that dtype) do
    part = engine.dot(x, w, out_dtype=torch.float32, grad_dtype=x.dtype)
    y = reduce_sum(part)
    dtype = x.dtype if residual is None else residual.dtype
    return (y if residual is None else y + residual.float()).to(dtype)
