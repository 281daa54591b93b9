"""The gradient of the fused SFC GEMM (B1): a ``torch.autograd.Function``
around :func:`repro_torch.kernels.ops.sfc_matmul`, whose backward runs
its two GEMMs through the same entry, so a curve schedule launches B1
for them too.  ``DotEngine.dot`` takes it when grad is enabled and an
operand requires grad; without one (serving) it is never entered.

For ``y = cast(act(z) + residual)``, ``z = x @ w + bias`` (f32
accumulator), with cotangent ``dy``:

* ``dres = dy`` (cast to the residual's dtype);
* ``dz = dy * act'(z)`` in f32 (:func:`~repro_torch.kernels.ref.
  activation_grad`); ``z`` is not kept from the forward but recomputed
  by one more GEMM with ``activation="none"`` and an f32 output, which
  repeats the forward's accumulation bit for bit;
* ``dbias = sum_rows(dz)`` in f32, cast to the bias's dtype;
* ``dx = dz @ w^T`` and ``dw = x^T @ dz`` through ``ops.sfc_matmul``
  with the forward's schedule, blocks and objective (under
  ``"auto"`` each resolves by its own shape), f32 accumulation, each
  written in its operand's dtype.

The backward GEMMs run in the wider of the operands' and ``dy``'s
dtypes; ``grad_dtype`` casts ``dy`` first (a row-parallel shard's f32
partial product takes its cotangent in the activation dtype, as the
one-device GEMM whose output it replaces does).  So the vocab head (bf16 operands, f32 logits) keeps dLogits
in f32 and multiplies it by the bf16 operand upcast to f32, exactly, as
the reference's XLA gradient does (``dot_general(f32, bf16,
preferred=f32)`` then a cast to bf16); a bf16 projection rounds ``dz``
to bf16 before its GEMMs, which for ``act != "none"`` is a rounding
point the reference (f32 ``dz``) does not have.  The GEMMs take only
contiguous operands, so ``w^T`` and ``x^T`` are copies;
:data:`transpose_bytes` counts their bytes.

On a CUDA tensor a curve schedule launches B1 or raises: there is no
library fallback.  ``"xla"`` runs ``ops.library_matmul`` in both
passes (torch has no derivative for the bf16-in, f32-out
``aten::mm.dtype``).  On the CPU the same formulas run on the plain
versions.

Each GEMM runs inside a profiler range, ``sfc_matmul.fwd``, ``.recompute``,
``.dgrad`` or ``.wgrad``, so a trace splits the kernel's time by role.

Remat policy ``"dots"`` (:class:`DotCache`): inside a checkpointed
region the forward keeps each output of this function and the
recomputation takes them back in order, launching nothing; everything
else in the region is recomputed."""
from __future__ import annotations

import contextvars
import dataclasses

import torch
from torch.profiler import record_function

from . import ops
from .ref import activation_grad

__all__ = ["sfc_matmul_grad", "needs_grad", "DotCache", "GemmOpts",
           "transpose_bytes"]

# bytes of the transposed operand copies the backward has made (every
# device; host arithmetic, never a device read)
transpose_bytes = 0

_DOTS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_dot_cache", default=None)


@dataclasses.dataclass(frozen=True)
class GemmOpts:
    """The GEMM settings the forward ran with; the backward's GEMMs reuse
    them."""
    schedule: str = "morton"
    bm: int = 128
    bn: int = 128
    bk: int = 128
    use_prefetch: bool = True
    objective: str = "time"
    comm: object = None

    def kwargs(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


class DotCache:
    """Outputs of :func:`sfc_matmul_grad` in one checkpointed region, for
    remat policy ``"dots"``.  :meth:`contexts` is a checkpoint
    ``context_fn``: under the first context the region's forward keeps
    each output; under the second the recomputation takes them back in
    the same order instead of computing them again."""

    def __init__(self):
        self.outs: list[torch.Tensor] = []
        self.replaying = False
        self._next = 0

    def contexts(self):
        return _Scope(self, replay=False), _Scope(self, replay=True)

    def keep(self, out: torch.Tensor) -> None:
        self.outs.append(out.detach())

    def take(self) -> torch.Tensor:
        out = self.outs[self._next]
        self._next += 1
        return out.detach()


class _Scope:
    def __init__(self, cache: DotCache, replay: bool):
        self.cache = cache
        self.replay = replay
        self._token = None

    def __enter__(self) -> DotCache:
        self.cache.replaying = self.replay
        self.cache._next = 0
        self._token = _DOTS.set(self.cache)
        return self.cache

    def __exit__(self, *exc) -> bool:
        _DOTS.reset(self._token)
        return False


def _transposed(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a^T`` as a contiguous copy in ``dtype`` (one pass)."""
    global transpose_bytes
    out = torch.empty(a.shape[1], a.shape[0], dtype=dtype, device=a.device)
    out.copy_(a.t())
    transpose_bytes += out.numel() * out.element_size()
    return out


class _SfcMatmulFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, residual, activation, out_dtype,
                opts: GemmOpts, grad_dtype):
        cache = _DOTS.get()
        if cache is not None and cache.replaying:
            out = cache.take()
        else:
            with record_function("sfc_matmul.fwd"):
                out = ops.sfc_matmul(x, w, bias=bias, activation=activation,
                                     residual=residual, out_dtype=out_dtype,
                                     **opts.kwargs())
            if cache is not None:
                cache.keep(out)
        ctx.save_for_backward(x, w, bias)
        ctx.activation = activation
        ctx.opts = opts
        ctx.grad_dtype = grad_dtype
        ctx.res_dtype = residual.dtype if residual is not None else None
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, bias = ctx.saved_tensors
        kw = ctx.opts.kwargs()
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        if ctx.grad_dtype is not None:
            dy = dy.to(ctx.grad_dtype)
        gd = torch.promote_types(x.dtype, dy.dtype)
        if ctx.activation == "none":
            dz32 = dy.float() if need_b else None
            dz = dy.to(gd)
        else:
            with record_function("sfc_matmul.recompute"):
                z = ops.sfc_matmul(x, w, bias=bias, out_dtype=torch.float32,
                                   **kw)
            dz32 = dy.float() * activation_grad(z, ctx.activation)
            del z
            dz = dz32.to(gd)
        dz = dz.contiguous()
        dbias = dz32.sum(0).to(bias.dtype) if need_b else None
        del dz32
        dres = dy.to(ctx.res_dtype) if need_r else None
        dx = dw = None
        if need_x:
            wt = _transposed(w, gd)
            with record_function("sfc_matmul.dgrad"):
                dx = ops.sfc_matmul(dz, wt, out_dtype=x.dtype, **kw)
            del wt
        if need_w:
            xt = _transposed(x, gd)
            with record_function("sfc_matmul.wgrad"):
                dw = ops.sfc_matmul(xt, dz, out_dtype=w.dtype, **kw)
        return dx, dw, dbias, dres, None, None, None, None


def needs_grad(*tensors) -> bool:
    """Whether a GEMM on these operands must record a graph: grad mode
    on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def sfc_matmul_grad(x: torch.Tensor, w: torch.Tensor, *, bias=None,
                    activation: str = "none", residual=None,
                    out_dtype=None, opts: GemmOpts = GemmOpts(),
                    grad_dtype=None) -> torch.Tensor:
    """``ops.sfc_matmul(x, w, ...)`` (x (M, K), w (K, N)) with the
    gradient above: the same output, recorded for autograd.
    ``grad_dtype``: the dtype the cotangent is cast to before the
    backward's GEMMs (None: as it arrives)."""
    return _SfcMatmulFn.apply(x, w, bias, residual, activation,
                              out_dtype or x.dtype, opts, grad_dtype)
