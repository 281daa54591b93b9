"""Common model layers (port of ``repro.models.layers``): plain
functions on tensors, parameters in nested dicts.

All GEMMs route through :class:`DotEngine`, the point where the paper's
technique enters the model: a curve schedule runs every projection
through the hand-written SFC GEMM kernel.
"""
from __future__ import annotations

import dataclasses
import math
import torch

__all__ = ["DotEngine", "rms_norm", "layer_norm", "rope", "apply_rope",
           "swiglu_mlp", "init_linear", "init_rms", "init_swiglu"]


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
    (``repro_torch.tune.resolved_f_scale``)."""
    schedule: str = "morton"
    block: tuple = (128, 128, 128)
    use_prefetch: bool = True
    objective: str = "time"

    def dot(self, x, w, *, bias=None, activation: str = "none",
            residual=None, out_dtype=None):
        """x: (..., d_in) @ w: (d_in, d_out) -> (..., d_out), with the
        fused epilogue ``act(x @ w + bias) + residual`` and one cast to
        ``out_dtype``.  Every schedule, "xla" included, goes through
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
                              self.objective))
        else:
            out = sfc_matmul(x2, w, schedule=self.schedule, bm=bm, bn=bn,
                             bk=bk, use_prefetch=self.use_prefetch,
                             out_dtype=out_dtype, objective=self.objective,
                             bias=bias, activation=activation,
                             residual=res2)
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
                dtype=torch.float32, *, lead=(), device=None):
    kw = dict(lead=lead, device=device)
    return {
        "w1": init_linear(generator, d, d_ff, dtype, **kw),
        "w3": init_linear(generator, d, d_ff, dtype, **kw),
        "w2": init_linear(generator, d_ff, d, dtype, **kw),
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


def rope(positions, d_head: int, theta: float = 10000.0):
    """Rotary tables: positions (...,) -> cos/sin (..., d_head/2), f32."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


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
    fused epilogue and ``residual`` the down-projection's."""
    g = engine.dot(x, params["w1"], activation="silu")
    u = engine.dot(x, params["w3"])
    return engine.dot(g * u, params["w2"], residual=residual)
