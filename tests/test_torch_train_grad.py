"""The gradient of the fused SFC GEMM (``repro_torch.kernels.grad``) on
the CPU, where the kernel wrapper runs its plain version:

* for every epilogue activation, with and without bias and residual, in
  f32: the Function's dx, dw, dbias and dres equal torch autograd
  through ``kernels/ref.py::matmul_fused_ref`` within 1e-5 + 1e-5|ref|
  (f32 summation order only: the plain version sums bk-deep blocks);
* the vocab head's mixed case (bf16 operands, f32 output): dx and dw
  equal the reference's ``jax.vjp`` of its bf16 dot with f32 output at
  the same cast points (f32 product, one cast to bf16) within one bf16
  rounding step (2**-7 |ref| + 1e-6);
* remat none, "full" and "dots" give bit-equal loss and gradients, with
  22 L + 3 GEMMs a step (29 L + 3 under "full");
* parameters that do not require grad record no graph and add no GEMM;
  on a non-CPU tensor the Function goes through the kernel wrapper,
  which raises; the module catches nothing.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models.layers import DotEngine as RefDotEngine
from repro_torch.configs import get_smoke_config
from repro_torch.data import PackedSyntheticData
from repro_torch.data.pipeline import batch_to_device
from repro_torch.kernels import grad as grad_mod
from repro_torch.kernels import ops
from repro_torch.kernels.grad import GemmOpts, sfc_matmul_grad
from repro_torch.kernels.ref import ACTIVATIONS, activation_grad, \
    apply_activation, matmul_fused_ref
from repro_torch.launch.steps import grads_of
from repro_torch.models import DotEngine, init_model
from repro_torch.models.config import ShapeSpec
from repro_torch.optim.adamw import tree_leaves

F32_TOL = dict(atol=1e-5, rtol=1e-5)
OPTS = GemmOpts(schedule="hilbert", bm=16, bn=16, bk=16)


@pytest.fixture
def count_gemms(monkeypatch):
    """Counts calls of the kernel wrapper (the CPU runs its plain
    version, which the launch counter does not count)."""
    calls = [0]
    inner = ops.sfc_matmul_cuda

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    monkeypatch.setattr(ops, "sfc_matmul_cuda", counted)
    return calls


def _inputs(seed, m=37, k=50, n=29, bias=False, residual=False):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    x, w = t(m, k), t(k, n) / np.sqrt(k)
    return (x, w, t(n) if bias else None, t(m, n) if residual else None,
            t(m, n))


@pytest.mark.parametrize("residual", [False, True], ids=["", "res"])
@pytest.mark.parametrize("bias", [False, True], ids=["", "bias"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_function_backward_matches_autograd_of_ref(activation, bias,
                                                   residual):
    x, w, b, r, dy = _inputs(7, bias=bias, residual=residual)
    leaves = [t for t in (x, w, b, r) if t is not None]

    def run(fn):
        ins = [t.clone().requires_grad_(True) for t in leaves]
        it = iter(ins)
        xx, ww = next(it), next(it)
        bb = next(it) if bias else None
        rr = next(it) if residual else None
        out = fn(xx, ww, bb, rr)
        out.backward(dy)
        return out.detach(), [t.grad for t in ins]

    got, g_got = run(lambda xx, ww, bb, rr: sfc_matmul_grad(
        xx, ww, bias=bb, activation=activation, residual=rr, opts=OPTS))
    want, g_want = run(lambda xx, ww, bb, rr: matmul_fused_ref(
        xx, ww, bias=bb, activation=activation, residual=rr))
    torch.testing.assert_close(got, want, **F32_TOL)
    assert len(g_got) == len(g_want) == len(leaves)
    for a, b_ in zip(g_got, g_want):
        torch.testing.assert_close(a, b_, **F32_TOL)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_activation_grad_matches_autograd(activation):
    z = torch.linspace(-4, 4, 801, dtype=torch.float32).requires_grad_(True)
    apply_activation(z, activation).sum().backward()
    torch.testing.assert_close(activation_grad(z.detach(), activation),
                               z.grad, atol=1e-6, rtol=1e-6)


def test_vocab_head_mixed_dtypes_match_reference_vjp():
    """bf16 x and lm_head, f32 logits: the reference's gradient is
    dot_general(f32 cotangent, bf16 operand, preferred f32) then a cast
    to bf16; the Function upcasts the bf16 operand (exact) and runs the
    f32 GEMM, never rounding dLogits to bf16."""
    rng = np.random.default_rng(11)
    m, k, n = 24, 64, 96
    x32 = rng.standard_normal((m, k)).astype(np.float32)
    w32 = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    xj = jnp.asarray(x32, jnp.bfloat16)
    wj = jnp.asarray(w32, jnp.bfloat16)
    ref_eng = RefDotEngine(schedule="morton")
    out_j, vjp = jax.vjp(
        lambda a, b: ref_eng.dot(a, b, out_dtype=jnp.float32), xj, wj)
    dx_j, dw_j = vjp(jnp.asarray(dy))
    assert out_j.dtype == jnp.float32 and dx_j.dtype == jnp.bfloat16

    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(True)
    w = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(True)
    out = DotEngine(block=(16, 16, 16)).dot(x, w, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out.detach(), torch.from_numpy(
        np.array(out_j)), atol=1e-5, rtol=1e-5)
    out.backward(torch.from_numpy(dy))
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    for got, want in ((x.grad, dx_j), (w.grad, dw_j)):
        want = torch.from_numpy(np.array(want.astype(jnp.float32)))
        torch.testing.assert_close(got.float(), want, atol=1e-6,
                                   rtol=2.0 ** -7)
        # one cast of an f32 sum: the two agree bit for bit but where the
        # sums straddle a rounding boundary (a dLogits rounded to bf16
        # first would part them in about half the elements)
        assert float((got.float() == want).float().mean()) >= 0.95


def test_remat_policies_give_bit_equal_gradients(count_gemms):
    cfg = get_smoke_config("qwen3_1_7b")
    assert cfg.remat and cfg.remat_policy == "dots"
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = batch_to_device(PackedSyntheticData(
        cfg, ShapeSpec("t", 32, 4, "train"), seed=0).batch(0), "cpu")
    n_l = cfg.n_layers
    runs = {}
    for name, c, want in (
            ("none", dataclasses.replace(cfg, remat=False), 22 * n_l + 3),
            ("dots", cfg, 22 * n_l + 3),
            ("full", dataclasses.replace(cfg, remat_policy="full"),
             29 * n_l + 3)):
        count_gemms[0] = 0
        loss, _, g = grads_of(c, params, batch, DotEngine())
        assert count_gemms[0] == want, name
        runs[name] = (loss, tree_leaves(g))
    for name in ("dots", "full"):
        assert torch.equal(runs[name][0], runs["none"][0])
        for a, b in zip(runs[name][1], runs["none"][1]):
            assert torch.equal(a, b), name


def test_unknown_remat_policy_raises():
    cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                              remat_policy="nope")
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros(2, 16, dtype=torch.int32),
             "labels": torch.zeros(2, 16, dtype=torch.int32)}
    with pytest.raises(ValueError, match="remat_policy"):
        grads_of(cfg, params, batch, DotEngine())


def test_no_grad_parameters_record_no_graph_and_add_no_gemm(count_gemms):
    x, w, _, r, _ = _inputs(3, residual=True)
    eng = DotEngine()
    out = eng.dot(x, w, activation="silu", residual=r)
    assert out.grad_fn is None and not out.requires_grad
    assert count_gemms[0] == 1
    wg = w.clone().requires_grad_(True)
    with torch.no_grad():
        out = eng.dot(x, wg, activation="silu", residual=r)
    assert out.grad_fn is None and count_gemms[0] == 2
    out = eng.dot(x, wg, activation="silu", residual=r)
    assert out.grad_fn is not None and count_gemms[0] == 3
    # only the weight needs a gradient: the recompute and the wgrad run,
    # no dgrad
    out.sum().backward()
    assert count_gemms[0] == 5 and wg.grad is not None


def test_function_goes_through_the_kernel_wrapper_off_the_cpu():
    x = torch.zeros(4, 8, device="meta", requires_grad=True)
    w = torch.zeros(8, 4, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="runs on cuda"):
        sfc_matmul_grad(x, w)
    with pytest.raises(ValueError, match="runs on cuda"):
        DotEngine().dot(x, w)


def test_grad_module_catches_nothing():
    tree = ast.parse(Path(grad_mod.__file__).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_dot_batched_refuses_to_record_a_graph():
    a = torch.zeros(2, 4, 8, requires_grad=True)
    b = torch.zeros(2, 8, 4)
    with pytest.raises(NotImplementedError, match="no backward"):
        DotEngine().dot_batched(a, b)
    with torch.no_grad():
        assert DotEngine().dot_batched(a, b).shape == (2, 4, 4)


def test_transposed_copies_are_counted():
    x, w, _, _, dy = _inputs(5)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = grad_mod.transpose_bytes
    sfc_matmul_grad(xg, wg, opts=OPTS).backward(dy)
    assert grad_mod.transpose_bytes - before == (x.numel() + w.numel()) * 4
