"""Port parity of the Mamba2 SSD mixer (``repro_torch.models.ssm``)
against ``repro.models.ssm`` on the CPU, at the mamba2 and hymba SMOKE
widths (4 heads of 16, state 16 or 8), with the reference's parameters
(``init_ssm`` through numpy) and numpy-seeded inputs, f32.

Tolerances (measured, outputs of magnitude up to ~4):

* ``ssd_forward`` at one chunk and at several: within 1e-4 absolute
  (measured up to 6.8e-5; most cases under 2e-5).  Both round the
  intra-chunk buffer and x * dt to bf16 at the same points and
  accumulate in f32; the port runs the inter-chunk recurrence as a loop
  where the reference scans, and its cumsum and einsums sum in another
  order, so an element of the buffer may land one bf16 rounding step
  (2**-8 relative) from the reference's, which moves the P outputs of
  its row by up to 2**-8 of that term;
* ``ssm_decode`` output within 2e-6 and its state within 1e-6, with and
  without a row mask (masked rows keep their state exactly);
* token-by-token decode against ``ssd_forward`` of the same sequence:
  within 5e-3 (the chunked form's bf16 buffer; the reference's own gap
  is the same, measured 6.2e-4 and 2.7e-3);
* at a 128-token chunk (mamba2's full-size chunk) the reference's
  gradient is not finite (ROADMAP.md queue C): its intra-chunk decay
  evaluates exp over the masked upper triangle, which overflows to inf,
  and the mask's gradient multiplies it by 0.  The port evaluates only
  the lower triangle: the same forward, a finite gradient.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.models import DotEngine as JaxEngine
from repro.models import init_model as jax_init_model
from repro.models import ssm as ref_ssm
from repro.models.transformer import loss_fn as ref_loss_fn
from repro_torch.configs import get_smoke_config
from repro_torch.launch.steps import grads_of
from repro_torch.models import DotEngine
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import tree_leaves

ARCHS = ["mamba2_780m", "hymba_1_5b"]


def _params(arch):
    jp = ref_ssm.init_ssm(jax.random.PRNGKey(1), jax_smoke(arch))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _state(cfg, b, seed=None):
    shp = ssm.ssm_state_shape(cfg, b)
    if seed is None:
        return {k: np.zeros(v, np.float32) for k, v in shp.items()}
    return {k: 0.5 * _x(v, seed + i) for i, (k, v) in enumerate(shp.items())}


@pytest.mark.parametrize("arch", ARCHS)
def test_dims_and_state_shape_equal_reference(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    assert ssm._dims(cfg) == ref_ssm._dims(jcfg)
    assert ssm.ssm_state_shape(cfg, 3) == ref_ssm.ssm_state_shape(jcfg, 3)
    jp, _ = _params(arch)
    p = ssm.init_ssm(torch.Generator().manual_seed(0), cfg, lead=(2,),
                     device="cpu")
    for k, v in jp.items():
        assert tuple(p[k].shape) == (2, *v.shape), k
        assert str(p[k].dtype)[6:] == str(v.dtype), k
    assert abs(float(p["conv_w"].std()) / 0.1 - 1) < 0.2


@pytest.mark.parametrize("seq,chunk", [(16, 16), (64, 16), (48, 16),
                                       (128, 128)],
                         ids=["1-chunk", "4-chunks", "3-chunks",
                              "1-chunk-128"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_forward_matches_reference(arch, seq, chunk):
    jp, tp = _params(arch)
    x = _x((2, seq, 64), seed=seq)
    y = ssm.ssd_forward(torch.from_numpy(x), tp, get_smoke_config(arch),
                        DotEngine(), chunk=chunk)
    jy = ref_ssm.ssd_forward(jnp.asarray(x), jp, jax_smoke(arch),
                             JaxEngine(), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4, rtol=0)


def test_ssd_forward_rejects_a_ragged_sequence():
    _, tp = _params("mamba2_780m")
    with pytest.raises(ValueError, match="multiple of ssd_chunk"):
        ssm.ssd_forward(torch.zeros(1, 24, 64), tp,
                        get_smoke_config("mamba2_780m"), DotEngine(),
                        chunk=16)


@pytest.mark.parametrize("masked", [False, True], ids=["", "row_mask"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_matches_reference(arch, masked):
    jp, tp = _params(arch)
    cfg = get_smoke_config(arch)
    x = _x((3, 1, 64), seed=11)
    st = _state(cfg, 3, seed=12)
    mask = np.array([True, False, True]) if masked else None
    out, new = ssm.ssm_decode(
        torch.from_numpy(x), tp, cfg, DotEngine(),
        {k: torch.from_numpy(v) for k, v in st.items()},
        row_mask=torch.from_numpy(mask) if masked else None)
    jout, jnew = ref_ssm.ssm_decode(
        jnp.asarray(x), jp, jax_smoke(arch), JaxEngine(),
        {k: jnp.asarray(v) for k, v in st.items()},
        row_mask=jnp.asarray(mask) if masked else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-6,
                               rtol=0)
    for k in ("h", "conv"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                   atol=1e-6, rtol=0)
        if masked:
            np.testing.assert_array_equal(new[k][1].numpy(), st[k][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_tokenwise_decode_matches_ssd_forward(arch):
    """A 32-token sequence decoded token by token from a zero state
    against ``ssd_forward`` (chunks of 16) of the whole sequence, in the
    port and in the reference: the two gaps agree, and each decode
    step equals the reference's."""
    jp, tp = _params(arch)
    cfg = get_smoke_config(arch)
    x = _x((2, 32, 64), seed=9)
    fwd = ssm.ssd_forward(torch.from_numpy(x), tp, cfg, DotEngine(),
                          chunk=16).numpy()
    jfwd = np.asarray(ref_ssm.ssd_forward(jnp.asarray(x), jp,
                                          jax_smoke(arch), JaxEngine(),
                                          chunk=16))
    st = {k: torch.from_numpy(v) for k, v in _state(cfg, 2).items()}
    jst = {k: jnp.asarray(v) for k, v in _state(cfg, 2).items()}
    dec, jdec = [], []
    for t in range(32):
        o, st = ssm.ssm_decode(torch.from_numpy(x[:, t:t + 1]), tp, cfg,
                               DotEngine(), st)
        jo, jst = ref_ssm.ssm_decode(jnp.asarray(x[:, t:t + 1]), jp,
                                     jax_smoke(arch), JaxEngine(), jst)
        dec.append(o.numpy())
        jdec.append(np.asarray(jo))
    dec, jdec = np.concatenate(dec, 1), np.concatenate(jdec, 1)
    np.testing.assert_allclose(dec, jdec, atol=2e-6, rtol=0)
    gap, jgap = np.abs(dec - fwd).max(), np.abs(jdec - jfwd).max()
    assert gap <= 5e-3 and abs(gap - jgap) <= 1e-5, (gap, jgap)
    np.testing.assert_allclose(st["h"].numpy(), np.asarray(jst["h"]),
                               atol=1e-6, rtol=0)


def test_gradient_finite_at_a_128_token_chunk_where_the_reference_is_not():
    """mamba2 SMOKE at ssd_chunk 128, 2 x 128 tokens: the reference's
    loss is finite and most of its gradient leaves are not; the port's
    loss equals it and every gradient leaf is finite.  At a 32-token
    chunk, where the reference is finite, the port's gradient is within
    1e-4 of its largest magnitude leaf by leaf."""
    arch = "mamba2_780m"
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 128, (2, 128)).astype(np.int32),
             "labels": rng.integers(0, 128, (2, 128)).astype(np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jp = jax_init_model(jax_smoke(arch), jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for chunk in (128, 32):
        jcfg = dataclasses.replace(jax_smoke(arch), ssd_chunk=chunk)
        cfg = dataclasses.replace(get_smoke_config(arch), ssd_chunk=chunk)
        (jl, _), jg = jax.value_and_grad(
            lambda q: ref_loss_fn(q, jcfg, batch, JaxEngine()),
            has_aux=True)(jp)
        loss, _, g = grads_of(cfg, tp, tb, DotEngine())
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        jleaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(jg)]
        leaves = tree_leaves(g)
        assert all(bool(torch.isfinite(v).all()) for v in leaves)
        finite = [bool(np.isfinite(v).all()) for v in jleaves]
        if chunk == 128:
            assert sum(not f for f in finite) >= len(finite) // 2, finite
            continue
        assert all(finite)
        for got, want in zip(leaves, jleaves):
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * scale
