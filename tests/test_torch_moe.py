"""Port parity of the moe layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU, at the granite SMOKE widths (8 experts
top-2; 10 experts top-2, not a power of two), with the reference's
parameters (``init_moe`` through numpy) and numpy-seeded inputs.

Tolerances: the router's indices, the dispatch's buckets, keep flags
and source tokens exactly; the router's weights and aux loss within
1e-6 (f32 softmax of the same f32 product); ``moe_dense`` and
``moe_capacity`` outputs and their gradients within 2e-5 (f32 einsums
summed in another order).  ``moe_ffn`` runs the dense path on at most
256 tokens and the capacity path (which drops) above, as the reference.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.models import DotEngine as JaxEngine
from repro.models import moe as ref_moe
from repro_torch.configs import get_smoke_config
from repro_torch.models import DotEngine
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax

GRANITE = ["granite_moe_1b_a400m", "granite_moe_3b_a800m"]
TOL = dict(atol=2e-5, rtol=0)


def _params(arch, pad=None):
    cfg = jax_smoke(arch)
    jp = ref_moe.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32, pad)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("pad", [None, 16], ids=["", "padded"])
@pytest.mark.parametrize("arch", GRANITE)
def test_router_matches_reference(arch, pad):
    """Indices exact, weights and aux within 1e-6; with the experts
    padded to 16 the pad experts are never chosen."""
    jp, tp = _params(arch, pad)
    xf = _x((96, 64), seed=1)
    cfg = get_smoke_config(arch)
    w, idx, aux = moe._router(torch.from_numpy(xf), tp, cfg)
    jw, jidx, jaux = ref_moe._router(jnp.asarray(xf), jp, jax_smoke(arch))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw, dict(atol=1e-6, rtol=0))
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    assert int(idx.max()) < cfg.moe_experts
    assert tp["router"].shape[-1] == ref_moe.padded_experts(
        jax_smoke(arch), pad)


def test_router_breaks_ties_toward_the_lower_index():
    """A zero router gives every expert the same probability: the top-k
    are experts 0..k-1 for every token, as ``jax.lax.top_k`` picks."""
    arch = "granite_moe_3b_a800m"
    jp, tp = _params(arch)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    xf = _x((12, 64), seed=2)
    _, idx, _ = moe._router(torch.from_numpy(xf), tp, get_smoke_config(arch))
    _, jidx, _ = ref_moe._router(jnp.asarray(xf), jp, jax_smoke(arch))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.tolist() == [[0, 1]] * 12


@pytest.mark.parametrize("capacity", [1, 3, 5, 64])
def test_dispatch_indices_match_reference(capacity):
    """The 10-expert SMOKE: buckets, keep flags and source tokens of 40
    tokens' assignments exactly equal, drops included (80 assignments
    over 10 experts overflow every capacity below 8)."""
    arch = "granite_moe_3b_a800m"
    jp, tp = _params(arch)
    xf = _x((40, 64), seed=4)
    w, idx, _ = moe._router(torch.from_numpy(xf), tp, get_smoke_config(arch))
    jw, jidx, _ = ref_moe._router(jnp.asarray(xf), jp, jax_smoke(arch))
    got = moe._dispatch_indices(idx, w, 10, capacity)
    want = ref_moe._dispatch_indices(jidx, jw, 10, capacity)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    dropped = int((~got[1]).sum())
    assert (dropped > 0) == (capacity < 64), dropped
    kept = got[0][got[1]]
    assert len(set(kept.tolist())) == len(kept)   # kept buckets are unique


@pytest.mark.parametrize("arch", GRANITE)
def test_moe_dense_matches_reference(arch):
    jp, tp = _params(arch)
    x = _x((3, 10, 64), seed=5)
    y, aux = moe.moe_dense(torch.from_numpy(x), tp, get_smoke_config(arch),
                           DotEngine())
    jy, jaux = ref_moe.moe_dense(jnp.asarray(x), jp, jax_smoke(arch),
                                 JaxEngine())
    _close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)


@pytest.mark.parametrize("capacity", [None, 2, 7])
@pytest.mark.parametrize("arch", GRANITE)
def test_moe_capacity_and_its_gradient_match_reference(arch, capacity):
    """Output, aux and the gradients with respect to the input and every
    expert weight within 2e-5, with the default capacity (factor 1.25)
    and with capacities that drop most assignments."""
    jp, tp = _params(arch)
    x = _x((4, 20, 64), seed=6)
    dy = _x((4, 20, 64), seed=7)
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)

    def ref(xx, pp):
        y, aux = ref_moe.moe_capacity(xx, pp, jcfg, JaxEngine(),
                                      capacity=capacity)
        return jnp.sum(y * dy) + aux, (y, aux)

    (_, (jy, jaux)), (jgx, jgp) = jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jp)
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y, aux = moe.moe_capacity(xt, pt, cfg, DotEngine(), capacity=capacity)
    ((y * torch.from_numpy(dy)).sum() + aux).backward()
    _close(y, jy)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=1e-6,
                               rtol=0)
    _close(xt.grad, jgx)
    for k in ("w1", "w3", "w2", "router"):
        _close(pt[k].grad, jgp[k])


@pytest.mark.parametrize("tokens", [256, 257])
@pytest.mark.parametrize("arch", GRANITE)
def test_dispatch_rule_at_256_and_257_tokens(arch, tokens):
    """``moe_ffn`` on (1, tokens): the dense path at 256 tokens, the
    capacity path (default factor, drops) at 257; the same result as the
    reference's dispatcher within 2e-5."""
    jp, tp = _params(arch)
    x = _x((1, tokens, 64), seed=8)
    cfg = get_smoke_config(arch)
    xt = torch.from_numpy(x)
    y, _ = moe.moe_ffn(xt, tp, cfg, DotEngine())
    jy, _ = ref_moe.moe_ffn(jnp.asarray(x), jp, jax_smoke(arch), JaxEngine())
    _close(y, jy)
    path = moe.moe_dense if tokens <= 256 else moe.moe_capacity
    other = moe.moe_capacity if tokens <= 256 else moe.moe_dense
    assert torch.equal(y, path(xt, tp, cfg, DotEngine())[0])
    assert not torch.equal(y, other(xt, tp, cfg, DotEngine())[0])


def test_expert_parallelism_waits_for_a15():
    """A mesh under ``impl`` "auto" or "ep" runs expert parallelism
    (``moe_ep``, 2 gloo ranks, a (1, 2) mesh, 4 of the 8 experts each):
    every rank routes its half of the sequence with the capacity of its
    own tokens, so the output is ``moe_capacity`` of each half, within
    2e-5; outside its mesh context it raises.  Without a mesh "ep", and
    with one any other impl, run the capacity path with the caller's
    ``capacity``, as the reference's dispatcher does."""
    import _dist_ranks
    from repro_torch.distributed.ctx import spawn

    arch = "granite_moe_1b_a400m"
    jp, tp = _params(arch)
    cfg = get_smoke_config(arch)
    x = _x((2, 300, 64), seed=10)
    xt = torch.from_numpy(x)
    halves = [moe.moe_capacity(h, tp, cfg, DotEngine())[0]
              for h in xt.chunk(2, 1)]
    for impl in ("auto", "ep"):
        with pytest.raises(ValueError, match="mesh_context"):
            moe.moe_ffn(xt, tp, cfg, DotEngine(), mesh=object(), impl=impl)
        got = spawn(_dist_ranks.moe_ffn_ranks, 2, arch,
                    jax.tree.map(np.asarray, jp), x, impl)
        _close(torch.from_numpy(got["y"]), torch.cat(halves, 1).numpy())
    x = _x((2, 6, 64), seed=9)
    xt = torch.from_numpy(x)
    for mesh, impl in ((None, "ep"), (object(), "capacity")):
        y, _ = moe.moe_ffn(xt, tp, cfg, DotEngine(), mesh=mesh, impl=impl,
                           capacity=2)
        jy, _ = ref_moe.moe_ffn(jnp.asarray(x), jp, jax_smoke(arch),
                                JaxEngine(), impl=impl, capacity=2)
        _close(y, jy)
        assert torch.equal(y, moe.moe_capacity(xt, tp, cfg, DotEngine(),
                                               capacity=2)[0])


@pytest.mark.parametrize("arch", GRANITE)
def test_init_moe_matches_reference_shapes_and_structure(arch):
    """The reference's (unpadded) tree and dtypes, stacked on a lead
    axis; the experts one SwiGLU repeated, w1 scaled by 1 + 0.01 e."""
    jp, _ = _params(arch)
    p = moe.init_moe(torch.Generator().manual_seed(0),
                     get_smoke_config(arch), torch.float32, lead=(2,),
                     device="cpu")
    for k, v in jp.items():
        assert tuple(p[k].shape) == (2, *v.shape), k
        assert p[k].dtype == torch.float32
    e = p["w1"].shape[1]
    scale = 1 + 0.01 * torch.arange(e, dtype=torch.float32)
    torch.testing.assert_close(p["w1"][1], p["w1"][1, :1] * scale[:, None,
                                                                 None])
    assert torch.equal(p["w3"][0, 0], p["w3"][0, -1])
    assert not torch.equal(p["w2"][0], p["w2"][1])
