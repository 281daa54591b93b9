"""Port parity for the model slice: ``repro_torch``'s paged
``decode_step`` against ``repro``'s on shared weights
(``params_from_jax``) at the qwen3_1_7b SMOKE width, the configs field
by field, and ``init_model``'s parameter tree and distributions.

Bounds on the logits (O(1) values): f32 atol = 2e-5, rtol = 0, about
6x the largest difference measured on this test's inputs (3.2e-6; f32
summation order in the GEMM tiles and attention).  bf16 atol = 2e-2,
rtol = 0: the activations round to bf16 after every projection, and one
rounding that lands the other way (2**-8 relative) moves O(1) logits by
up to ~1e-2 (measured here: 4.8e-7, no rounding flipped)."""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import DotEngine as JaxEngine
from repro.models import decode_step as jax_decode_step
from repro.models import init_model as jax_init_model
from repro.serve.paged_kv import init_paged_serving as jax_init_paged_serving
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import DotEngine, decode_step, init_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.paged_kv import init_paged_serving

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """SMOKE-size torch ops gain nothing from a thread pool, and the
    suite runs several test processes at once: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BOUNDS = {"float32": dict(rtol=0, atol=2e-5),
          "bfloat16": dict(rtol=0, atol=2e-2)}


def _configs(dtype):
    jc = dataclasses.replace(jax_smoke("qwen3_1_7b"), param_dtype=dtype,
                             act_dtype=dtype)
    tc = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                             param_dtype=dtype, act_dtype=dtype)
    return jc, tc


def _drive(dtype, page_size, steps=5):
    """Slot-isolated prefill of ragged prompts, then lockstep decode on
    per-slot positions; yields (reference logits, port logits, mask)."""
    jc, tc = _configs(dtype)
    jp = jax_init_model(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    b = 3
    ja, js = jax_init_paged_serving(jc, b, 32, page_size=page_size)
    ta, ts = init_paged_serving(tc, b, 32, page_size=page_size, device="cpu")
    je, te = JaxEngine(schedule="morton"), DotEngine(schedule="morton")
    jstep = jax.jit(lambda p, s, t, pos, m: jax_decode_step(
        p, jc, s, t, pos, je, row_mask=m))

    def both(toks, pos, mask):
        nonlocal js, ts
        js["block_tables"] = jnp.asarray(ja.block_table)
        ts["block_tables"] = torch.tensor(ta.block_table)
        lj, js = jstep(jp, js, jnp.asarray(toks), jnp.asarray(pos),
                       jnp.asarray(mask))
        lt, ts = decode_step(tp, tc, ts, torch.tensor(toks),
                             torch.tensor(pos), te,
                             row_mask=torch.tensor(mask))
        return np.asarray(lj, np.float32), lt.float().numpy()

    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, tc.vocab, size=n).tolist() for n in (5, 3, 7)]
    for s, prompt in enumerate(prompts):
        mask = np.zeros(b, bool)
        mask[s] = True
        for i, tok in enumerate(prompt):
            for alloc in (ja, ta):
                alloc.ensure(s, i)
            toks = np.zeros((b, 1), np.int32)
            toks[s, 0] = tok
            yield (*both(toks, np.int32(i), mask), mask)
    pos = np.asarray([len(p) for p in prompts], np.int32)
    toks = np.asarray([[p[-1]] for p in prompts], np.int32)
    for step in range(steps):
        mask = np.asarray([True, step % 2 == 0, True])  # ragged active set
        for s in np.nonzero(mask)[0]:
            for alloc in (ja, ta):
                alloc.ensure(int(s), int(pos[s]))
        lj, lt = both(toks, pos, mask)
        yield lj, lt, mask
        nxt = lj[:, 0].argmax(-1).astype(np.int32)
        toks = np.where(mask, nxt, toks[:, 0])[:, None].astype(np.int32)
        pos = pos + mask


@pytest.mark.parametrize("dtype,page_size", [("float32", 4),
                                             ("float32", 8),
                                             ("bfloat16", 4)])
def test_paged_decode_step_logits_match_reference(dtype, page_size):
    n = 0
    for lj, lt, mask in _drive(dtype, page_size):
        live = np.nonzero(mask)[0]
        assert lt.shape == lj.shape
        np.testing.assert_allclose(lt[live], lj[live], **BOUNDS[dtype])
        assert (lt[live, 0].argmax(-1) == lj[live, 0].argmax(-1)).all()
        n += 1
    assert n == 15 + 5


def test_decode_step_rejects_contiguous_state():
    """The contiguous layout is ported: a contiguous state without its
    strips is rejected (no fall-through to the paged path), one built by
    ``init_decode_state`` is served."""
    from repro_torch.models import init_decode_state
    from repro_torch.serve.state import DecodeState, KVLayout
    cfg = get_smoke_config("qwen3_1_7b")
    st = DecodeState({}, KVLayout.CONTIGUOUS)
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(KeyError, match="'k'"):
        decode_step(params, cfg, st, torch.zeros(1, 1, dtype=torch.int32), 0)
    st = init_decode_state(cfg, 1, 8, device="cpu")
    logits, st = decode_step(params, cfg, st,
                             torch.zeros(1, 1, dtype=torch.int32), 0)
    assert logits.shape == (1, 1, cfg.padded_vocab)
    assert st["kv_pos"].tolist() == [0] + [-1] * 7


@pytest.mark.parametrize("get_t,get_j", [(get_config, jax_config),
                                         (get_smoke_config, jax_smoke)])
def test_qwen3_configs_equal_reference_field_by_field(get_t, get_j):
    mine, ref = get_t("qwen3_1_7b"), get_j("qwen3_1_7b")
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.padded_vocab == ref.padded_vocab
    assert mine.params_count() == ref.params_count()
    assert get_t("qwen3-1-7b") == mine


def test_unported_arch_raises_and_names_roadmap():
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("hubert_xlarge")


def test_init_model_tree_and_distributions_match_reference():
    jc, tc = _configs("float32")
    jp = jax.tree.map(np.asarray, jax_init_model(jc, jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    tp = init_model(tc, gen, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, arr in jflat:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == arr.shape, path
        assert t.dtype == torch.float32
    lay = tp["layers"]
    assert torch.equal(lay["norm1"], torch.ones_like(lay["norm1"]))
    assert torch.equal(lay["attn"]["q_norm"],
                       torch.ones_like(lay["attn"]["q_norm"]))
    d, dff = tc.d_model, tc.d_ff
    for w, d_in in ((lay["attn"]["wq"], d), (lay["mlp"]["w1"], d),
                    (lay["mlp"]["w2"], dff), (tp["lm_head"], d)):
        assert abs(float(w.std()) * np.sqrt(d_in) - 1.0) < 0.1
    assert abs(float(tp["embed"].std()) / 0.02 - 1.0) < 0.1
    bf = init_model(dataclasses.replace(tc, param_dtype="bfloat16"),
                    torch.Generator().manual_seed(0), device="cpu")
    assert bf["lm_head"].dtype == torch.bfloat16
