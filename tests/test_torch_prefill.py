"""Port parity for prefill: ``repro_torch``'s full-sequence
``attention``, single-shot paged ``prefill_kv`` and chunked paged
``prefill_kv_chunk`` against ``repro``'s, on shared weights
(``params_from_jax``) at the qwen3_1_7b SMOKE width in f32, and chunked
K/V against single-shot K/V.

Bounds (f32, rtol = 0; attention outputs, K/V and logits are O(1)):
atol = 2e-5 against the reference, as ``tests/test_torch_serve.py``'s
logits (f32 summation order in the GEMM tiles and the softmax; measured
here <= 2.5e-6).  Chunked against single-shot K/V within the port: atol
= 1e-5, the reference's own bound for that claim
(``tests/test_paged_kv.py``); measured <= 9.6e-7 (a chunk's rows attend
over the gathered pages, the single shot over the prompt).

Where a chunk's pad columns clamp onto the page its valid columns write,
the reference writes one pool entry twice with two values, and on the
CPU its chunked K/V then part from its single shot (by 2.34 on
``test_chunked_kv_equals_single_shot``'s budget-8 case); the port writes
the valid entries only, so that case is held to the single shot.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.models import DotEngine as JaxEngine
from repro.models import attention as jax_attention_mod
from repro.models import init_model as jax_init_model
from repro.models.layers import rope as jax_rope
from repro.models.transformer import prefill_kv as jax_prefill_kv
from repro.models.transformer import prefill_kv_chunk as jax_prefill_kv_chunk
from repro.serve.paged_kv import init_paged_serving as jax_init_paged_serving
from repro_torch.configs import get_smoke_config
from repro_torch.models import DotEngine, prefill_kv, prefill_kv_chunk
from repro_torch.models import attention as attention_mod
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import rope
from repro_torch.serve.paged_kv import init_paged_serving

ATOL = 2e-5           # port against reference, f32
ATOL_CHUNKED = 1e-5   # chunked against single-shot K/V, f32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """SMOKE-size torch ops gain nothing from a thread pool, and the
    suite runs several test processes at once: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_model(jax_smoke("qwen3_1_7b"), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want, atol=ATOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("variant", ["causal", "swa", "bidirectional"])
def test_attention_matches_reference(weights, variant):
    """Layer 0's full-sequence attention on 16 tokens: causal in q
    chunks of 4 (< 16), sliding window 5 (the window's start aligned
    down to a chunk), and non-causal; output and returned (k, v)."""
    jp, tp = weights
    change = {"causal": {}, "swa": {"swa_window": 5},
              "bidirectional": {"causal": False}}[variant]
    jc = dataclasses.replace(jax_smoke("qwen3_1_7b"), **change)
    tc = dataclasses.replace(get_smoke_config("qwen3_1_7b"), **change)
    s = 16
    x = np.random.default_rng(3).standard_normal(
        (2, s, tc.d_model)).astype(np.float32)
    res = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    jcos, jsin = jax_rope(jnp.arange(s), tc.d_head, tc.rope_theta)
    tcos, tsin = rope(torch.arange(s), tc.d_head, tc.rope_theta)
    want = jax_attention_mod.attention(
        jnp.asarray(x), jl, jc, JaxEngine(schedule="morton"), jcos, jsin,
        q_chunk=4, residual=jnp.asarray(res), return_kv=True)
    got = attention_mod.attention(
        torch.from_numpy(x), tl, tc, DotEngine(schedule="morton"), tcos,
        tsin, q_chunk=4, residual=torch.from_numpy(res), return_kv=True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    k, v = attention_mod.prefill_kv(torch.from_numpy(x), tl, tc,
                                    DotEngine(schedule="morton"), tcos, tsin)
    _close(k, want[1])
    _close(v, want[2])


def _states(ps, width=None, slots=3, cache_len=32):
    cfg_j, cfg_t = jax_smoke("qwen3_1_7b"), get_smoke_config("qwen3_1_7b")
    ja, js = jax_init_paged_serving(cfg_j, slots, cache_len, page_size=ps,
                                    max_pages_per_slot=width)
    ta, ts = init_paged_serving(cfg_t, slots, cache_len, page_size=ps,
                                max_pages_per_slot=width, device="cpu")
    return cfg_j, cfg_t, ja, js, ta, ts


def _pages_equal(ts, js, atol=ATOL):
    for key in ("k_pages", "v_pages"):
        _close(ts[key], js[key], atol)


@pytest.mark.parametrize("page_size", [4, 8])
def test_prefill_kv_pages_and_logits_match_reference(weights, page_size):
    """Two prompts into slots 1 and 0 (ragged last pages); slot 2's
    table stays empty.  Every page of the pool and the logits agree, and
    the reserved zero row stays zero."""
    jp, tp = weights
    cfg_j, cfg_t, ja, js, ta, ts = _states(page_size)
    rng = np.random.default_rng(page_size)
    for slot, n in ((1, 11), (0, 6)):
        prompt = rng.integers(2, cfg_t.vocab, size=n).tolist()
        ja.ensure_range(slot, n)
        ta.ensure_range(slot, n)
        js["block_tables"] = jnp.asarray(ja.block_table)
        ts["block_tables"] = torch.tensor(ta.block_table)
        lj, js = jax_prefill_kv(jp, cfg_j, js, prompt, slot=slot,
                                engine=JaxEngine(schedule="morton"))
        lt, ts2 = prefill_kv(tp, cfg_t, ts, prompt, slot=slot,
                             engine=DotEngine(schedule="morton"))
        assert ts2 is ts                       # the pool is updated in place
        assert lt.shape == lj.shape == (1, n, cfg_t.padded_vocab)
        _close(lt, lj)
        _pages_equal(ts, js)
    assert float(ts["k_pages"][-1].abs().max()) == 0.0


def _gangs(prompts, slots, budget):
    """The serving loop's chunk gangs for prompts admitted into slots
    0.. in order: (tokens, slots, starts, lengths) of shape (slots,
    budget), oldest first under the budget, pad rows of length 0 on
    spare slots."""
    done = [0] * len(prompts)
    while any(d < len(p) for d, p in zip(done, prompts)):
        left, rows = budget, []
        for s, p in enumerate(prompts):
            take = min(left, len(p) - done[s])
            if left <= 0 or take <= 0:
                continue
            rows.append((s, done[s], take))
            left -= take
        toks = np.zeros((slots, budget), np.int32)
        sl, st, ln = (np.zeros(slots, np.int32) for _ in range(3))
        for i, (s, d, t) in enumerate(rows):
            toks[i, :t] = prompts[s][d:d + t]
            sl[i], st[i], ln[i] = s, d, t
            done[s] = d + t
        spare = iter(s for s in range(slots) if s not in {r[0] for r in rows})
        for i in range(len(rows), slots):
            sl[i] = next(spare)
        yield toks, sl, st, ln


@pytest.mark.parametrize("budget", [3, 4])
@pytest.mark.parametrize("page_size", [4, 8])
def test_prefill_kv_chunk_matches_reference(weights, budget, page_size):
    """Three prompts in chunk gangs, with pad rows and ragged rows.  The
    block tables are 3 pages wide and the second prompt fills its table
    in chunks that start off the budget's grid (the first prompt is one
    token), so its last chunk's pad columns run past the table's last
    page (clamped onto it).  Every page of the pool agrees with the
    reference after every chunk."""
    jp, tp = weights
    width = 3
    cfg_j, cfg_t, ja, js, ta, ts = _states(page_size, width=width)
    rng = np.random.default_rng(budget * page_size)
    span = width * page_size
    prompts = [rng.integers(2, cfg_t.vocab, size=n).tolist()
               for n in (1, span, 5)]
    jstep = jax.jit(lambda s, t, sl, st, ln: jax_prefill_kv_chunk(
        jp, cfg_j, s, t, sl, st, ln, JaxEngine(schedule="morton")))
    pad_rows = past_end = 0
    for toks, sl, st, ln in _gangs(prompts, 3, budget):
        for s, d, t in zip(sl, st, ln):
            if t:
                ja.ensure_range(int(s), int(d + t))
                ta.ensure_range(int(s), int(d + t))
        pad_rows += int((ln == 0).sum())
        past_end += int(((st + budget > span) & (ln > 0)).sum())
        js["block_tables"] = jnp.asarray(ja.block_table)
        ts["block_tables"] = torch.tensor(ta.block_table)
        js = jstep(js, jnp.asarray(toks), jnp.asarray(sl), jnp.asarray(st),
                   jnp.asarray(ln))
        out = prefill_kv_chunk(tp, cfg_t, ts, torch.from_numpy(toks),
                               torch.from_numpy(sl), torch.from_numpy(st),
                               torch.from_numpy(ln),
                               DotEngine(schedule="morton"))
        assert out is ts
        _pages_equal(ts, js)
    assert pad_rows > 0 and past_end > 0
    assert float(ts["k_pages"][-1].abs().max()) == 0.0


@pytest.mark.parametrize("budget,page_size", [(4, 4), (3, 8), (8, 4)])
def test_chunked_kv_equals_single_shot(weights, budget, page_size):
    """The same prompts prefilled in chunk gangs and one by one through
    ``prefill_kv`` give the same pool.  At budget 8 over 4-token pages
    and 3-page tables, a last chunk's pad columns clamp onto the page
    its valid columns write (the case where the reference writes one
    entry twice); the port writes valid entries only and still equals
    the single-shot K/V, and both equal the reference's single shot."""
    jp, tp = weights
    width = 3
    cfg_j, cfg_t, ja, js, ta, chunked = _states(page_size, width=width)
    _, _, _, _, tb, single = _states(page_size, width=width)
    span = width * page_size
    rng = np.random.default_rng(budget + page_size)
    prompts = [rng.integers(2, cfg_t.vocab, size=n).tolist()
               for n in (span - 2, 7, 4)]
    eng = DotEngine(schedule="morton")
    for toks, sl, st, ln in _gangs(prompts, 3, budget):
        for s, d, t in zip(sl, st, ln):
            if t:
                ta.ensure_range(int(s), int(d + t))
        chunked["block_tables"] = torch.tensor(ta.block_table)
        prefill_kv_chunk(tp, cfg_t, chunked, torch.from_numpy(toks),
                         torch.from_numpy(sl), torch.from_numpy(st),
                         torch.from_numpy(ln), eng)
    for s, p in enumerate(prompts):
        tb.ensure_range(s, len(p))
        ja.ensure_range(s, len(p))
        single["block_tables"] = torch.tensor(tb.block_table)
        js["block_tables"] = jnp.asarray(ja.block_table)
        prefill_kv(tp, cfg_t, single, p, slot=s, engine=eng)
        _, js = jax_prefill_kv(jp, cfg_j, js, p, slot=s,
                               engine=JaxEngine(schedule="morton"))
    assert ta.state_dict() == tb.state_dict()
    for key in ("k_pages", "v_pages"):
        _close(chunked[key], single[key].numpy(), ATOL_CHUNKED)
    _pages_equal(chunked, js)
