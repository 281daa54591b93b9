"""The port's sharded decode on CPU gloo ranks against the reference's
single-device ``decode_step``.

On a (2, 2, 2) mesh of 8 ranks (``repro_torch.distributed.ctx.spawn``),
qwen3-1.7b SMOKE in f32 on the reference's weights (``params_from_jax``):

* the contiguous cache sequence-parallel (``build_serve_step``: batch 8
  over ("pod", "data"), 32 entries over "model", the online-softmax
  combine of ``distributed.sp_attention``), 6 steps from the reference
  selftest's tokens (``selftest.py:73-99``);
* the paged pool sharded by kv-head under the Hilbert device order, on
  the reference selftest's ragged schedule (``selftest.py:191-275``: a
  slot-isolated prefill of prompts of 5, 3, 1 and 4 tokens, then 3
  lockstep greedy steps).

Logits within 1e-5 of the reference's (the port's f32 decode bound is
2e-5; these stay at rounding level), greedy tokens exactly equal.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as ref_smoke
from repro.models import init_model as ref_init_model
from repro.models.transformer import decode_step as ref_decode_step
from repro.models.transformer import init_decode_state as ref_init_state
from repro.serve.paged_kv import init_paged_serving as ref_paged_serving

import _dist_ranks
from repro_torch.distributed.ctx import spawn

ARCH = "qwen3_1_7b"
SCHEDULE = {"prompts": [[5, 6, 7, 8, 9], [3, 4, 5], [7], [2, 3, 4, 5]],
            "steps": 3}


def _sp_tokens(vocab: int):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (8,)).astype(np.int32) for _ in range(6)]


def _ref_paged(params, cfg):
    """The reference's single-device run of the ragged schedule."""
    prompts, steps = SCHEDULE["prompts"], SCHEDULE["steps"]
    b = len(prompts)
    alloc, state = ref_paged_serving(cfg, b, 32, page_size=4)
    step = jax.jit(lambda p, s, t, pos, mk:
                   ref_decode_step(p, cfg, s, t, pos, row_mask=mk))
    logits, tokens = [], []

    def run(toks, pos, mask):
        nonlocal state
        state["block_tables"] = jnp.asarray(alloc.block_table)
        ll, state = step(params, state, jnp.asarray(toks),
                         jnp.asarray(pos, jnp.int32), jnp.asarray(mask))
        logits.append(np.asarray(ll))
        return np.asarray(ll)

    for s, pr in enumerate(prompts):
        mask = np.zeros(b, bool)
        mask[s] = True
        for i, tok in enumerate(pr):
            alloc.ensure(s, i)
            toks = np.zeros((b, 1), np.int32)
            toks[s, 0] = tok
            run(toks, i, mask)
    pos = max(len(p) for p in prompts)
    toks = np.asarray([[p[-1]] for p in prompts], np.int32)
    for _ in range(steps):
        for s in range(b):
            alloc.ensure(s, pos)
        ll = run(toks, pos, np.ones(b, bool))
        toks = np.argmax(ll[:, 0], -1).astype(np.int32)[:, None]
        tokens.append(toks[:, 0])
        pos += 1
    return logits, tokens


@pytest.fixture(scope="module")
def decode():
    """One spawn of 8 ranks runs both layouts; the reference runs both
    on one device."""
    cfg = dataclasses.replace(ref_smoke(ARCH), remat=False)
    params = ref_init_model(cfg, jax.random.PRNGKey(0))
    sp_tokens = _sp_tokens(cfg.vocab)
    port = spawn(_dist_ranks.decode_ranks, 8, ARCH,
                 jax.tree.map(np.asarray, params), sp_tokens, SCHEDULE)
    state = ref_init_state(cfg, 8, 32)
    step = jax.jit(lambda p, s, t, pos: ref_decode_step(p, cfg, s, t, pos))
    ref_sp = []
    for pos, row in enumerate(sp_tokens):
        ll, state = step(params, state, jnp.asarray(row[:, None]),
                         jnp.asarray(pos, jnp.int32))
        ref_sp.append(np.asarray(ll))
    return port, ref_sp, _ref_paged(params, cfg)


@pytest.mark.parametrize("step", range(6))
def test_sp_decode_step_equals_reference(decode, step):
    port, ref_sp, _ = decode
    got, want = port["sp"][step], ref_sp[step]
    assert got.shape == want.shape == (8, 1, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_paged_pool_is_kv_head_sharded(decode):
    port = decode[0]
    assert port["pool_spec"] == (None, None, "model", None)
    assert port["pool_local"][2] == 1       # 2 kv-heads over 2 ranks


def test_paged_sharded_hilbert_logits_equal_reference(decode):
    port, _, (ref_logits, _) = decode
    assert len(port["paged"]) == len(ref_logits) == 13 + 3
    for got, want in zip(port["paged"], ref_logits):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_paged_sharded_hilbert_greedy_tokens_equal_reference(decode):
    port, _, (_, ref_tokens) = decode
    for got, want in zip(port["tokens"], ref_tokens):
        np.testing.assert_array_equal(got, want)
