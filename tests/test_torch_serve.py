"""Port parity for the model slice: ``repro_torch``'s paged
``decode_step`` against ``repro``'s on shared weights
(``params_from_jax``) at the qwen3_1_7b SMOKE width, the configs field
by field, and ``init_model``'s parameter tree and distributions.  The
paged step's write plan, built once a step: rows that write nothing
(stale, masked), a scalar position, mellum2's window layers against
their plain reference (``tests/reference/mellum2.py``), and a census
of its ops at several depths.

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
from repro_torch.launch.opcount import count_step
from repro_torch.models import DotEngine, decode_step, init_decode_state, \
    init_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.paged_kv import init_paged_serving, physical_rows, \
    zero_row_index
from test_torch_mellum2 import ARCH as MELLUM2, TOL as MELLUM2_TOL, \
    arch_of, params_of, ref as mellum2_ref

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


def _pair(dtype, page_size, b=3):
    """Both packages' models on shared weights and paged states of ``b``
    slots -> (port config, (reference, port) allocators, states, both):
    ``both(toks, pos, mask)`` runs one decode step of each and returns
    (reference logits, port logits); ``states`` holds each side's newest
    state under "j" and "t"."""
    jc, tc = _configs(dtype)
    jp = jax_init_model(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ja, js = jax_init_paged_serving(jc, b, 32, page_size=page_size)
    ta, ts = init_paged_serving(tc, b, 32, page_size=page_size, device="cpu")
    je, te = JaxEngine(schedule="morton"), DotEngine(schedule="morton")
    jstep = jax.jit(lambda p, s, t, pos, m: jax_decode_step(
        p, jc, s, t, pos, je, row_mask=m))
    states = {"j": js, "t": ts}

    def both(toks, pos, mask):
        js, ts = states["j"], states["t"]
        js["block_tables"] = jnp.asarray(ja.block_table)
        ts["block_tables"] = torch.tensor(ta.block_table)
        lj, states["j"] = jstep(jp, js, jnp.asarray(toks), jnp.asarray(pos),
                                jnp.asarray(mask))
        lt, states["t"] = decode_step(tp, tc, ts, torch.tensor(toks),
                                      torch.tensor(pos), te,
                                      row_mask=torch.tensor(mask))
        return np.asarray(lj, np.float32), lt.float().numpy()

    return tc, (ja, ta), states, both


def _prompts(vocab):
    """Three ragged prompts, of 5, 3 and 7 tokens."""
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, size=n).tolist() for n in (5, 3, 7)]


def _prefill(prompts, allocs, both, b=3):
    """Slot-isolated prefill of ``prompts``, a token a step; yields
    (reference logits, port logits, mask) a step."""
    for s, prompt in enumerate(prompts):
        mask = np.zeros(b, bool)
        mask[s] = True
        for i, tok in enumerate(prompt):
            for alloc in allocs:
                alloc.ensure(s, i)
            toks = np.zeros((b, 1), np.int32)
            toks[s, 0] = tok
            yield (*both(toks, np.int32(i), mask), mask)


def _drive(dtype, page_size, steps=5):
    """Slot-isolated prefill of ragged prompts, then lockstep decode on
    per-slot positions; yields (reference logits, port logits, mask)."""
    tc, allocs, _, both = _pair(dtype, page_size)
    prompts = _prompts(tc.vocab)
    yield from _prefill(prompts, allocs, both)
    pos = np.asarray([len(p) for p in prompts], np.int32)
    toks = np.asarray([[p[-1]] for p in prompts], np.int32)
    for step in range(steps):
        mask = np.asarray([True, step % 2 == 0, True])  # ragged active set
        for s in np.nonzero(mask)[0]:
            for alloc in allocs:
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


@pytest.mark.parametrize("case", ["stale", "masked", "scalar"])
def test_paged_decode_step_edge_rows_match_reference(case):
    """One decode step after the prefill, whose writes the step's plan
    decides: ``stale``, row 1's position lies past its slot's table (its
    row mask set) and it writes nothing; ``masked``, row 1's mask is off
    and it writes nothing; ``scalar``, one position for every row.  The
    logits of the rows that decode and the whole pool are the
    reference's."""
    page_size = 4
    tc, allocs, states, both = _pair("float32", page_size)
    prompts = _prompts(tc.vocab)
    list(_prefill(prompts, allocs, both))
    pos = np.asarray([len(p) for p in prompts], np.int32)
    mask = np.ones(3, bool)
    live = [0, 1, 2]
    if case == "stale":
        pos[1] = page_size * states["t"]["block_tables"].shape[1] + 1
        live = [0, 2]
    elif case == "masked":
        mask[1] = False
        live = [0, 2]
    else:
        pos = np.int32(pos.max())
    for s in live:
        for alloc in allocs:
            alloc.ensure(s, int(np.broadcast_to(pos, 3)[s]))
    toks = np.asarray([[p[-1]] for p in prompts], np.int32)
    lj, lt = both(toks, pos, mask)
    np.testing.assert_allclose(lt[live], lj[live], **BOUNDS["float32"])
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(states["t"][name].numpy(),
                                   np.asarray(states["j"][name]),
                                   **BOUNDS["float32"])


@pytest.mark.parametrize("clock", ["staggered", "lockstep"])
def test_paged_decode_step_window_layers_match_reference(clock):
    """mellum2 SMOKE (3 layers of an 8-key window, 1 full layer), three
    requests of 13, 9 and 17 tokens fed a token a step through paged
    decode steps on pages of 4: ``staggered``, each row on its own clock
    from its own start, a row idle before it (masked) and after it (a
    stale position past its table); ``lockstep``, one scalar position,
    a row masked after its end.  Every fed position's logits are the
    plain reference's (``tests/reference/mellum2.py``), the pool holds
    the K/V of the contiguous strips fed alike at exactly the entries
    that were fed, and every other entry stays zero."""
    cfg = get_smoke_config(MELLUM2)
    p = params_of(cfg)
    b, ps = 3, 4
    g = torch.Generator().manual_seed(5)
    seqs = [torch.randint(2, cfg.vocab, (n,), generator=g).tolist()
            for n in (13, 9, 17)]
    starts = (0, 3, 1) if clock == "staggered" else (0, 0, 0)
    alloc, paged = init_paged_serving(cfg, b, 32, page_size=ps, device="cpu")
    strips = init_decode_state(cfg, b, 32, device="cpu")
    stale = ps * paged["block_tables"].shape[1] + 2
    got = [[] for _ in range(b)]
    for t in range(max(s + len(q) for s, q in zip(starts, seqs))):
        qpos = [t - s for s in starts]
        mask = np.asarray([0 <= q < len(sq) for q, sq in zip(qpos, seqs)])
        toks = torch.tensor([[sq[q] if m else 0] for q, sq, m
                             in zip(qpos, seqs, mask)], dtype=torch.int32)
        if clock == "staggered":
            pos = torch.tensor([q if q < len(sq) else stale
                                for q, sq in zip(qpos, seqs)],
                               dtype=torch.int32).clamp(min=0)
        else:
            pos = torch.tensor(t, dtype=torch.int32)
        for s in np.nonzero(mask)[0]:
            alloc.ensure(int(s), qpos[s])
        paged["block_tables"] = torch.tensor(alloc.block_table)
        m = torch.tensor(mask)
        logits, _ = decode_step(p, cfg, paged, toks, pos, row_mask=m)
        decode_step(p, cfg, strips, toks, pos, row_mask=m)
        for s in np.nonzero(mask)[0]:
            got[s].append(logits[s, 0, :cfg.vocab])
    for s, sq in enumerate(seqs):
        want = mellum2_ref.forward_logits(p, arch_of(cfg), sq)
        torch.testing.assert_close(torch.stack(got[s]), want, **MELLUM2_TOL)
    phys = physical_rows(paged["page_perm"], paged["block_tables"],
                         zero_row_index(paged["k_pages"]))
    fed = torch.zeros(paged["k_pages"].shape[:2], dtype=torch.bool)
    for name in ("k_pages", "v_pages"):
        pool, strip = paged[name], strips[name[0]]
        for i in range(cfg.n_layers):
            for s, sq in enumerate(seqs):
                q = torch.arange(len(sq))
                rows = phys[i, s, q // ps].long()
                fed[rows, q % ps] = True
                torch.testing.assert_close(pool[rows, q % ps],
                                           strip[i, s, :len(sq)],
                                           **MELLUM2_TOL)
        assert not pool[~fed].any()


def test_paged_decode_step_plans_its_writes_once():
    """The write plan (page index, offset, the clamp, the block table's
    gather and the masks) and the write rows' gather are built once a
    step: a qwen3 SMOKE paged decode step counts the same of their ops
    at 1, 2 and 4 layers."""
    plan_ops = ("floor_divide", "remainder", "clamp", "lt", "ge", "gather",
                "bitwise_and")
    counts = []
    for n in (1, 2, 4):
        cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"), n_layers=n)
        params = init_model(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        alloc, st = init_paged_serving(cfg, 3, 32, page_size=4, device="cpu")
        for s in range(3):
            alloc.ensure(s, 5)
        st["block_tables"] = torch.tensor(alloc.block_table)
        census = count_step(decode_step, params, cfg, st,
                            torch.ones(3, 1, dtype=torch.int32),
                            torch.tensor([5, 40, 5], dtype=torch.int32),
                            row_mask=torch.tensor([True, True, False])
                            )["op_census"]
        counts.append({op: census.get(op, 0) for op in plan_ops})
    assert counts[0] == counts[1] == counts[2]
    assert counts[0]["floor_divide"] == 1


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
    """Every arch of the reference is registered now; one it does not
    have raises a KeyError that names the registered archs."""
    get_config("hubert_xlarge")
    with pytest.raises(KeyError, match="qwen3_1_7b"):
        get_config("gpt2")


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
