"""Port parity for the contiguous KV layout: ``repro_torch``'s
``decode_attention``, ``init_decode_state``, contiguous ``decode_step``
(scalar and per-row positions), ``prefill_kv`` and ``prefill_kv_chunk``
against ``repro``'s on shared weights (``params_from_jax``) at SMOKE
widths in f32; the per-row SWA ring against the reference's scalar ring
row by row; and a contiguous ``ServeLoop``'s snapshot and restore.

Bounds (f32, rtol = 0; attention outputs, K/V and logits are O(1)):
atol = 2e-5, as ``tests/test_torch_serve.py``'s logits (f32 summation
order in the GEMM tiles and the softmax).  ``kv_pos`` (which only a
scalar-position step writes), shapes and greedy tokens are exact.

The reference's contiguous chunk scatter clamps pad columns onto the
strips' last entry (``min(pos, c - 1)``) and writes every entry back,
so a row whose valid columns reach that entry writes it twice, with two
values.  On the CPU the K/V the reference's chunks leave there part
from its single shot (``test_chunk_scatter_at_the_strips_end``); the
port writes the valid entries only and is held to the single shot.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.serve import ServeLoop as JaxServeLoop
from repro.models import DotEngine as JaxEngine
from repro.models import attention as jax_attention_mod
from repro.models import init_model as jax_init_model
from repro.models import transformer as jax_tf
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import DotEngine, decode_step, init_decode_state, \
    prefill_kv, prefill_kv_chunk
from repro_torch.models import attention as attention_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import KVLayout, ServeConfig

ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """SMOKE-size torch ops gain nothing from a thread pool, and the
    suite runs several test processes at once: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WEIGHTS = {}


def _weights(arch):
    if arch not in _WEIGHTS:
        jp = jax_init_model(jax_smoke(arch), jax.random.PRNGKey(0))
        _WEIGHTS[arch] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                              device="cpu"))
    return _WEIGHTS[arch]


def _close(got, want, atol=ATOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def _attn_inputs(cfg, b, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((b, c, cfg.n_kv_heads, cfg.d_head)) \
        .astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    return x, kc, vc


def _ref_attention(cfg, jp, x, kc, vc, kv_pos, ws, cur, mask):
    jc = cfg
    cos, sin = jax_tf._decode_rope(jc, cur)
    out, k2, v2 = jax_attention_mod.decode_attention(
        jnp.asarray(x), _layer0(jp["layers"])["attn"], jc,
        JaxEngine(schedule="morton"), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kv_pos), jnp.asarray(ws), jnp.asarray(cur), cos, sin,
        None if mask is None else jnp.asarray(mask))
    return np.asarray(out), np.asarray(k2), np.asarray(v2)


def _port_attention(cfg, tp, x, kc, vc, kv_pos, ws, cur, mask):
    cur_t = torch.tensor(cur)
    cos, sin = tf_mod._decode_rope(cfg, cur_t, "cpu")
    kt, vt = torch.tensor(kc), torch.tensor(vc)
    out, k2, v2 = attention_mod.decode_attention(
        torch.tensor(x), _layer0(tp["layers"])["attn"], cfg,
        DotEngine(schedule="morton"), kt, vt, torch.tensor(kv_pos),
        torch.tensor(ws), cur_t, cos, sin,
        None if mask is None else torch.tensor(mask))
    assert k2 is kt and v2 is vt          # written in place
    return out, k2, v2


@pytest.mark.parametrize("masked", [False, True], ids=["all", "row_mask"])
@pytest.mark.parametrize("window", [None, 6], ids=["full", "swa6"])
@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_decode_attention_matches_reference(kind, window, masked):
    """Layer 0's contiguous decode attention, 3 rows x 16 entries.
    Scalar: a shared ``kv_pos`` with empty (-1) and stale entries, the
    write at entry 11 for position 11.  Vector: rows at positions 3, 9
    and 14, each writing its own entry; the reference's vector path
    has no window, so the SWA case keeps every row inside its window
    (the ring beyond it is held to the reference's scalar ring below).
    ``row_mask`` leaves the middle row's strips untouched."""
    jp, tp = _weights("qwen3_1_7b")
    jc = dataclasses.replace(jax_smoke("qwen3_1_7b"), swa_window=window)
    tc = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                             swa_window=window)
    b, c = 3, 16
    x, kc, vc = _attn_inputs(tc, b, c, seed=1)
    mask = np.asarray([True, False, True]) if masked else None
    if kind == "scalar":
        kv_pos = np.asarray([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 27, -1, -1,
                             14, -1], np.int32)
        ws, cur = np.int32(11), np.int32(11)
    else:
        kv_pos = np.full(c, -1, np.int32)
        cur = np.asarray([3, 9, 14], np.int32)
        if window is not None:
            cur = np.asarray([3, 5, 2], np.int32)
        ws = cur % c
    want = _ref_attention(jc, jp, x, kc, vc, kv_pos, ws, cur, mask)
    got = _port_attention(tc, tp, x, kc, vc, kv_pos, ws, cur, mask)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "row_mask"])
@pytest.mark.parametrize("window", [None, 6], ids=["full", "swa6"])
@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_decode_plan_given_equals_computed(kind, window, masked):
    """A step computes :func:`decode_plan` once for all its layers: the
    attention it feeds gives bit-equal outputs and strips to the one
    that computes its own plan, on the inputs above."""
    _, tp = _weights("qwen3_1_7b")
    tc = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                             swa_window=window)
    b, c = 3, 16
    x, kc, vc = _attn_inputs(tc, b, c, seed=1)
    mask = torch.tensor([True, False, True]) if masked else None
    if kind == "scalar":
        kv_pos = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 27, -1, -1,
                               14, -1], dtype=torch.int32)
        cur = torch.tensor(11)
    else:
        kv_pos = torch.full((c,), -1, dtype=torch.int32)
        cur = torch.tensor([3, 9, 14] if window is None else [3, 5, 2])
    ws = torch.remainder(cur, c)
    cos, sin = tf_mod._decode_rope(tc, cur, "cpu")
    lp = _layer0(tp["layers"])["attn"]
    outs = []
    for plan in (None, attention_mod.decode_plan(tc, b, c, kv_pos, ws, cur,
                                                 mask, "cpu")):
        kt, vt = torch.tensor(kc), torch.tensor(vc)
        out, _, _ = attention_mod.decode_attention(
            torch.tensor(x), lp, tc, DotEngine(schedule="morton"), kt, vt,
            kv_pos, ws, cur, cos, sin, mask, plan=plan)
        outs.append((out, kt, vt))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("cur", [[5, 40, 63], [70, 31, 32]],
                         ids=["one_wrapped", "all_past_c"])
def test_vector_ring_equals_reference_scalar_ring_row_by_row(cur):
    """The per-row SWA ring (c = 32 entries, window 32, positions past
    c): row b's output and written entries equal the reference's scalar
    ring run on row b alone, with ``kv_pos`` the positions that row's
    clock puts in its entries (``ring_positions``)."""
    jp, tp = _weights("h2o_danube_3_4b")
    jc, tc = jax_smoke("h2o_danube_3_4b"), get_smoke_config("h2o_danube_3_4b")
    c = tc.swa_window
    cur = np.asarray(cur, np.int32)
    x, kc, vc = _attn_inputs(tc, len(cur), c, seed=2)
    got = _port_attention(tc, tp, x, kc, vc, np.full(c, -1, np.int32),
                          cur % c, cur, None)
    held = attention_mod.ring_positions(torch.tensor(cur).long(), c).numpy()
    for r in range(len(cur)):
        kv_pos = np.where(held[r] >= 0, held[r], -1).astype(np.int32)
        kv_pos[cur[r] % c] = -1               # the entry written now
        want = _ref_attention(jc, jp, x[r:r + 1], kc[r:r + 1], vc[r:r + 1],
                              kv_pos, np.int32(cur[r] % c), np.int32(cur[r]),
                              None)
        for g, w in zip(got, want):
            _close(g[r:r + 1], w)


def test_ring_positions_are_each_rows_last_c_positions():
    cur = torch.tensor([0, 5, 31, 32, 77])
    held = attention_mod.ring_positions(cur, 32)
    for r, p in enumerate(cur.tolist()):
        live = sorted(int(h) for h in held[r] if h >= 0)
        assert live == list(range(max(0, p - 31), p + 1))
        assert int(held[r, p % 32]) == p
        assert (torch.remainder(held[r], 32) == torch.arange(32)).all()


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "glm4_9b",
                                  "deepseek_coder_33b", "h2o_danube_3_4b"])
@pytest.mark.parametrize("cache_len", [24, 64])
def test_init_decode_state_matches_reference(arch, cache_len):
    """Contiguous strips (n_layers, B, c, hkv, dh), c = min(cache_len,
    swa_window), and ``kv_pos`` all -1; None means contiguous; the paged
    layout goes to the paged constructor."""
    jst = jax_tf.init_decode_state(jax_smoke(arch), 3, cache_len)
    st = init_decode_state(get_smoke_config(arch), 3, cache_len,
                           device="cpu")
    assert st.layout is KVLayout.CONTIGUOUS
    assert sorted(st) == sorted(jst) == ["k", "kv_pos", "v"]
    for key in st:
        assert tuple(st[key].shape) == tuple(jst[key].shape)
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]))
    assert st["kv_pos"].dtype == torch.int32
    cfg = get_smoke_config(arch)
    if cfg.swa_window is None:
        pst = init_decode_state(cfg, 3, cache_len, layout="paged",
                                page_size=4, device="cpu")
        assert pst.layout is KVLayout.PAGED and "k_pages" in pst
    else:
        with pytest.raises(ValueError, match="SWA"):
            init_decode_state(cfg, 3, cache_len, layout=KVLayout.PAGED,
                              device="cpu")


def _drive_contiguous(arch, kind, cache_len, decode_steps):
    """Slot-isolated prefill of ragged prompts (scalar positions, one-hot
    row mask), then decode steps on a ragged active set, with per-row
    positions (``vector``) or one shared position (``scalar``, every
    row at the same clock); yields (reference, port) (logits, state)."""
    jc, tc = jax_smoke(arch), get_smoke_config(arch)
    jp, tp = _weights(arch)
    b = 3
    js = jax_tf.init_decode_state(jc, b, cache_len)
    ts = init_decode_state(tc, b, cache_len, device="cpu")
    je, te = JaxEngine(schedule="morton"), DotEngine(schedule="morton")
    jstep = jax.jit(lambda p, s, t, pos, m: jax_tf.decode_step(
        p, jc, s, t, pos, je, row_mask=m))

    def both(toks, pos, mask):
        nonlocal js
        lj, js = jstep(jp, js, jnp.asarray(toks), jnp.asarray(pos),
                       jnp.asarray(mask))
        lt, st = decode_step(tp, tc, ts, torch.tensor(toks),
                             torch.tensor(pos), te,
                             row_mask=torch.tensor(mask))
        assert st is ts
        return (np.asarray(lj), js), (lt, ts)

    rng = np.random.default_rng(0)
    lens = (5, 3, 7) if kind == "vector" else (6, 6, 6)
    prompts = [rng.integers(2, tc.vocab, size=n).tolist() for n in lens]
    for s, prompt in enumerate(prompts):
        mask = np.zeros(b, bool)
        mask[s] = True
        for i, tok in enumerate(prompt):
            toks = np.zeros((b, 1), np.int32)
            toks[s, 0] = tok
            yield both(toks, np.int32(i), mask)
    pos = np.asarray(lens, np.int32)
    toks = np.asarray([[p[-1]] for p in prompts], np.int32)
    for step in range(decode_steps):
        if kind == "vector":
            mask = np.asarray([True, step % 2 == 0, True])
            arg = pos
        else:
            mask = np.ones(b, bool)
            arg = np.int32(pos[0])
        ref, mine = both(toks, arg, mask)
        yield ref, mine
        nxt = ref[0][:, 0].argmax(-1).astype(np.int32)
        toks = np.where(mask, nxt, toks[:, 0])[:, None].astype(np.int32)
        pos = pos + mask


@pytest.mark.parametrize("arch,kind,cache_len,steps", [
    ("qwen3_1_7b", "vector", 32, 8),
    ("qwen3_1_7b", "scalar", 32, 8),
    ("glm4_9b", "vector", 32, 6),
    ("h2o_danube_3_4b", "scalar", 64, 40),      # c = 32: the ring wraps
    ("h2o_danube_3_4b", "vector", 64, 12),      # every row inside c
])
def test_contiguous_decode_step_matches_reference(arch, kind, cache_len,
                                                  steps):
    """Every step's logits and strips within ATOL; ``kv_pos`` exact
    after each step on a scalar position.  Steps on per-row positions
    (after the vector case's 15 prefill steps) leave the port's
    ``kv_pos`` as it was: their validity comes from each row's clock,
    and the reference's write there is never read."""
    n, frozen = 0, None
    prefill = 15 if kind == "vector" else 18
    for (lj, js), (lt, ts) in _drive_contiguous(arch, kind, cache_len,
                                                steps):
        _close(lt, lj)
        _close(ts["k"], js["k"])
        _close(ts["v"], js["v"])
        if kind == "vector" and n >= prefill:
            np.testing.assert_array_equal(ts["kv_pos"].numpy(), frozen)
        else:
            np.testing.assert_array_equal(ts["kv_pos"].numpy(),
                                          np.asarray(js["kv_pos"]))
            frozen = ts["kv_pos"].numpy().copy()
        n += 1
    assert n == prefill + steps


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "h2o_danube_3_4b"])
def test_contiguous_prefill_kv_matches_reference(arch):
    """A 13-token prompt into slot 1 of 3 (24-entry strips): logits,
    both strips (slot 1 written, the others untouched) and ``kv_pos``."""
    jc, tc = jax_smoke(arch), get_smoke_config(arch)
    jp, tp = _weights(arch)
    prompt = np.random.default_rng(3).integers(2, tc.vocab, size=13)
    js = jax_tf.init_decode_state(jc, 3, 24)
    ts = init_decode_state(tc, 3, 24, device="cpu")
    ts["k"].fill_(0.5)            # written entries must overwrite
    js["k"] = jnp.full(js["k"].shape, 0.5, js["k"].dtype)
    lj, js = jax_tf.prefill_kv(jp, jc, js, jnp.asarray(prompt), slot=1,
                               engine=JaxEngine(schedule="morton"))
    lt, st = prefill_kv(tp, tc, ts, prompt.tolist(), slot=1,
                        engine=DotEngine(schedule="morton"))
    assert st is ts
    _close(lt, lj)
    _close(ts["k"], js["k"])
    _close(ts["v"], js["v"])
    np.testing.assert_array_equal(ts["kv_pos"].numpy(),
                                  np.asarray(js["kv_pos"]))
    with pytest.raises(ValueError, match="outgrows"):
        prefill_kv(tp, tc, ts, list(range(2, 27)), slot=0)


def _chunk_args(rows, slots, budget, prompts):
    toks = np.zeros((slots, budget), np.int32)
    sl, st, ln = (np.zeros(slots, np.int32) for _ in range(3))
    for i, (s, start, n) in enumerate(rows):
        toks[i, :n] = prompts[s][start:start + n]
        sl[i], st[i], ln[i] = s, start, n
    spare = iter(s for s in range(slots) if s not in {r[0] for r in rows})
    for i in range(len(rows), slots):
        sl[i] = next(spare)
    return toks, sl, st, ln


def _run_chunks(tp, tc, jp, jc, cache_len, chunks, prompts, budget):
    js = jax_tf.init_decode_state(jc, 3, cache_len)
    ts = init_decode_state(tc, 3, cache_len, device="cpu")
    for rows in chunks:
        args = _chunk_args(rows, 3, budget, prompts)
        js = jax_tf.prefill_kv_chunk(jp, jc, js, *map(jnp.asarray, args),
                                     engine=JaxEngine(schedule="morton"))
        st = prefill_kv_chunk(tp, tc, ts, *map(torch.tensor, args),
                              engine=DotEngine(schedule="morton"))
        assert st is ts
    return js, ts


def test_contiguous_prefill_kv_chunk_matches_reference():
    """Two gangs of ragged chunks (a pad row in each), the second
    reading the first back: strips within ATOL, ``kv_pos`` exact, and
    each prompt's K/V equal to a single-shot ``prefill_kv``'s."""
    jc, tc = jax_smoke("qwen3_1_7b"), get_smoke_config("qwen3_1_7b")
    jp, tp = _weights("qwen3_1_7b")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, tc.vocab, size=n).tolist() for n in (11, 6)]
    chunks = [[(0, 0, 8), (1, 0, 4)], [(0, 8, 3), (1, 4, 2)]]
    js, ts = _run_chunks(tp, tc, jp, jc, 32, chunks, prompts, 8)
    _close(ts["k"], js["k"])
    _close(ts["v"], js["v"])
    np.testing.assert_array_equal(ts["kv_pos"].numpy(),
                                  np.asarray(js["kv_pos"]))
    assert ts["kv_pos"].tolist()[:12] == list(range(11)) + [-1]
    for s, p in enumerate(prompts):
        single = init_decode_state(tc, 3, 32, device="cpu")
        prefill_kv(tp, tc, single, p, slot=s,
                   engine=DotEngine(schedule="morton"))
        for key in ("k", "v"):
            _close(ts[key][:, s, :len(p)], single[key][:, s, :len(p)], 1e-5)


def test_prefill_kv_chunk_raises_past_the_strips():
    """A chunk whose valid columns reach past the strips raises (the
    strips keep no ring for chunked prefill); pad columns past them
    write nothing and do not."""
    _, tp = _weights("qwen3_1_7b")
    tc = get_smoke_config("qwen3_1_7b")
    prompt = list(range(2, 22))
    ts = init_decode_state(tc, 3, 16, device="cpu")
    eng = DotEngine(schedule="morton")
    prefill_kv_chunk(tp, tc, ts, *map(torch.tensor, _chunk_args(
        [(0, 8, 4)], 3, 12, [prompt, [], []])), engine=eng)
    with pytest.raises(ValueError, match="past the 16-entry strips"):
        prefill_kv_chunk(tp, tc, ts, *map(torch.tensor, _chunk_args(
            [(0, 12, 5)], 3, 12, [prompt, [], []])), engine=eng)


@pytest.mark.parametrize("mode", ["lockstep", "continuous"])
def test_contiguous_loop_raises_when_a_request_outgrows_the_strips(mode):
    """Without a ring, a prompt and its new tokens must fit cache_len:
    12 + 4 tokens fit 16 entries and are served, 12 + 5 raise at
    admission, before any step writes."""
    _, tp = _weights("qwen3_1_7b")

    def loop():
        return ServeLoop(get_smoke_config("qwen3_1_7b"), tp,
                         ServeConfig(slots=2, cache_len=16, mode=mode,
                                     prefill_budget=4, eos_id=-1),
                         engine=DotEngine(schedule="morton"), device="cpu")

    ok = loop()
    ok.submit(0, list(range(2, 14)))
    assert len(ok.run(max_new=4)[0]) == 16
    bad = loop()
    bad.submit(0, list(range(2, 14)))
    with pytest.raises(RuntimeError, match="outgrow the 16-entry strips"):
        bad.run(max_new=5)
    assert not bad.active.any() and bad.out == {}


def test_chunk_scatter_at_the_strips_end():
    """A 16-token prompt in 16-entry strips, chunks of 12: the second
    chunk's 4 valid columns end at entry 15 and its 8 pad columns clamp
    onto entry 15 in the reference.  The port's strips equal the single
    shot's; the reference's last entry parts from its own single shot
    (recorded in ROADMAP.md queue C) while every other entry agrees."""
    jc, tc = jax_smoke("qwen3_1_7b"), get_smoke_config("qwen3_1_7b")
    jp, tp = _weights("qwen3_1_7b")
    prompt = np.random.default_rng(5).integers(2, tc.vocab, size=16).tolist()
    js, ts = _run_chunks(tp, tc, jp, jc, 16, [[(0, 0, 12)], [(0, 12, 4)]],
                         [prompt, [], []], 12)
    single = init_decode_state(tc, 3, 16, device="cpu")
    prefill_kv(tp, tc, single, prompt, slot=0,
               engine=DotEngine(schedule="morton"))
    jsingle = jax_tf.init_decode_state(jc, 3, 16)
    _, jsingle = jax_tf.prefill_kv(jp, jc, jsingle, jnp.asarray(prompt),
                                   slot=0, engine=JaxEngine(schedule="morton"))
    for key in ("k", "v"):
        _close(ts[key], single[key], 1e-5)
        _close(single[key], jsingle[key])
        ref = np.asarray(js[key])
        _close(ts[key][:, :, :15], ref[:, :, :15])
        gap = np.abs(ref[:, 0, 15] - np.asarray(jsingle[key])[:, 0, 15]).max()
        assert gap > 1e-3, gap


def test_decode_step_rejects_non_dense_family():
    cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"), family="moe")
    st = init_decode_state(get_smoke_config("qwen3_1_7b"), 1, 8,
                           device="cpu")
    with pytest.raises(NotImplementedError, match="moe"):
        decode_step({}, cfg, st, torch.zeros(1, 1, dtype=torch.int32), 0)


# ------------------------------------------------------------ snapshot --
SNAP_PROMPTS = [[5, 6, 7, 8, 9, 10], [20, 21, 22], [30, 31, 32, 33],
                [40, 41]]


def _snap_loop(tp, mode, **extra):
    return ServeLoop(get_smoke_config("qwen3_1_7b"), tp,
                     ServeConfig(slots=2, cache_len=32, mode=mode,
                                 prefill_budget=4, eos_id=-1, **extra),
                     engine=DotEngine(schedule="morton"), device="cpu")


@pytest.mark.parametrize("mode", ["lockstep", "continuous"])
@pytest.mark.parametrize("where", ["memory", "disk"])
def test_contiguous_snapshot_restore_replays(mode, where, tmp_path):
    """Snapshot a contiguous loop mid-run (strips, ``kv_pos`` and the
    scheduler; no allocator), run to the end, restore, run again: the
    same tokens, equal to an uninterrupted run's."""
    from repro_torch.runtime import ServeSnapshotter

    _, tp = _weights("qwen3_1_7b")
    clean = _snap_loop(tp, mode)
    for r, p in enumerate(SNAP_PROMPTS):
        clean.submit(r, p)
    want = clean.run(max_new=6)
    loop = _snap_loop(tp, mode)
    assert loop.alloc is None
    for r, p in enumerate(SNAP_PROMPTS):
        loop.submit(r, p)
    for _ in range(5):
        loop._run_iteration(6)
    snap = ServeSnapshotter(loop, root=str(tmp_path) if where == "disk"
                            else None)
    snap.snapshot(loop._iter)
    first = {r: list(t) for r, t in loop.run(max_new=6).items()}
    assert snap.restore(from_disk=where == "disk") == 5
    assert loop.state.layout is KVLayout.CONTIGUOUS
    again = loop.run(max_new=6)
    assert first == again == want


def test_contiguous_chaos_retries_equal_clean_and_reference():
    """A retry-only chaos schedule on a contiguous continuous loop
    (snapshots every iteration; no allocator, so step and kernel
    faults): tokens equal the clean run's, and the reference's loop
    under the same schedule gives the same tokens."""
    jp, tp = _weights("qwen3_1_7b")
    spec = "step@step=2,kernel@step=4,step@step=6"
    clean = _snap_loop(tp, "continuous")
    chaos = _snap_loop(tp, "continuous", chaos=spec, retry_backoff_s=0.0)
    ref = JaxServeLoop(jax_smoke("qwen3_1_7b"), jp,
                       JaxServeConfig(slots=2, cache_len=32,
                                      mode="continuous", prefill_budget=4,
                                      eos_id=-1, chaos=spec,
                                      retry_backoff_s=0.0),
                       engine=JaxEngine(schedule="morton"))
    for loop in (clean, chaos, ref):
        for r, p in enumerate(SNAP_PROMPTS):
            loop.submit(r, p)
    want = clean.run(max_new=6)
    assert chaos.run(max_new=6) == want == ref.run(max_new=6)
    assert chaos.snapshotter.restores == ref.snapshotter.restores >= 2
    assert chaos.chaos.exhausted()
