"""mellum2-12b-a2.5b on the CPU at its ``SMOKE`` (one whole period of 3
window layers and 1 full YaRN layer, 8 experts top-2): the port against
the plain reference ``tests/reference/mellum2.py`` (f32, TF32 off,
dropless top-k computed exactly; no JAX, no port kernel), and the pieces
it forced one by one: YaRN's tables, the routed moe and its grouped
GEMM (B5)'s plain version, B2's window in its plain and split versions,
and pad rows that are not routed.

The weights are the port's layout with every expert, norm and router
drawn on its own (``init_model`` repeats one SwiGLU over the experts,
which would hide a routing fault).  Bounds: f32 against f32 in another
summation order, 1e-4 on logits of unit size."""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.sfc_matmul_grouped import (  # noqa: E402
    grouped_tables, sfc_matmul_grouped, sfc_matmul_grouped_plain)
from repro_torch.launch.serve import ServeLoop  # noqa: E402
from repro_torch.models import DotEngine, init_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import rope, yarn_inv_freq  # noqa: E402
from repro_torch.models.transformer import decode_step, forward, \
    init_decode_state, prefill_kv_chunk  # noqa: E402
from repro_torch.serve import ServeConfig  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "mellum2_reference", Path(__file__).parent / "reference" / "mellum2.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

ARCH = "mellum2_12b_a2_5b"
TOL = dict(rtol=1e-4, atol=1e-4)


def arch_of(cfg) -> dict:
    """The reference's ``arch`` block of a config."""
    y = cfg.full_rope_yarn
    return dict(n_layers=cfg.n_layers, d_model=cfg.d_model,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                d_head=cfg.d_head, vocab=cfg.vocab, rms_eps=1e-6,
                rope_theta=cfg.rope_theta, layer_types=list(cfg.layer_types),
                sliding_window=cfg.sliding_window, top_k=cfg.moe_topk,
                experts=cfg.moe_experts,
                yarn=dataclasses.asdict(y) if y is not None else None)


def params_of(cfg, seed=0):
    """``init_model``'s tree with every expert, norm and router redrawn."""
    g = torch.Generator().manual_seed(seed)
    p = init_model(cfg, torch.Generator().manual_seed(seed), device="cpu")
    lay = p["layers"]
    for name in ("norm1", "norm2"):
        lay[name] = 1 + 0.1 * torch.randn(lay[name].shape, generator=g)
    p["final_norm"] = 1 + 0.1 * torch.randn(p["final_norm"].shape,
                                            generator=g)
    for name, t in lay["moe"].items():
        lay["moe"][name] = torch.randn(t.shape, generator=g) \
            / math.sqrt(t.shape[-2])
    return p


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config(ARCH)
    return cfg, params_of(cfg)


def test_config_keeps_the_published_widths():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.vocab) == (28, 2304, 32, 4, 128, 98304)
    assert (cfg.moe_experts, cfg.moe_topk, cfg.moe_dff) == (64, 8, 896)
    assert [i for i in range(28) if cfg.layer_window(i) is None] == \
        list(range(3, 28, 4))
    assert {cfg.layer_window(i) for i in range(28)} == {None, 1024}
    assert round(cfg.params_count() / 1e9, 2) == 12.15
    assert round(cfg.active_params_count() / 1e9, 2) == 2.44
    assert not cfg.subquadratic and cfg.routed_moe
    assert "long_500k" not in cfg.runnable_shapes()
    smoke = get_smoke_config(ARCH)
    assert smoke.layer_types == cfg.layer_types[:4]
    assert smoke.moe_experts >= 8 and smoke.moe_topk >= 2


def test_whole_model_window_keeps_its_meaning():
    h2o = get_config("h2o_danube_3_4b")
    assert h2o.subquadratic and not h2o.routed_moe
    assert {h2o.layer_window(i) for i in range(h2o.n_layers)} == {4096}
    assert h2o.layer_rope(0) == (h2o.rope_theta, None)
    for name in ("granite_moe_1b_a400m", "granite_moe_3b_a800m"):
        assert not get_config(name).routed_moe


def test_yarn_tables_follow_the_written_formula():
    cfg = get_config(ARCH)
    y = cfg.full_rope_yarn
    dh, theta = cfg.d_head, cfg.rope_theta

    def find(b):
        return dh * math.log(8192 / (2 * math.pi * b)) / (2 * math.log(theta))

    low, high = math.floor(find(32)), math.ceil(find(1))
    assert (low, high) == (18, 35)
    want = []
    for i in range(dh // 2):
        r = min(max((i - low) / (high - low), 0.0), 1.0)
        f = theta ** (-2 * i / dh)
        want.append((1 - r) * f + r * f / 16)
    want = torch.tensor(want, dtype=torch.float32)
    torch.testing.assert_close(yarn_inv_freq(dh, theta, y), want,
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(ref.yarn_frequencies(
        dh, theta, dataclasses.asdict(y)), want, rtol=1e-6, atol=0)
    pos = torch.tensor([0, 1, 1000, 8191, 8320])
    cos, sin = rope(pos, dh, theta, y)
    ang = pos[:, None].double() * want.double()
    torch.testing.assert_close(cos.double(), torch.cos(ang)
                               * y.attention_factor, rtol=0, atol=2e-3)
    torch.testing.assert_close(sin.double(), torch.sin(ang)
                               * y.attention_factor, rtol=0, atol=2e-3)
    # the first 18 dims keep their frequency, the last 29 are divided by 16
    base = theta ** (-torch.arange(dh // 2).double() * 2 / dh)
    inv = yarn_inv_freq(dh, theta, y).double()
    torch.testing.assert_close(inv[:18], base[:18], rtol=1e-6, atol=0)
    torch.testing.assert_close(inv[35:], base[35:] / 16, rtol=1e-6, atol=0)


def test_forward_logits_match_the_reference(smoke):
    cfg, p = smoke
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(2, cfg.vocab, (1, 32), generator=g)
    mine, _ = forward(p, cfg, {"tokens": toks})
    want = ref.forward_logits(p, arch_of(cfg), toks[0].tolist())
    torch.testing.assert_close(mine[0, :, :cfg.vocab], want, **TOL)


def _prompts(n, lo, hi, vocab, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(2, vocab, (int(torch.randint(lo, hi, (1,),
                                                       generator=g)),),
                          generator=g).tolist() for _ in range(n)]


@pytest.mark.parametrize("layout,mode", [("paged", "continuous"),
                                         ("paged", "lockstep"),
                                         ("contiguous", "lockstep")])
def test_served_tokens_match_the_reference(smoke, layout, mode):
    """Prompts of 12-30 tokens against a window of 8, chunks of 8 tokens
    and pages of 4: every served token is the reference's best at its
    position (within f32 rounding) under the loop's protocol."""
    cfg, p = smoke
    loop = ServeLoop(cfg, p, ServeConfig(
        slots=3, cache_len=64, page_size=4, layout=layout, mode=mode,
        prefill_budget=8, eos_id=-1), device="cpu")
    prompts = _prompts(5, 12, 30, cfg.vocab, 3)
    for r, pr in enumerate(prompts):
        loop.submit(r, pr)
    out = loop.run(max_new=6)
    served = [(pr, out[r][len(pr):]) for r, pr in enumerate(prompts)]
    assert all(len(n) == 6 for _, n in served)
    logits = ref.served_logits(p, arch_of(cfg), served)
    assert ref.gap_report(logits, [n for _, n in served])["max_gap"] < 1e-4
    if layout == "paged" and mode == "continuous":
        rows = loop.moe_expert_rows
        fed = sum(len(pr) + 6 for pr in prompts)   # prompt + fed tokens
        assert rows.sum() == fed * cfg.moe_topk * cfg.n_layers


def test_loop_keeps_every_served_positions_routes(smoke):
    """``route_steps``: every fed position of every request routed once a
    layer, chunk and decode alike, and in f32 the reference's own top-k."""
    cfg, p = smoke
    loop = ServeLoop(cfg, p, ServeConfig(
        slots=3, cache_len=64, page_size=4, layout="paged",
        mode="continuous", prefill_budget=8, eos_id=-1), device="cpu")
    loop.route_steps = []
    prompts = _prompts(4, 12, 30, cfg.vocab, 9)
    for r, pr in enumerate(prompts):
        loop.submit(r, pr)
    out = loop.run(max_new=5)
    seen = {}
    for rids, positions, routes in loop.route_steps:
        assert routes.shape == (cfg.n_layers, len(rids), cfg.moe_topk)
        for j, (rid, pos) in enumerate(zip(rids.tolist(),
                                           positions.tolist())):
            assert (rid, pos) not in seen
            seen[(rid, pos)] = routes[:, j]
    for r, pr in enumerate(prompts):
        fed = ref.fed_sequence(pr, out[r][len(pr):])
        assert sorted(q for rid, q in seen if rid == r) == \
            list(range(len(fed)))
        got = {}

        def hook(i, j, h, got=got):
            got[i] = ref.routing(h, p["layers"]["moe"]["router"][i],
                                 cfg.moe_topk)[1]

        ref.served_logits(p, arch_of(cfg), [(pr, out[r][len(pr):])],
                          on_layer=hook)
        for i in range(cfg.n_layers):
            want = got[i]
            mine = torch.stack([seen[(r, q)][i] for q in range(len(fed))])
            assert torch.equal(mine, want)


def test_routed_moe_equals_the_dense_combine(smoke):
    cfg, p = smoke
    lp = {k: v[0] for k, v in p["layers"]["moe"].items()}
    g = torch.Generator().manual_seed(5)
    x = torch.randn(37, cfg.d_model, generator=g)
    log = moe_mod.MoeLog(cfg.moe_experts, "cpu", routes=True)
    y = moe_mod.moe_routed(x, lp, cfg, DotEngine(), log)
    want, _ = moe_mod.moe_dense(x[None], lp, cfg, DotEngine())
    torch.testing.assert_close(y, want[0], rtol=1e-5, atol=1e-5)
    _, idx, _ = moe_mod._router(x, lp, cfg)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe_experts)
    assert log.counts[:-1].tolist() == counts.tolist()
    assert int(log.counts[-1]) == int((counts > 0).sum())
    assert len(log.routes) == 1 and torch.equal(log.routes[0], idx)


def test_routed_moe_drops_nothing_where_capacity_would(smoke):
    """A 512-row gang whose rows all pick the same two experts: the
    capacity path drops past 1.25 x its share, the routed path equals
    the dropless combine."""
    cfg, p = smoke
    lp = {k: v[0].clone() for k, v in p["layers"]["moe"].items()}
    lp["router"][:, :2] += 5.0 * lp["router"][:, :2].sign()
    g = torch.Generator().manual_seed(6)
    x = torch.randn(512, cfg.d_model, generator=g).abs()
    y = moe_mod.moe_routed(x, lp, cfg, DotEngine())
    want, _ = moe_mod.moe_dense(x[None], lp, cfg, DotEngine())
    capped, _ = moe_mod.moe_capacity(x[None], lp, cfg, DotEngine())
    torch.testing.assert_close(y, want[0], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(capped[0], want[0], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("counts", [[3, 0, 5, 1], [0, 0, 9, 0], [1, 1, 1, 1]])
def test_grouped_plain_equals_a_loop_over_experts(gated, counts):
    g = torch.Generator().manual_seed(sum(counts))
    e, k, n = len(counts), 24, 16
    off = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                       dtype=torch.int32)
    a = torch.randn(int(off[-1]), k, generator=g)
    w = torch.randn(e, k, n, generator=g)
    w3 = torch.randn(e, k, n, generator=g) if gated else None
    out = sfc_matmul_grouped(a, w, off, seg_max=9, w3=w3)
    assert torch.equal(out, sfc_matmul_grouped_plain(a, w, off, w3=w3))
    for i in range(e):
        rows = a[off[i]:off[i + 1]]
        want = kref.matmul_ref(rows, w[i])
        if gated:
            want = torch.nn.functional.silu(want) \
                * kref.matmul_ref(rows, w3[i])
        torch.testing.assert_close(out[off[i]:off[i + 1]], want,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("schedule", ["rowmajor", "morton", "hilbert"])
def test_grouped_tables_walk_each_grid_in_curve_order(schedule):
    from repro_torch.core.schedule import grid_schedule
    tab = grouped_tables(schedule, 4, 7).numpy()
    at = 0
    for mt in range(1, 5):
        assert at == 7 * mt * (mt - 1) // 2
        assert (tab[at:at + mt * 7] == grid_schedule(schedule, mt, 7)).all()
        at += mt * 7
    assert at == len(tab)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("window", [1, 5, 8, 13, 40])
def test_b2_window_plain_and_split_agree(split, window):
    g = torch.Generator().manual_seed(window * 10 + split)
    b, h, hkv, dh, ps, max_pages = 4, 8, 2, 16, 4, 9
    rows = b * max_pages + 1
    kp = torch.randn(rows, ps, hkv, dh, generator=g)
    vp = torch.randn(rows, ps, hkv, dh, generator=g)
    kp[-1] = 0
    vp[-1] = 0
    tables = torch.randperm(rows - 1, generator=g)[:b * max_pages]
    tables = tables.reshape(b, max_pages).to(torch.int32)
    q = torch.randn(b, h, dh, generator=g)
    pos = torch.tensor([0, 7, 18, 35])
    out = kref.paged_decode_attention_ref(q, kp, vp, tables, pos, window)
    split_out = kref.paged_decode_attention_split_ref(q, kp, vp, tables,
                                                      pos, split, window)
    torch.testing.assert_close(split_out, out, rtol=1e-5, atol=1e-5)
    # against a direct softmax over the window's keys of each slot
    for i in range(b):
        k = kp[tables[i].long()].reshape(-1, hkv, dh)
        v = vp[tables[i].long()].reshape(-1, hkv, dh)
        lo = max(0, int(pos[i]) - window + 1)
        kk = k[lo:int(pos[i]) + 1].repeat_interleave(h // hkv, 1)
        vv = v[lo:int(pos[i]) + 1].repeat_interleave(h // hkv, 1)
        s = torch.einsum("hd,thd->ht", q[i], kk) / math.sqrt(dh)
        want = torch.einsum("ht,thd->hd", torch.softmax(s, -1), vv)
        torch.testing.assert_close(out[i], want, rtol=1e-5, atol=1e-5)
    # the ranks start at the first page inside the window
    for p_ in pos.tolist():
        live = kref.attn_live_pages(p_, ps, max_pages)
        first = kref.attn_first_page(p_, ps, window, live)
        assert first == max(0, p_ - window + 1) // ps
        r = kref.attn_page_ranges(live, split, first)
        assert r[0][0] == first and r[-1][1] == live


def test_pad_rows_are_not_routed(smoke):
    """A chunk gang of 3 rows x 8 columns with 11 prompt tokens, then a
    decode step over 2 of 3 rows: the counts cover exactly the valid
    entries, and a pad row's value does not change them."""
    cfg, p = smoke
    st = init_decode_state(cfg, 3, 64, layout="paged", page_size=4,
                           device="cpu")
    n = st["page_perm"].shape[1] // 3
    st["block_tables"][:, :n] = torch.arange(3 * n, dtype=torch.int32
                                             ).reshape(3, n)
    g = torch.Generator().manual_seed(8)
    toks = torch.randint(2, cfg.vocab, (3, 8), generator=g)
    e = cfg.moe_experts
    log = moe_mod.MoeLog(e, "cpu", routes=True)
    prefill_kv_chunk(p, cfg, st, toks, [0, 1, 2], [0, 0, 0], [8, 3, 0],
                     moe_log=log)
    assert int(log.counts[:e].sum()) == 11 * cfg.moe_topk * cfg.n_layers
    assert [tuple(r.shape) for r in log.routes] == \
        [(11, cfg.moe_topk)] * cfg.n_layers
    log2 = moe_mod.MoeLog(e, "cpu", routes=True)
    toks2 = toks.clone()
    toks2[1, 3:] = 1            # pad columns and the pad row differ
    toks2[2] = 1
    prefill_kv_chunk(p, cfg, st, toks2, [0, 1, 2], [0, 0, 0], [8, 3, 0],
                     moe_log=log2)
    assert torch.equal(log.counts, log2.counts)
    assert all(torch.equal(a, b) for a, b in zip(log.routes, log2.routes))
    log3 = moe_mod.MoeLog(e, "cpu")
    logits, _ = decode_step(p, cfg, st, toks[:, :1], torch.tensor([8, 3, 0]),
                            row_mask=torch.tensor([True, True, False]),
                            rows=torch.tensor([0, 1]), moe_log=log3)
    assert int(log3.counts[:e].sum()) == 2 * cfg.moe_topk * cfg.n_layers
    assert log3.routes is None and torch.isfinite(logits[:2]).all()


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root, loaded as a module (its
    CUDA work runs only from ``main``)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("budget,lengths", [(8, (22, 14, 11, 6)),
                                            (16, (30, 9, 13, 20, 5, 17))])
def test_chip_smokes_launch_counts_equal_the_served_runs(smoke, monkeypatch,
                                                         budget, lengths):
    """The card script's launch arithmetic for a served routed moe with
    window layers (``mellum_want_launches``) equals the calls the port
    makes on the CPU to B1, B2 (windowed or not) and B5, with more
    requests than slots and prompts longer than the window."""
    import repro_torch.kernels.ops as ops
    import repro_torch.kernels.sfc_matmul_grouped as b5_mod
    import repro_torch.models.attention as attn_mod

    cfg, p = smoke
    got = {"B1": 0, "B2": 0, "B2 window": 0, "B5": 0}

    def counted(fn, key):
        def call(*a, **kw):
            got[key] += 1
            if key == "B2" and kw.get("window"):
                got["B2 window"] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(ops, "sfc_matmul", counted(ops.sfc_matmul, "B1"))
    monkeypatch.setattr(b5_mod, "sfc_matmul_grouped",
                        counted(b5_mod.sfc_matmul_grouped, "B5"))
    monkeypatch.setattr(attn_mod, "paged_decode_attention_cuda",
                        counted(attn_mod.paged_decode_attention_cuda, "B2"))
    loop = ServeLoop(cfg, p, ServeConfig(
        slots=4, cache_len=48, page_size=4, layout="paged",
        mode="continuous", prefill_budget=budget, eos_id=-1),
        engine=DotEngine(schedule="morton"), device="cpu")
    g = torch.Generator().manual_seed(4)
    for r, n in enumerate(lengths):
        loop.submit(r, torch.randint(2, cfg.vocab, (n,), generator=g).tolist())
    with torch.no_grad():
        loop.run(max_new=8)
    assert loop.chunk_steps > 0 and got["B2 window"] > 0
    assert got == _chip_smoke().mellum_want_launches(cfg, loop.steps,
                                                     loop.chunk_steps)
