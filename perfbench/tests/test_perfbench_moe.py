"""The mellum2-12b cell's pieces: the benchmark's copy of the plain
reference against the repository's, the closed forms by hand (the window
limits keys; only routed experts count), the traffic's quantiles, a
tiny cell of the same kind end to end on the CPU, and on the card the
fp8 control and the program's expert counts against the harness's
routing.  The card tests skip without one:

    python3 -m pytest perfbench/tests -m card -k moe
"""
from __future__ import annotations

import importlib.util
import json
import shutil
import statistics

import pytest
from conftest import ROOT

from perfbench.harness import flops_moe as FM
from perfbench.harness.cell import load_benchmark, load_traffic, \
    resolve_cell
from perfbench.harness.peaks import BF16_FLOPS, HBM_BYTES_S

CFG = json.loads((ROOT / "perfbench/configs/mellum2-12b.json").read_text())
ARCH = CFG["arch"]
CELL = "mellum2-12b.codectx"
SEEDS = (2147483711, 2147483712, 2147483713)

TINY = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
            vocab=256, padded_vocab=256, rms_eps=1e-6, rope_theta=500000.0,
            layer_types=["sliding_attention"] * 3 + ["full_attention"],
            sliding_window=8,
            yarn=dict(factor=16.0, original_max_position_embeddings=64,
                      beta_fast=32.0, beta_slow=1.0,
                      attention_factor=1.2772588722239782),
            experts=8, top_k=2, expert_dim=32, dtype="float32")
# float32: at these widths a bf16 rounding flips a token's 2nd of 8
# experts often, and half its moe output with it (gaps near 1)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_tiny_moe_root(dest):
    """A checkout holding ``perfbench`` and one more cell,
    ``tiny.codectx``: the mellum2 cell's kind at ``TINY``."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = dest / "perfbench"
    cfg = dict(CFG, name="tiny-moe", arch=dict(TINY))
    (pb / "configs/tiny-moe.json").write_text(json.dumps(cfg))
    tr = load_traffic("codectx")
    tr.update(clients=4, prompts=dict(min=16, max=48, block=4,
                                      order=[0, 2, 1, 3], rotate=1),
              max_new=8, serve=dict(tr["serve"], slots=4, cache_len=64,
                                    page_size=8, prefill_budget=16))
    (pb / "traffic/tiny-codectx.json").write_text(json.dumps(tr))
    b = load_benchmark(ROOT)
    b["configs"].append({"name": "tiny-moe", "source": "tests",
                         "file": "perfbench/configs/tiny-moe.json",
                         "reduced": [], "why": "CPU tests"})
    b["workloads"].append({"name": "tiny.codectx", "config": "tiny-moe",
                           "traffic": "tiny-codectx", "chips": 1,
                           "why": "CPU tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny.codectx")
    (dest / "BENCHMARK.json").write_text(json.dumps(b))
    return dest


def _weights(seed=3, dtype="float32"):
    torch = pytest.importorskip("torch")
    drv = _module(ROOT / "perfbench/drivers/serve_moe.py", "pb_serve_moe")
    return torch, drv.make_weights(dict(TINY, dtype=dtype), seed, "cpu")


def test_the_benchmarks_reference_equals_the_repositorys():
    torch, w = _weights()
    bench = _module(ROOT / "perfbench/reference/moe_window_lm.py", "pb_ref")
    repo = _module(ROOT / "tests/reference/mellum2.py", "repo_ref")
    reqs = [(list(range(5, 25)), [7, 9, 11]), (list(range(30, 43)), [3])]
    for precision in ("f32", "fp8"):
        a = bench.served_logits(w, TINY, reqs, precision)
        b = repo.served_logits(w, TINY, reqs, precision)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(bench.forward_logits(w, TINY, list(range(2, 30))),
                       repo.forward_logits(w, TINY, list(range(2, 30))))


def test_the_window_changes_the_references_logits():
    torch, w = _weights()
    ref = _module(ROOT / "perfbench/reference/moe_window_lm.py", "pb_ref2")
    toks = list(range(3, 40))
    wide = dict(TINY, sliding_window=1000)
    a = ref.forward_logits(w, TINY, toks)
    b = ref.forward_logits(w, wide, toks)
    # the first 8 positions see the same keys under either window
    assert torch.allclose(a[:8], b[:8], atol=1e-5)
    assert not torch.allclose(a[8:], b[8:], atol=1e-3)


def test_parameters_and_token_flops_by_hand():
    per_attn = 2 * 2304 * 4096 + 2 * 2304 * 512
    assert per_attn == 21_233_664
    expert = 3 * 2304 * 896
    assert expert == 6_193_152
    total, active = FM.params(ARCH)
    assert total == 2 * 98304 * 2304 + 28 * (per_attn + 2304 * 64
                                             + 64 * expert)
    assert round(total / 1e9, 2) == 12.15 and round(active / 1e9, 2) == 2.44
    row = 2 * 28 * (per_attn + 2304 * 64 + 8 * expert)
    # 500 keys: every layer reads all of them
    assert FM.token_flops(ARCH, 500, False) == row + 4 * 500 * 128 * 32 * 28
    # 3000 keys: 21 window layers read 1024, 7 full layers 3000
    keys = 21 * 1024 + 7 * 3000
    assert FM.attention_keys(ARCH, 3000) == keys
    assert FM.token_flops(ARCH, 3000, True) == \
        row + 4 * keys * 128 * 32 + 2 * 2304 * 98304
    assert FM.kv_bytes(ARCH, 3000, 2) == 2 * 4 * 128 * 2 * keys


@pytest.mark.parametrize("a,take", [(0, 256), (900, 256), (1020, 5),
                                    (5000, 256)])
def test_prefill_flops_sum_the_token_flops(a, take):
    want = sum(FM.token_flops(ARCH, p + 1, False) for p in range(a, a + take))
    assert FM.prefill_flops(ARCH, a, take) == pytest.approx(want, rel=1e-12)


def test_expert_least_time_by_hand():
    d, f = 2304, 896
    # a decode step of 7 rows touching 39 experts: bound by the weights
    byts = 39 * 3 * d * f * 2 + 56 * (2 * d + 4 * f + 4 * d)
    assert FM.expert_least_s(ARCH, 7, 39, 2) == pytest.approx(
        byts / HBM_BYTES_S)
    assert 2 * 56 * 3 * d * f / BF16_FLOPS < byts / HBM_BYTES_S / 10
    # a 256-token chunk touching all 64: still bound by bytes
    ops = 2 * 2048 * 3 * d * f
    byts = 64 * 3 * d * f * 2 + 2048 * (2 * d + 4 * f + 4 * d)
    assert ops / BF16_FLOPS < byts / HBM_BYTES_S
    assert FM.expert_least_s(ARCH, 256, 64, 2) == pytest.approx(
        byts / HBM_BYTES_S)
    assert FM.expert_least_s(ARCH, 0, 0, 2) == 0.0


def test_router_and_projections_in_b1s_least_time():
    one = FM.rows_least_s(ARCH, 1, False, 2)
    proj = sum((1 * k + k * n + n) * 2 for _, k, n in
               FM.attn_projections(ARCH)) / HBM_BYTES_S
    router = (2304 + 2304 * 64 + 64) * 4 / HBM_BYTES_S
    assert one == pytest.approx(28 * (proj + router))


def test_traffic_quantiles():
    drv = _module(ROOT / "perfbench/drivers/serve.py", "pb_serve")
    tr = load_traffic("codectx")
    lengths = drv.prompt_lengths(tr["prompts"])
    assert lengths[0] == 2233 and lengths[-1] == 7512
    assert round(statistics.mean(lengths)) == 4426
    assert max(lengths) + tr["max_new"] <= tr["serve"]["cache_len"]
    assert tr["serve"]["slots"] * tr["serve"]["prefill_budget"] == 2048


def test_tiny_cell_runs_end_to_end_on_the_cpu(tmp_path):
    pytest.importorskip("torch")
    from perfbench.run import measure
    root = make_tiny_moe_root(tmp_path / "checkout")
    cell = resolve_cell("tiny.codectx", root)
    out = measure(cell, 2147483659, 4.0, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["serve_tok_s"]["value"] > 0
    traced = measure(cell, 2147483659, 4.0, True, device="cpu")
    assert traced["correct"], traced["checks"]
    # no device trace on the CPU: only what the program's spans give
    assert traced["metrics"]["moe_rows_per_expert"]["value"] >= 1
    assert "b5_roofline_pct" not in traced["metrics"]
    assert set(out["checks"]) == {"max_logit_gap", "max_route_margin"}


def test_unrecorded_routes_fail_the_check(tmp_path):
    """A served position the loop did not route (a route of -1) makes the
    check fail, not pass on a reference that routes on its own."""
    pytest.importorskip("torch")
    root = make_tiny_moe_root(tmp_path / "checkout")
    cell = resolve_cell("tiny.codectx", root)
    rec = cell.driver.run(cell, 2147483662, 3.0, False, device="cpu")
    assert all(c["ok"] for c in cell.driver.checks(cell, rec))
    rec["routes"][0][:, 0] = -1
    bad = cell.driver.checks(cell, rec)
    assert not bad[1]["ok"] and bad[1]["missing"] >= 1


def test_a_route_that_repeats_an_expert_fails_the_check(tmp_path,
                                                        monkeypatch):
    """The loop's recorded routes with each row's last expert replaced by
    its first: the reference routed the same way drops the same
    assignment and the margin reads the top expert as taken, so only the
    count of rows without k distinct experts can fail the check."""
    pytest.importorskip("torch")
    root = make_tiny_moe_root(tmp_path / "checkout")
    cell = resolve_cell("tiny.codectx", root)
    drv = cell.driver
    recorded = drv._request_routes

    def doubled(steps, wanted):
        for _, _, dev in steps:
            dev[..., -1] = dev[..., 0]
        return recorded(steps, wanted)

    monkeypatch.setattr(drv, "_request_routes", doubled)
    rec = drv.run(cell, 2147483663, 3.0, False, device="cpu")
    bad = drv.checks(cell, rec)
    assert not bad[1]["ok"] and bad[1]["missing"] >= 1


def test_tiny_cell_records_b5s_least_time(tmp_path):
    torch = pytest.importorskip("torch")
    root = make_tiny_moe_root(tmp_path / "checkout")
    cell = resolve_cell("tiny.codectx", root)
    rec = cell.driver.run(cell, 2147483660, 3.0, True, device="cpu")
    assert rec["b5_least_s"] > 0
    spans = [s for s in rec["program_spans"]
             if s["name"] == "serve.decode.dispatch"]
    assert spans and all("moe_rows" in s["args"] for s in spans)
    assert torch.is_tensor(rec["weights"]["layers"]["moe"]["w1"])


def test_controls_go_through_the_cells_checks(tmp_path):
    pytest.importorskip("torch")
    root = make_tiny_moe_root(tmp_path / "checkout")
    c = resolve_cell("tiny.codectx", root)
    out = c.driver.control(c, 2147483661, 4.0, device="cpu")
    assert out["program_correct"], out
    assert out["requests"] > 0
    prog, ctrl = out["program"], out["control_fp8"]
    assert ctrl[0]["tokens"] == prog[0]["tokens"] > 0
    assert ctrl[1]["positions"] == prog[1]["positions"] > 0
    # f32 on the CPU: the program routes and computes as the reference
    assert prog[0]["value"] < 1e-3 and prog[1]["value"] < 1e-4


@pytest.fixture
def on_card(card):
    import torch

    from perfbench.run import _paths

    _paths()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


@pytest.mark.card
def test_fp8_control_fails_the_moe_serving_limit(on_card):
    c = resolve_cell(CELL, ROOT)
    for seed in SEEDS:
        out = c.driver.control(c, seed, 51.0)
        assert out["requests"] > 0, out
        assert out["program_correct"] and not out["control_correct"], out


@pytest.mark.card
def test_programs_expert_counts_match_the_harness_routing(on_card):
    """One chunk step of the cell's model at full width, 4 rows of 256
    prompt tokens from position 0: the program's per-expert counts and
    experts touched (summed over layers) against the reference's top-8
    of the same tokens.  bf16 against f32 may swap a near-tie of the 8th
    and 9th expert: at most 2 % of the assignments move, and the experts
    touched differ by at most 1 % (1629 against 1633 of 28 x 64 on the
    card's first reading)."""
    import numpy as np
    import torch
    from repro_torch.models import init_decode_state, prefill_kv_chunk
    from repro_torch.models.moe import MoeLog

    c = resolve_cell(CELL, ROOT)
    drv = c.driver
    w = drv.make_weights(ARCH, SEEDS[0], "cuda")
    loop = drv._program(c.config, c.traffic, w, torch.device("cuda"), False)
    cfg = loop.cfg
    del loop
    st = init_decode_state(cfg, 4, 256, layout="paged", page_size=16,
                           device="cuda")
    n = st["page_perm"].shape[1] // 4
    st["block_tables"][:, :n] = torch.arange(4 * n, dtype=torch.int32,
                                             device="cuda").reshape(4, n)
    g = torch.Generator().manual_seed(SEEDS[0])
    toks = torch.randint(2, ARCH["vocab"], (4, 256), generator=g)
    e = ARCH["experts"]
    log = MoeLog(e, "cuda")
    prefill_kv_chunk(w, cfg, st, toks.cuda(), [0, 1, 2, 3], [0] * 4,
                     [256] * 4, moe_log=log)
    got = log.counts.cpu().numpy()
    del st
    torch.cuda.empty_cache()
    routes = drv.step_routing(c, w, {i: toks[i].tolist() for i in range(4)})
    picks = np.concatenate([r.reshape(r.shape[0], -1)
                            for r in routes.values()], axis=1)
    want = np.bincount(picks.reshape(-1), minlength=e)
    touched = sum(len(np.unique(picks[i])) for i in range(ARCH["n_layers"]))
    assert got[:e].sum() == want.sum() == 4 * 256 * 8 * ARCH["n_layers"]
    moved = np.abs(got[:e] - want).sum() / 2
    assert moved <= 0.02 * want.sum()
    # a moved assignment can take one expert out and put one in
    assert abs(int(got[e]) - touched) <= min(2 * moved, 0.01 * touched)
