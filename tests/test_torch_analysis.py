"""Port parity for the static checks: ``repro_torch.analysis.schedule``
and ``python -m repro_torch.analysis`` against ``repro.analysis`` under
the reference's own constants (``TPU_V5E`` as a port ``HW``), and B2's
contract under the H100.

Exact throughout (host arithmetic over the same tables): the bijection
proofs' reports on every schedule and on corrupt orders (their
violation codes, messages and stats), the stack-distance traffic, the
cost-model and link-model cross-checks, and the CLI's ``contracts``,
``schedules`` and ``winner`` sections.  The port's CLI reports under
the H100 and omits the reference's HLO section (there is no HLO), saying
so; ``--epilogue-gate`` is refused.  Under the H100,
``check_attn_contract`` sizes B2 by what it allocates
(``attn_smem_bytes`` at ``attn_stage_pages``) against one block's
shared-memory limit; under the reference's constants it keeps the
reference's TPU working set and result.
"""
import dataclasses
import json

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.analysis.__main__ as ref_cli
import repro.core.energy as ref_energy
from repro.analysis import check_attn_contract as ref_attn_contract
from repro.analysis.schedule import crosscheck_cost_model as ref_crosscheck
from repro.analysis.schedule import crosscheck_link_model as ref_link
from repro.analysis.schedule import stack_distance_traffic as ref_traffic
from repro.analysis.schedule import verify_order as ref_verify_order
from repro.analysis.schedule import verify_schedule as ref_verify_schedule
from repro.tune import DecodeAttnSpec as RefAttnProblem
from repro.tune.cost import AttnSpec as RefAttnSpec
import repro_torch.analysis.__main__ as cli
from repro_torch.analysis import STATIC_DRIFT_TOL, check_attn_contract, \
    crosscheck_cost_model, crosscheck_link_model, stack_distance_traffic, \
    verify_order, verify_schedule
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.energy import H100, HW
from repro_torch.core.schedule import SCHEDULES, grid_schedule
from repro_torch.kernels.paged_attention import _SMEM_LIMIT, \
    attn_smem_bytes, attn_stage_pages
from repro_torch.tune import DecodeAttnSpec
from repro_torch.tune.cache import TuneCache
from repro_torch.tune.cost import AttnSpec

REF_HW = HW(**dataclasses.asdict(ref_energy.TPU_V5E))
GRIDS = [(1, 1), (2, 2), (3, 5), (4, 4), (5, 3), (8, 2), (7, 7), (16, 16)]


def _same(mine, ref):
    """Two ContractReports equal as dicts (subject, ok, violations in
    order, stats)."""
    assert mine.to_dict() == ref.to_dict()


# ------------------------------------------------------------ verifier --
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_verify_schedule_equals_reference(name):
    """Every schedule at ragged and square grids (supertile at g = 2 and
    4): the same proof, every one passing."""
    for g in ((2, 4) if name == "supertile" else (0,)):
        for rows, cols in GRIDS:
            mine = verify_schedule(name, rows, cols, g=g)
            _same(mine, ref_verify_schedule(name, rows, cols, g=g))
            assert mine.ok, mine.to_dict()


def _corrupt_orders():
    rng = np.random.default_rng(0)
    base = np.array(grid_schedule("hilbert", 8, 8))
    out = {}
    t = base.copy()
    t[1] = t[1][::-1]
    out["transposed"] = t
    d = base.copy()
    d[rng.integers(0, 64, 5)] = d[0]
    out["duplicates"] = d
    o = base.copy()
    o[[3, 9]] = [(9, 1), (-1, 2)]
    out["out-of-bounds"] = o
    out["short"] = base[:-3]
    out["long"] = np.concatenate([base, base[:2]])
    out["shuffled"] = base[rng.permutation(64)]
    out["wrong-width"] = np.zeros((64, 3), int)
    out["many-races"] = np.zeros((64, 2), int)
    return out


@pytest.mark.parametrize("kind", sorted(_corrupt_orders()))
def test_verify_order_on_corrupt_orders_equals_reference(kind):
    """Hand-corrupted 8 x 8 orders: the same violations (codes,
    messages, at most 8 of each kind) and stats as the reference's; a
    shuffled permutation still passes."""
    order = _corrupt_orders()[kind]
    mine = verify_order(order, 8, 8)
    _same(mine, ref_verify_order(order, 8, 8))
    assert mine.ok == (kind == "shuffled")


# ---------------------------------------------------- traffic and drift --
@pytest.mark.parametrize("capacity", [1, 2, 5, 16])
@pytest.mark.parametrize("schedule", ["rowmajor", "boustrophedon", "morton",
                                      "hilbert"])
def test_stack_distance_traffic_equals_reference(schedule, capacity):
    """Misses, bytes, accesses and hit rate on a 6 x 4 grid, kt = 3, with
    unequal A, B and C block bytes."""
    order = grid_schedule(schedule, 6, 4)
    bb = {"A": 3 * 1024, "B": 5 * 1024, "C": 7 * 1024}
    mine = stack_distance_traffic(order, 3, bb, capacity)
    assert mine == ref_traffic(order, 3, bb, capacity)
    assert mine["misses"] > 0


@pytest.mark.parametrize("mt", [2, 4, 8, 16])
@pytest.mark.parametrize("schedule", ["rowmajor", "boustrophedon", "morton",
                                      "hilbert", "supertile"])
def test_crosscheck_cost_model_equals_reference(schedule, mt):
    """Under the reference's constants: the same model and static bytes,
    drift and capacity, passing within STATIC_DRIFT_TOL; with a pinned
    4-block cache too.  Under the H100 (the CLI's part) the check passes
    as well."""
    g = 4 if schedule == "supertile" else 0
    for cap in (None, 4):
        mine = crosscheck_cost_model(schedule, mt, mt, 2, g=g, capacity=cap,
                                     hw=REF_HW)
        _same(mine, ref_crosscheck(schedule, mt, mt, 2, g=g, capacity=cap))
        assert mine.ok and mine.stats["rel_drift"] <= STATIC_DRIFT_TOL
    h100 = crosscheck_cost_model(schedule, mt, mt, 2, g=g)
    assert h100.ok, h100.to_dict()


def test_crosscheck_detects_planted_drift():
    """Same machinery, wrong capacity: the static replay at a quarter of
    the model's cache disagrees beyond tolerance on a pressured grid, in
    both packages by the same bytes, so the cross-check can fail."""
    from repro.tune.cost import TuneConfig as RefTuneConfig
    from repro.tune.cost import predict as ref_predict
    from repro_torch.tune.cost import TuneConfig, predict

    mt, kt = 8, 2
    est = predict(TuneConfig(schedule="rowmajor"), mt * 128, mt * 128,
                  kt * 128, 4, capacity=8, hw=REF_HW)
    ref_est = ref_predict(RefTuneConfig(schedule="rowmajor"), mt * 128,
                          mt * 128, kt * 128, 4, capacity=8)
    assert est.traffic_bytes == ref_est.traffic_bytes
    order = grid_schedule("rowmajor", mt, mt)
    bb = {t: 128 * 128 * 4 for t in "ABC"}
    wrong = stack_distance_traffic(order, kt, bb, capacity=2)
    assert wrong == ref_traffic(order, kt, bb, capacity=2)
    rel = abs(wrong["total_bytes"] - est.traffic_bytes) / est.traffic_bytes
    assert rel > STATIC_DRIFT_TOL
    right = stack_distance_traffic(order, kt, bb, capacity=8)
    assert right["total_bytes"] == est.traffic_bytes


@pytest.mark.parametrize("ways,hops", [(1, 1.0), (2, 1.0), (4, 1.5),
                                       (8, 2.5), (3, 1.0)])
def test_crosscheck_link_model_equals_reference(ways, hops):
    for payload in (1.0, 4096.0, 3.3e8):
        mine = crosscheck_link_model(payload, ways, hops=hops)
        _same(mine, ref_link(payload, ways, hops=hops))
        assert mine.ok


# ----------------------------------------------------------------- CLI --
@pytest.mark.parametrize("shape,dtype_bytes", [((2048, 2048, 256), 4),
                                               ((512, 384, 640), 2)])
def test_cli_sections_equal_reference(shape, dtype_bytes, tmp_path,
                                      monkeypatch):
    """``contracts``, ``schedules`` (at max grid 8) and ``winner`` under
    the reference's constants: the same JSON as the reference's CLI
    sections, winner caches in separate temporary files."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref.json"))
    m, n, k = shape
    mine = {
        "contracts": cli._candidate_section(m, n, k, dtype_bytes, hw=REF_HW),
        "schedules": cli._schedule_section(8, hw=REF_HW),
        "winner": cli._winner_section(
            m, n, k, dtype_bytes, hw=REF_HW,
            cache=TuneCache(str(tmp_path / "port.json"))),
    }
    ref = {"contracts": ref_cli._candidate_section(m, n, k, dtype_bytes),
           "schedules": ref_cli._schedule_section(8),
           "winner": ref_cli._winner_section(m, n, k, dtype_bytes)}
    assert json.loads(json.dumps(mine, default=str)) == \
        json.loads(json.dumps(ref, default=str))
    # the default f32 problem passes; at 2 bytes the reference's own
    # negative controls fail under its constants, and the port's alike
    assert all(s["ok"] for s in mine.values()) == (dtype_bytes == 4)


def test_cli_default_run_under_h100(tmp_path, monkeypatch, capsys):
    """The default run: exit 0, ``"hw": "H100"``, the three sections all
    passing, no ``hlo`` section and an ``omitted`` entry naming it and
    why; the report written to ``--out``."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    out = tmp_path / "report.json"
    assert cli.main(["--max-grid", "6", "--out", str(out)]) == 0
    assert "ok=True" in capsys.readouterr().out
    rep = json.loads(out.read_text())
    assert rep["hw"] == "H100" and rep["ok"] is True
    assert rep["vmem_per_chip"] == H100.vmem_per_chip
    assert sorted(rep["sections"]) == ["contracts", "schedules", "winner"]
    assert all(s["ok"] for s in rep["sections"].values())
    assert "hlo" not in rep["sections"]
    assert "HLO" in rep["omitted"]["hlo"]
    assert rep["sections"]["schedules"]["orders_proved"] == \
        len(SCHEDULES) * 6 * 6
    assert rep["sections"]["contracts"]["negative_controls_ok"]


def test_cli_schedules_only_and_a_failing_section(capsys, monkeypatch):
    """``--schedules-only`` prints a report with that section alone (no
    ``omitted``: nothing else was asked for); a failing section makes the
    exit status 1, the report printed all the same."""
    assert cli.main(["--schedules-only", "--max-grid", "4"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert sorted(rep["sections"]) == ["schedules"]
    assert rep["sections"]["schedules"]["orders_proved"] == \
        len(SCHEDULES) * 16
    assert "omitted" not in rep
    monkeypatch.setattr(cli, "verify_schedule",
                        lambda *a, **kw: verify_order(np.zeros((2, 2), int),
                                                      1, 2))
    assert cli.main(["--schedules-only", "--max-grid", "2"]) == 1
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] is False and rep["sections"]["schedules"]["failures"]


def test_cli_refuses_the_hlo_gate_and_bad_shapes():
    with pytest.raises(SystemExit) as err:
        cli.main(["--epilogue-gate"])
    assert err.value.code != 0 and "HLO" in str(err.value)
    with pytest.raises(SystemExit, match="MxNxK"):
        cli.main(["--shape", "12x34"])


def test_cli_runs_as_a_module(tmp_path):
    """``python -m repro_torch.analysis`` in a process of its own, as a
    user runs it."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src),
           "REPRO_TUNE_CACHE": str(tmp_path / "tune.json")}
    out = tmp_path / "r.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--max-grid", "4",
         "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(out.read_text())["ok"] is True
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--epilogue-gate"],
        env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "HLO" in bad.stderr


# --------------------------------------------------- B2's contract (H100) --
def _served():
    """(n_heads, n_kv_heads, d_head) of every arch that serves paged: the
    pure-attention archs with a decode step and no window."""
    out = set()
    for a in ARCHS:
        c = get_config(a)
        if c.has_decode and c.has_attention and not c.has_ssm \
                and c.swa_window is None:
            out.add((c.n_heads, c.n_kv_heads, c.d_head))
    return sorted(out)


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("heads", _served(), ids=lambda h: "x".join(map(str,
                                                                       h)))
def test_b2_contract_under_h100_is_its_shared_memory(heads, dtype_bytes):
    """At every served (group, d_head) and page sizes 4-64: the
    contract's size is ``attn_smem_bytes`` of the stage plan B2 launches,
    its budget the block's limit, and it passes."""
    h, hkv, dh = heads
    for ps in (4, 8, 16, 32, 64):
        spec = DecodeAttnSpec(slots=4, cache_len=4096, n_heads=h,
                              n_kv_heads=hkv, d_head=dh,
                              attn=AttnSpec(kind="paged", page_size=ps))
        rep = check_attn_contract(spec, dtype_bytes=dtype_bytes, hw=H100)
        stage = attn_stage_pages(ps, dh, dtype_bytes)
        assert rep.stats["stage_pages"] == stage
        assert rep.stats["vmem_bytes"] == attn_smem_bytes(
            ps, dh, dtype_bytes, stage, h // hkv)
        assert rep.stats["vmem_budget"] == _SMEM_LIMIT
        assert rep.ok, rep.to_dict()


def test_b2_contract_fails_past_the_limit():
    """A 256-token page of 256-wide f32 rows needs a 1 MB ring: over the
    block's limit (``vmem-budget``), and d_head 320 is past B2's rows
    (``kernel-tile``).  The other way round, 64-token pages of 128-wide
    f32 rows with 8 kv-heads: the reference's TPU grid step (all 8
    kv-heads' K and V page blocks at once, 532 KB) refuses them under
    H100's budget, while B2 (one kv-head a block, a one-page stage)
    takes them in 136 KB."""
    big = DecodeAttnSpec(slots=4, cache_len=4096, n_heads=8, n_kv_heads=8,
                         d_head=256, attn=AttnSpec(kind="paged",
                                                   page_size=256))
    rep = check_attn_contract(big, dtype_bytes=4, hw=H100)
    assert rep.codes() == {"vmem-budget"}
    assert rep.stats["vmem_bytes"] > _SMEM_LIMIT
    wide = dataclasses.replace(big, d_head=320,
                               attn=AttnSpec(kind="paged", page_size=4))
    assert "kernel-tile" in check_attn_contract(wide, dtype_bytes=2,
                                                hw=H100).codes()
    fits = dataclasses.replace(big, d_head=128,
                               attn=AttnSpec(kind="paged", page_size=64))
    rep = check_attn_contract(fits, dtype_bytes=4, hw=H100)
    assert rep.ok and rep.stats["vmem_bytes"] == 135184
    ref_sized = ref_attn_contract(
        RefAttnProblem(slots=4, cache_len=4096, n_heads=8, n_kv_heads=8,
                       d_head=128, attn=RefAttnSpec(kind="paged",
                                                    page_size=64)),
        dtype_bytes=4, hw=ref_energy.HW(**dataclasses.asdict(H100)))
    assert ref_sized.codes() == {"vmem-budget"}


@pytest.mark.parametrize("ps,heads,kv,d", [(64, 4, 2, 64), (16, 56, 8, 128),
                                           (256, 8, 8, 256), (8, 5, 2, 64)])
def test_attn_contract_under_reference_constants_equals_reference(ps, heads,
                                                                  kv, d):
    """Under the reference's constants the reference's TPU working set
    and every table check: the same report, table or not."""
    bt = np.array([[0, 1, -1, -1], [2, 2, -1, -1], [9, 3, 4, -1]])
    lengths = np.array([100, 0, 3 * ps + 1])
    for kw in ({}, dict(block_table=bt, num_pages=8, lengths=lengths)):
        mine = check_attn_contract(
            DecodeAttnSpec(slots=3, cache_len=256, n_heads=heads,
                           n_kv_heads=kv, d_head=d,
                           attn=AttnSpec(kind="paged", page_size=ps)),
            hw=REF_HW, **kw)
        ref = ref_attn_contract(
            RefAttnProblem(slots=3, cache_len=256, n_heads=heads,
                           n_kv_heads=kv, d_head=d,
                           attn=RefAttnSpec(kind="paged", page_size=ps)),
            **kw)
        _same(mine, ref)
