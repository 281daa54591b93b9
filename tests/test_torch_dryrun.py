"""The port's dry-run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.launch.roofline``) against the reference's.

* Every cell of the 10 archs x 4 shapes x 2 meshes grid: the record's
  fields that need no step (``cell_record``) equal what the reference's
  ``run_cell`` writes, taken from ``repro.configs``, ``repro.models.
  SHAPES``, the reference's production mesh shapes and its per-arch
  ``grad_accum``, without lowering anything; skipped exactly where the
  reference skips, with its reason text.  A few full-size cells run
  through ``run_cell`` on the abstract mesh and write those fields.
* ``roofline_row``, ``model_flops``, ``make_table`` and ``to_markdown``
  equal the reference's on the same JSON records, the port's given the
  reference's ``TPU_V5E`` fields as an ``HW``: every number within
  1e-12 relative, every string equal.
* The CLI: ``--audit`` refuses, naming ``analysis/hlo_audit.py``; the
  roofline prints its table labelled as the H100 model's.

The step counter (``repro_torch.launch.opcount``, in the role of the
reference's ``launch/hlo.py``) and the mesh that needs no world:

* FLOPs against ``repro.launch.hlo.analyze_hlo`` of the reference's
  compiled step under ``schedule="xla"``, SMOKE qwen3-1.7b on one CPU
  device, a 4 x 32 batch.  XLA's CPU pipeline keeps every dot of these
  steps (the compiled module's dot FLOPs equal the traced program's),
  so the compiled HLO is read.  The prefill: exactly equal.  The train
  step: the port's count is the reference's plus exactly the FLOPs of
  one GEMM a layer, w1's pre-activation recomputed for silu's
  derivative (``kernels/grad.py``: the fused GEMM keeps no
  pre-activation; XLA keeps it), 2 T d d_ff a layer, 6.06 % of the
  reference's count at this size.  Both recompute the attention
  einsums under remat "dots"; no other gap; the test holds the
  difference to that one term exactly.
* A real CPU step and its meta twin give the same count, every key
  (FLOPs, traffic, GEMM shapes and routes, op census, collectives and
  memory), for every family's train step and a decode step.
* On 8 gloo ranks at the (2, 2, 2) smoke mesh: rank 0's collectives
  (``COLLECTIVES``, and each record's kind, axes, group size and
  operand bytes, in order) on an ``AbstractMesh`` with the builders'
  meta inputs equal the real sharded train steps' (pod compression
  off and on, grad_accum 2) and serve step's, exactly; the abstract
  mesh answers ``shape``, ``devices``, ``coord``, ``size``, ``index``
  and ``group`` as the real one on every rank.
* Attention on a model axis the heads do not divide runs
  sequence-parallel (8 ranks, a (2, 4) mesh, 2 kv-heads): gradients
  within 1e-5 of each leaf's largest single-device magnitude, the loss
  within 1e-5 relative, prefill logits within 1e-5 absolute (the f32
  bounds of the port's other sharded tests: summation order only).
"""

import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax

import repro.core.energy as ref_energy
import repro.launch.roofline as ref_roofline
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.launch.hlo import analyze_hlo
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import SHAPES as REF_SHAPES
from repro.models import DotEngine as RefDotEngine
from repro.models import forward as ref_forward
from repro.models import init_model as ref_init_model
from repro.models.config import ShapeSpec as RefShapeSpec
from repro.models.frontends import make_batch as ref_make_batch
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import init_opt_state as ref_init_opt_state

import _dist_ranks
from repro_torch.configs import get_smoke_config
from repro_torch.core.energy import HW
from repro_torch.distributed.ctx import AbstractMesh, spawn
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh, _placed_ranks
from repro_torch.launch.opcount import count_step, gemm_route
from repro_torch.launch.steps import abstract_train_state, make_train_step
from repro_torch.models import DotEngine, forward, init_decode_state, \
    init_model, input_specs
from repro_torch.models.config import ShapeSpec
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import decode_step
from repro_torch.optim import AdamWConfig, init_opt_state

ROOT = Path(__file__).resolve().parents[1]
REF_DRYRUN = ROOT / "src" / "repro" / "launch" / "dryrun.py"
REF_MESH = ROOT / "src" / "repro" / "launch" / "mesh.py"
REF_HW = HW(**dataclasses.asdict(ref_energy.TPU_V5E))
META_KEYS = ("arch", "shape", "mesh", "status", "chips", "mesh_shape",
             "kind", "seq_len", "global_batch", "grad_accum", "family",
             "params", "active_params")


def _ref_grad_accum() -> dict:
    """The per-arch default of the reference's ``run_cell``, read from
    its source (importing the module would set the process's
    ``XLA_FLAGS``)."""
    tree = ast.parse(REF_DRYRUN.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "llava_next_34b"
                for k in node.keys):
            return ast.literal_eval(node)
    raise AssertionError("the reference's grad_accum defaults not found")


def _ref_mesh_shapes() -> dict:
    """The reference's production meshes (``make_production_mesh``),
    from its source."""
    src = REF_MESH.read_text()
    assert "shape = (2, 16, 16) if multi_pod else (16, 16)" in src
    assert ('axes = ("pod", "data", "model") if multi_pod else '
            '("data", "model")') in src
    return {"single": {"data": 16, "model": 16},
            "multi": {"pod": 2, "data": 16, "model": 16}}


def ref_record(arch: str, shape: str, mesh_kind: str) -> dict:
    """The fields the reference's ``run_cell`` writes for a cell
    (``src/repro/launch/dryrun.py``), without lowering."""
    src = REF_DRYRUN.read_text()
    reason = 'f"not runnable for {cfg.family} (DESIGN.md §4)"'
    assert reason in src
    cfg = ref_get_config(arch)
    if shape not in cfg.runnable_shapes():
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "skipped",
                "reason": f"not runnable for {cfg.family} (DESIGN.md §4)"}
    spec = REF_SHAPES[shape]
    mesh_shape = _ref_mesh_shapes()[mesh_kind]
    return {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "ok",
            "chips": math.prod(mesh_shape.values()),
            "mesh_shape": mesh_shape, "kind": spec.kind,
            "seq_len": spec.seq_len, "global_batch": spec.global_batch,
            "grad_accum": _ref_grad_accum().get(arch, 4)
            if spec.kind == "train" else None,
            "family": cfg.family, "params": cfg.params_count(),
            "active_params": cfg.active_params_count()}


CELLS = [(a, s, m) for a in REF_ARCHS for s in REF_SHAPES
         for m in ("single", "multi")]


def test_the_grid_is_the_references():
    from repro_torch.configs import ARCHS
    from repro_torch.models import SHAPES

    assert sorted(ARCHS) == sorted(REF_ARCHS)
    assert list(SHAPES) == list(REF_SHAPES)
    assert len(CELLS) == 80
    assert dryrun.DEFAULT_GRAD_ACCUM == _ref_grad_accum()


@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=["-".join(c) for c in CELLS])
def test_cell_record_equals_the_references(arch, shape, mesh):
    got = dryrun.cell_record(arch, shape, mesh)
    want = ref_record(arch, shape, mesh)
    if want["status"] == "skipped":
        assert got == want
    else:
        assert {k: got[k] for k in META_KEYS} == want


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen3_1_7b", "decode_32k", "single"),
    ("mamba2_780m", "long_500k", "multi"),
    ("hubert_xlarge", "decode_32k", "multi"),
    ("qwen3_1_7b", "long_500k", "single"),
], ids=lambda x: x)
def test_run_cell_writes_the_record(tmp_path, arch, shape, mesh):
    """A full-size cell's step runs on the abstract mesh, on meta
    tensors; the written record carries the reference's fields, the
    counter's, and names what has no counterpart."""
    rec = dryrun.run_cell(arch, shape, mesh, str(tmp_path))
    on_disk = json.loads(
        (tmp_path / f"{arch}__{shape}__{mesh}.json").read_text())
    assert on_disk == json.loads(json.dumps(rec))
    want = ref_record(arch, shape, mesh)
    if want["status"] == "skipped":
        assert rec == want
        return
    assert {k: rec[k] for k in META_KEYS} == want
    w = rec["weighted"]
    assert w["flops_per_chip"] > 0 and w["traffic_bytes_per_chip"] > 0
    assert w["traffic_bytes_upper_per_chip"] > 0
    assert set(rec["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes"}
    assert "cost_analysis" in rec["omitted"] and "t_compile_s" in \
        rec["omitted"] and "weighted.whiles" in rec["omitted"]
    assert sum(v["launches"] for k, v in rec["kernels"].items()
               if k.startswith("b1")) > 0
    assert rec["t_lower_s"] >= 0


# ------------------------------------------------------------ roofline --
def _records():
    """Records covering every bottleneck and kind, in the dry-run's
    format (numbers of the order the sweep writes)."""
    out = []
    for i, (kind, shape, flops, traffic, coll) in enumerate([
            ("train", "train_4k", 5.5e13, 5.1e11, 3.0e8),
            ("train", "train_4k", 1.0e12, 9.0e12, 1.0e7),
            ("prefill", "prefill_32k", 3.0e13, 3.9e11, 9.0e12),
            ("decode", "decode_32k", 5.5e9, 5.9e9, 4.0e6),
            ("decode", "long_500k", 1.4e9, 1.0e6, 0.0)]):
        for mesh, chips in (("single", 256), ("multi", 512)):
            coll_rec = {"total_bytes": coll * (1 + i), "total_count": 3}
            out.append({
                "arch": f"arch{i}", "shape": shape, "mesh": mesh,
                "status": "ok", "chips": chips, "kind": kind,
                "seq_len": REF_SHAPES[shape].seq_len,
                "global_batch": REF_SHAPES[shape].global_batch,
                "grad_accum": 4 if kind == "train" else None,
                "active_params": 1.7e9 * (i + 1),
                "weighted": {"flops_per_chip": flops / chips * 256,
                             "traffic_bytes_per_chip": traffic,
                             "collectives": coll_rec}})
    return out


def _assert_rows_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], float):
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k
        else:
            assert got[k] == want[k], k


def test_roofline_row_and_model_flops_equal_the_references():
    seen = set()
    for rec in _records():
        assert roofline.model_flops(rec) == pytest.approx(
            ref_roofline.model_flops(rec), rel=1e-12)
        got = roofline.roofline_row(rec, REF_HW)
        want = ref_roofline.roofline_row(rec, ref_energy.TPU_V5E)
        _assert_rows_equal(got, want)
        seen.add(want["bottleneck"])
    assert seen >= {"compute", "memory", "collective"}


def test_make_table_and_markdown_equal_the_references(tmp_path):
    for i, rec in enumerate(_records()):
        (tmp_path / f"r{i}.json").write_text(json.dumps(rec))
    (tmp_path / "skip.json").write_text(json.dumps(
        {"arch": "x", "shape": "decode_32k", "mesh": "single",
         "status": "skipped", "reason": "r"}))
    for mesh in ("single", "multi"):
        got = roofline.make_table(str(tmp_path), mesh, hw=REF_HW)
        want = ref_roofline.make_table(str(tmp_path), mesh)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            _assert_rows_equal(g, w)
        assert roofline.to_markdown(got) == ref_roofline.to_markdown(want)


def test_roofline_defaults_to_the_h100_and_labels_it(tmp_path):
    from repro_torch.core.energy import H100

    rec = _records()[0]
    (tmp_path / "r.json").write_text(json.dumps(rec))
    row = roofline.roofline_row(rec)
    assert row == roofline.roofline_row(rec, H100)
    assert row["t_compute"] == pytest.approx(
        rec["weighted"]["flops_per_chip"] / H100.peak_flops, rel=1e-12)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--out",
         str(tmp_path), "--markdown"], capture_output=True, text=True,
        env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "h100" in lines[0] and "not measured" in lines[0]
    assert lines[1].startswith("| arch | shape |")
    assert lines[3].startswith(f"| {rec['arch']} | {rec['shape']} |")


# ----------------------------------------------------------------- CLI --
def test_audit_is_refused_naming_the_missing_counterpart():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3_1_7b", "--shape", "decode_32k", "--audit"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert "analysis/hlo_audit.py" in out.stderr
    with pytest.raises(SystemExit, match="hlo_audit"):
        dryrun.run_cell("qwen3_1_7b", "decode_32k", "single", "/nonexistent",
                        audit=True)


def test_cli_writes_one_record_per_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite_moe_1b_a400m", "--shape", "decode_32k", "--mesh", "both",
         "--out", str(tmp_path), "--tag", "t"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == ["granite_moe_1b_a400m__decode_32k__multi__t.json",
                     "granite_moe_1b_a400m__decode_32k__single__t.json"]
    for name in names:
        rec = json.loads((tmp_path / name).read_text())
        assert rec["status"] == "ok"
        assert rec["weighted"]["collectives"]["total_count"] > 0


# ------------------------------------------------------- the counter --
ARCH = "qwen3_1_7b"
B, S = 4, 32


# ------------------------------------------------- against analyze_hlo --
@pytest.fixture(scope="module")
def reference():
    """The reference's compiled prefill (forward) and train step under
    ``schedule="xla"``, read by ``analyze_hlo``, and its weights and
    batch as numpy."""
    cfg = ref_smoke(ARCH)
    p = ref_init_model(cfg, jax.random.PRNGKey(0), moe_pad=1)
    batch = ref_make_batch(cfg, RefShapeSpec("oc", S, B, "train"), seed=1)
    eng = RefDotEngine(schedule="xla")
    icfg = dataclasses.replace(cfg, remat=False)
    pb = {k: v for k, v in batch.items() if k not in ("labels", "loss_mask")}
    pre = jax.jit(lambda p, b: ref_forward(p, icfg, b, eng)[0]).lower(
        p, pb).compile().as_text()
    train = jax.jit(ref_make_train_step(cfg, None, RefAdamWConfig(),
                                        engine=eng)).lower(
        p, ref_init_opt_state(p), batch).compile().as_text()
    return {"prefill": analyze_hlo(pre)["flops"],
            "train": analyze_hlo(train)["flops"],
            "params": jax.tree.map(np.asarray, p),
            "batch": {k: np.asarray(v) for k, v in batch.items()}}


def _port_inputs(reference):
    cfg = get_smoke_config(ARCH)
    params = params_from_jax(reference["params"], device="cpu")
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in reference["batch"].items()}
    return cfg, params, batch


def test_prefill_flops_equal_analyze_hlo(reference):
    cfg, params, batch = _port_inputs(reference)
    icfg = dataclasses.replace(cfg, remat=False)

    def prefill(p, b):
        with torch.no_grad():
            return forward(p, icfg, b, DotEngine())[0]

    got = count_step(prefill, params, {"tokens": batch["tokens"]})
    assert got["flops"] == reference["prefill"] == 22544384.0
    # every projection through B1's tile path (M = 128 rows), the
    # attention einsums through torch
    assert set(got["kernels"]) == {"b1_tile", "torch"}
    assert got["kernels"]["b1_tile"]["launches"] == 7 * cfg.n_layers + 1


def test_train_flops_equal_analyze_hlo_plus_the_recompute(reference):
    cfg, params, batch = _port_inputs(reference)
    step = make_train_step(cfg, None, AdamWConfig())
    got = count_step(step, params, init_opt_state(params), batch)
    recompute = cfg.n_layers * 2.0 * B * S * cfg.d_model * cfg.d_ff
    assert got["flops"] - recompute == reference["train"] == 69206016.0
    assert recompute / reference["train"] == pytest.approx(0.0606, abs=1e-4)
    assert got["kernels"]["b1_tile"]["launches"] == 22 * cfg.n_layers + 3


# ------------------------------------------------------ meta == real --
TWIN_ARCHS = ["qwen3_1_7b", "granite_moe_1b_a400m", "mamba2_780m",
              "hymba_1_5b", "hubert_xlarge", "llava_next_34b"]


@pytest.mark.parametrize("arch", TWIN_ARCHS)
def test_train_step_count_equals_its_meta_twin(arch):
    cfg = get_smoke_config(arch)
    spec = ShapeSpec("oc_train", 32, 4, "train")
    step = make_train_step(cfg, None, AdamWConfig())
    p_m, o_m = abstract_train_state(cfg, moe_pad=1)
    b_m = input_specs(cfg, spec)
    meta = count_step(step, p_m, o_m, b_m)
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu",
                        moe_pad=1)
    g = torch.Generator().manual_seed(1)
    batch = {k: (torch.randint(0, cfg.vocab, v.shape, generator=g,
                               dtype=v.dtype) if not v.is_floating_point()
                 else torch.randn(v.shape, generator=g).to(v.dtype))
             for k, v in b_m.items()}
    if "loss_mask" in batch:
        batch["loss_mask"] = torch.ones_like(batch["loss_mask"])
    real = count_step(step, params, init_opt_state(params), batch)
    assert real == meta
    assert real["flops"] > 0 and real["memory"]["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "hymba_1_5b"])
def test_decode_step_count_equals_its_meta_twin(arch):
    cfg = get_smoke_config(arch)

    def step(p, st, toks, pos):
        with torch.no_grad():
            return decode_step(p, cfg, st, toks, pos, DotEngine())

    meta = count_step(step, init_model(cfg, device="meta"),
                      init_decode_state(cfg, 4, 32, device="meta"),
                      torch.empty(4, 1, dtype=torch.int32, device="meta"),
                      torch.empty((), dtype=torch.int32, device="meta"))
    real = count_step(step, init_model(cfg, torch.Generator().manual_seed(0),
                                       device="cpu"),
                      init_decode_state(cfg, 4, 32, device="cpu"),
                      torch.ones(4, 1, dtype=torch.int32),
                      torch.tensor(3, dtype=torch.int32))
    assert real == meta
    # M = 4 rows: every projection on B1's rows path
    assert real["kernels"]["b1_rows"]["launches"] > 0


def test_gemm_routes_follow_the_kernels_rules():
    bf, f32 = torch.bfloat16, torch.float32
    assert gemm_route("morton", 4, 2048, 2048, 128, bf) == "b1_rows"
    assert gemm_route("morton", 9, 2048, 2048, 128, bf) == "b1_tile"
    assert gemm_route("morton", 4, 2048, 2047, 128, f32) == "b1_tile"
    assert gemm_route("morton", 4, 2048, 2048, 64, bf) == "b1_tile"
    assert gemm_route("hilbert", 4, 2048, 2048, 128, bf, "b3") == "b3"
    assert gemm_route("xla", 4, 2048, 2048, 128, bf) == "xla"


# ------------------------------------------------------- the meshes --
def test_abstract_production_meshes_are_the_references():
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data", "model"))):
        for order in ("rowmajor", "hilbert"):
            m = make_production_mesh(multi_pod=multi, device_order=order,
                                     abstract=True, rank=37)
            assert isinstance(m, AbstractMesh) and m.rank == 37
            assert tuple(m.shape.values()) == shape and m.axis_names == axes
            assert m.devices.reshape(-1).tolist() == _placed_ranks(
                shape, axes, order, 256)
            where = np.argwhere(m.devices == 37)[0]
            assert tuple(m.coord.values()) == tuple(where)
            assert m.group("model").members == tuple(
                m.devices[tuple(where[:-1])].tolist())
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()


def test_abstract_collectives_give_the_result_shapes():
    from repro_torch.distributed import ctx as dctx

    m = AbstractMesh((2, 4), ("data", "model"), rank=5)
    t = torch.empty(8, 6, dtype=torch.bfloat16, device="meta")
    dctx.COLLECTIVES.clear()
    with dctx.record_collectives() as log:
        assert m.all_reduce(t, "model") is t
        g = m.all_gather(t, ("data", "model"), 1)
        a = m.all_to_all(t, "model", 0, 1)
        s = m.shift(t, "data")
        m.send(t, 0)
        r = m.recv(t, 0)
    assert g.shape == (8, 48) and a.shape == (2, 24) and s.shape == t.shape
    assert r.shape == t.shape and g.dtype == torch.bfloat16
    assert dict(dctx.COLLECTIVES) == {"all_reduce_sum": 1, "all_gather": 1,
                                      "all_to_all": 1, "send_recv": 2}
    assert [(x["kind"], x["size"], x["bytes"]) for x in log] == [
        ("all_reduce_sum", 4, 96), ("all_gather", 8, 96),
        ("all_to_all", 4, 96), ("send_recv", 2, 96), ("send_recv", 2, 96)]


@pytest.fixture(scope="module")
def collectives():
    return spawn(_dist_ranks.count_collectives_ranks, 8, ARCH)


@pytest.mark.parametrize("run", ["train pod_compress=False",
                                 "train pod_compress=True", "serve"])
def test_abstract_mesh_collectives_equal_the_real_steps(collectives, run):
    real, ab = collectives["real"][run], collectives["abstract"][run]
    assert real["counter"] and real["counter"] == ab["counter"]
    assert real["log"] == ab["log"]
    assert real["collectives"] == ab["collectives"]


def test_abstract_mesh_answers_as_the_real_one(collectives):
    assert collectives["mesh_answers_equal"] == [True] * 8


# ------------------------------------------ sequence-parallel attention --
@pytest.fixture(scope="module")
def seq_parallel():
    return spawn(_dist_ranks.seq_parallel_ranks, 8, ARCH)


def test_seq_parallel_attention_equals_one_device(seq_parallel):
    got = seq_parallel
    cfg = get_smoke_config(ARCH)
    assert cfg.n_kv_heads % 4    # the heads do not divide the model axis
    assert abs(got["loss"] - got["loss_single"]) <= \
        1e-5 * abs(got["loss_single"])
    for name, g, w in zip(got["names"], got["grads"], got["grads_single"]):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), name
    np.testing.assert_allclose(got["logits"], got["logits_single"],
                               atol=1e-5, rtol=0)
