"""The closed-form counts against values worked by hand, and once
against the program's own GEMM counter at a small shape."""
from __future__ import annotations

import json

import pytest
from conftest import ROOT, TINY_ARCH

from perfbench.harness import flops as F
from perfbench.harness.peaks import BF16_FLOPS, F32_FLOPS, HBM_BYTES_S

GLM = json.loads((ROOT / "perfbench/configs/glm4-9b.json").read_text())["arch"]


def test_glm4_parameters_by_hand():
    # per layer: q 4096x4096, k and v 4096x256, o 4096x4096, w1 and w3
    # 4096x13696, w2 13696x4096
    per_layer = 2 * 4096 * 4096 + 2 * 4096 * 256 + 3 * 4096 * 13696
    assert per_layer == 203_948_032
    assert F.nonembed_params(GLM) == 40 * per_layer == 8_157_921_280
    assert F.head_shape(GLM) == (4096, 151552)


def test_glm4_token_flops_by_hand():
    # a decoded token at 1000 keys: projections, head, attention
    want = 2 * 8_157_921_280 + 2 * 4096 * 151552 + 4 * 1000 * 128 * 32 * 40
    assert want == 18_212_716_544
    assert F.token_flops(GLM, 1000, head=True) == want
    # a prefilled token computes no logits
    assert F.token_flops(GLM, 1000, head=False) == want - 2 * 4096 * 151552


def test_glm4_kv_bytes_and_least_times_by_hand():
    # K and V, 2 kv-heads of 128, bf16, 40 layers, 1000 keys
    assert F.kv_bytes(GLM, 1000, 2) == 2 * 1000 * 2 * 128 * 2 * 40
    # a decode step of 8 rows streams every weight once: bound by bytes
    w_bytes = 2 * (8_157_921_280 + 4096 * 151552)
    io = 8 * 2 * sum(k + n for _, k, n in F.projections(GLM)) * 40 \
        + 8 * (2 * 4096 + 4 * 151552)
    assert F.rows_least_s(GLM, 8, True, 2, BF16_FLOPS) == pytest.approx(
        (w_bytes + io) / HBM_BYTES_S, rel=1e-12)
    # a 512-row chunk: q, o and the MLP bound by operations, the narrow
    # k and v (4096 x 256) by bytes
    ops = 2 * 512 * (2 * 4096 * 4096 + 3 * 4096 * 13696) / BF16_FLOPS
    kv = 2 * (512 * 4096 + 4096 * 256 + 512 * 256) * 2 / HBM_BYTES_S
    assert 2 * 512 * 4096 * 256 / BF16_FLOPS < kv / 2
    assert F.rows_least_s(GLM, 512, False, 2, BF16_FLOPS) == pytest.approx(
        40 * (ops + kv), rel=1e-12)


def test_b3_counts_by_hand():
    assert F.bmm_flops(2, 4096) == 2 * 2 * 4096 ** 3 == 274_877_906_944
    assert F.bmm_bytes(2, 4096, 4) == 12 * 2 * 4096 ** 2 == 402_653_184
    assert F.bmm_least_s(2, 4096, 4, F32_FLOPS) == pytest.approx(
        274_877_906_944 / 67e12, rel=1e-12)
    assert F.bmm_least_s(8, 1024, 4, F32_FLOPS) == pytest.approx(
        2 * 8 * 1024 ** 3 / 67e12, rel=1e-12)


def test_gemm_least_time_takes_the_larger_bound():
    # 1 x 4096 x 4096 bf16: bytes bound; 4096^3: operations bound
    assert F.gemm_least_s(1, 4096, 4096, 2, 2, BF16_FLOPS) == pytest.approx(
        (4096 + 4096 * 4096 + 4096) * 2 / HBM_BYTES_S)
    assert F.gemm_least_s(4096, 4096, 4096, 2, 2, BF16_FLOPS) == \
        pytest.approx(2 * 4096 ** 3 / BF16_FLOPS)
    assert F.gemm_least_s(0, 4096, 4096, 2, 2, BF16_FLOPS) == 0.0


def test_decode_gemm_flops_match_the_programs_counter():
    """Cross-check only: the program's dry-run counter, over one decode
    step of the tiny model on the CPU, counts the same GEMM operations
    as the closed form for every row of the step."""
    torch = pytest.importorskip("torch")
    from repro_torch.launch.opcount import count_step
    from repro_torch.models import decode_step, init_decode_state
    from repro_torch.models.config import ArchConfig

    from perfbench.drivers.serve import make_weights

    a = dict(TINY_ARCH)
    cfg = ArchConfig(name="tiny", family="dense", n_layers=a["n_layers"],
                     d_model=a["d_model"], vocab=a["vocab"],
                     n_heads=a["n_heads"], n_kv_heads=a["n_kv_heads"],
                     d_head=a["d_head"], d_ff=a["d_ff"],
                     param_dtype="float32", act_dtype="float32")
    a["dtype"] = "float32"
    w = make_weights(a, 3, torch.device("cpu"))
    rows = 4
    st = init_decode_state(cfg, rows, 32, device="cpu")
    toks = torch.zeros((rows, 1), dtype=torch.int64)
    rec = count_step(decode_step, w, cfg, st, toks, 0)
    gemm = sum(v["flops"] for k, v in rec["kernels"].items()
               if k.startswith("b1"))
    d, v = F.head_shape(a)
    assert gemm == rows * (2 * F.nonembed_params(a) + 2 * d * v)
