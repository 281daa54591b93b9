"""Shared set-up of the benchmark's tests: the checkout's root and
``src`` on the path, the ``card`` marker, and a copy of ``perfbench``
in a temporary checkout with two tiny cells that run on the CPU."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_ARCH = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                 d_ff=128, vocab=256, padded_vocab=256, rope_theta=10000.0,
                 rms_eps=1e-6, dtype="bfloat16")


def pytest_configure(config):
    import torch

    # the tiny CPU runs time their windows: keep parallel workers from
    # oversubscribing the cores
    torch.set_num_threads(min(torch.get_num_threads(), 2))
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips where there is none")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "python3 -m pytest perfbench/tests -m card")
    return torch.device("cuda")


def make_tiny_root(dest: Path) -> Path:
    """A checkout at ``dest`` holding ``BENCHMARK.json`` and
    ``perfbench`` with two more cells, ``tiny.docqa`` (a 2-layer model of
    the glm4 configuration's kind) and ``tiny.gemm`` (the study's
    variants at 2 x 64^3), each found by name like the real ones."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = dest / "perfbench"
    cfg = json.loads((pb / "configs/glm4-9b.json").read_text())
    cfg.update(name="tiny-lm", arch=dict(TINY_ARCH))
    (pb / "configs/tiny-lm.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic/docqa.json").read_text())
    tr.update(clients=4, prompts=dict(min=16, max=48, block=4, order=[0, 2, 1, 3],
                                      rotate=1), max_new=8,
              serve=dict(slots=4, cache_len=64, page_size=8, layout="paged",
                         mode="continuous", prefill_budget=16, eos_id=-1))
    (pb / "traffic/tiny-docqa.json").write_text(json.dumps(tr))
    tg = json.loads((pb / "traffic/n1024.json").read_text())
    tg.update(batch=2, n=64)
    (pb / "traffic/tiny-gemm.json").write_text(json.dumps(tg))
    b["configs"].append({"name": "tiny-lm", "source": "tests",
                         "file": "perfbench/configs/tiny-lm.json",
                         "reduced": [], "why": "CPU tests"})
    b["workloads"] += [
        {"name": "tiny.docqa", "config": "tiny-lm", "traffic": "tiny-docqa",
         "chips": 1, "why": "CPU tests"},
        {"name": "tiny.gemm", "config": "paper-sfc", "traffic": "tiny-gemm",
         "chips": 1, "why": "CPU tests"}]
    for m in b["end_to_end"] + b["per_layer"]:
        w = m.get("workloads", [])
        if "glm4-9b.docqa" in w:
            w.append("tiny.docqa")
        if "paper.n1024" in w:
            w.append("tiny.gemm")
    (dest / "BENCHMARK.json").write_text(json.dumps(b))
    return dest


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path / "checkout")
