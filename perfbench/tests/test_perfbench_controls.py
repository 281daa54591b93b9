"""The controls of ``correct``, at each cell's own size, on the card.

The control is the plain reference put in the program's place in the
nearest precision below the configuration's: TF32 for the study's f32
GEMMs, fp8 (e4m3, scaled per row and column) for the bf16 model.  It
goes through the cell's own ``checks`` and must come out not correct on
every seed, while the program comes out correct.
These tests need the card and skip without one:

    python3 -m pytest perfbench/tests -m card

(the serving cell runs its window once a seed, about two minutes each).
"""
from __future__ import annotations

import pytest
from conftest import ROOT

from perfbench.harness.cell import resolve_cell

SEEDS = (2147483701, 2147483702, 2147483703)


@pytest.fixture
def on_card(card):
    import torch

    from perfbench.run import _paths

    _paths()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


@pytest.mark.card
@pytest.mark.parametrize("cell", ["paper.n4096", "paper.n1024"])
def test_tf32_control_fails_the_study_limit(on_card, cell):
    c = resolve_cell(cell, ROOT)
    for seed in SEEDS:
        out = c.driver.control(c, seed)
        assert out["program_correct"] and not out["control_correct"], out


@pytest.mark.card
def test_fp8_control_fails_the_serving_limit(on_card):
    c = resolve_cell("glm4-9b.docqa", ROOT)
    for seed in SEEDS:
        out = c.driver.control(c, seed, 51.0)
        assert out["requests"] > 0, out
        assert out["program_correct"] and not out["control_correct"], out


@pytest.mark.parametrize("cell", ["tiny.docqa", "tiny.gemm"])
def test_controls_go_through_the_cells_checks(tiny_root, cell):
    """On the CPU (where TF32 rounds nothing) the control path runs end
    to end through ``checks`` and the program comes out correct."""
    c = resolve_cell(cell, tiny_root)
    out = c.driver.control(c, 2147483659, 4.0, device="cpu")
    assert out["program_correct"], out
    assert isinstance(out["control_correct"], bool)
    if cell == "tiny.docqa":
        assert out["requests"] > 0
        assert out["control_fp8"]["tokens"] == out["program"]["tokens"] > 0
