"""What the benchmark may import, and what a run without a card does."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from conftest import ROOT

PB = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``repro_torch`` is not ``repro``."""
    for path in PB.rglob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").glob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert tops <= {"__future__", "contextlib", "math", "torch"}, \
            (path, tops)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from perfbench.run import forbidden_modules

    for name in ("repro_torch", "repro_torch.models", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, object())
    assert "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.kernels", object())
    assert "repro" in forbidden_modules()


def test_a_run_without_a_card_fails_and_reports_nothing(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cell in ("paper.n1024", "glm4-9b.docqa"):
        p = subprocess.run(
            [sys.executable, str(PB / "run.py"), "--workload", cell,
             "--seed", "2147483649", "--seconds", "1", "--trace", "0"],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=120)
        assert p.returncode != 0
        for line in p.stdout.splitlines():
            try:
                json.loads(line)
            except ValueError:
                continue
            raise AssertionError(f"a result was printed: {line}")
        assert "no CUDA device" in p.stderr
