"""The port's examples (``examples_torch/``) run on the CPU with
``--device cpu`` at tiny settings and exit 0; each prints its times
and rates labelled as measured on the named device or as the H100
model's."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "quickstart": [],
    "serve_lm": ["--requests", "2", "--max-new", "3", "--layout", "paged"],
    "train_lm": ["--steps", "1", "--batch", "1", "--seq", "16"],
    "sfc_study": [],
}
LABELS = {"quickstart": ("measured on cpu", "model, not measured"),
          "serve_lm": ("on cpu",),
          "train_lm": ("on cpu",),
          "sfc_study": ("model, not measured",)}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TUNE_CACHE=str(tmp_path / "tune.json"),
               TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / f"{name}.py"),
         "--device", "cpu", *EXAMPLES[name]],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    for label in LABELS[name]:
        assert label in out.stdout, out.stdout[-2000:]
