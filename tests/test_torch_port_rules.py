"""Rules of the PyTorch port that hold on any machine:

* ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of ``repro``;
* on a machine without CUDA, asking for ``cuda`` raises: entry points
  never drop to the CPU, the kernel wrappers never run their plain
  version for a non-CPU tensor, nothing in a kernel wrapper catches a
  launch error, and a missing ``nvcc`` raises instead of switching the
  path;
* ``chip_smoke.py`` exits non-zero and prints no result without a card,
  and in a directory that holds nothing else of the repository;
* ``NvmlBackend()`` raises where the NVML library is missing: the card's
  energy readings never degrade to another backend inside it;
* ``examples_torch/`` imports neither ``jax`` nor ``repro`` either;
  outside ``count_step`` a meta tensor still raises in ``ops.sfc_matmul``
  (the counter's hook is taken only inside it); the dry-run, host-only
  by design, neither names nor initialises ``torch.cuda``;
* a pytest-xdist worker runs its share of the cores, ``max(1, cores //
  workers)`` intra-op threads, and hands it to the processes it spawns
  (the root ``conftest.py``); a run in one process is left as it is.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

from repro_torch import device as device_mod
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
from repro_torch.kernels import ops, paged_attention, sfc_matmul, \
    sfc_matmul_cached
from repro_torch.kernels.sfc_matmul import sfc_matmul_batched_cuda, \
    sfc_matmul_cuda
from repro_torch.kernels.sfc_matmul_cached import sfc_matmul_cached as \
    sfc_matmul_cached_fn
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import init_model

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "examples_torch").glob("*.py"))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_source_imports_no_jax_and_no_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_every_port_module_loads_no_jax_or_reference():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device("cuda")
    cfg = get_smoke_config("qwen3_1_7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(cfg)
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(cfg, params)
    assert device_mod.resolve_device("cpu").type == "cpu"


def test_wrappers_take_the_plain_version_only_on_cpu():
    a = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="runs on cuda"):
        sfc_matmul_cuda(a, torch.zeros(8, 4, device="meta"))
    q = torch.zeros(2, 4, 8, device="meta")
    pages = torch.zeros(3, 4, 2, 8, device="meta")
    tab = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="runs on cuda"):
        paged_decode_attention_cuda(q, pages, pages, tab, 1)


@pytest.mark.parametrize("wrapper,shapes", [
    (sfc_matmul_batched_cuda, ((2, 4, 8), (2, 8, 16))),
    (sfc_matmul_cached_fn, ((128, 128), (128, 128))),
    (ops.sfc_matmul_batched, ((2, 3, 4, 8), (2, 3, 8, 16))),
], ids=["sfc_matmul_batched_cuda", "sfc_matmul_cached", "ops_batched"])
def test_new_wrappers_take_the_plain_version_only_on_cpu(wrapper, shapes):
    a = torch.zeros(*shapes[0], device="meta")
    b = torch.zeros(*shapes[1], device="meta")
    with pytest.raises(ValueError, match="runs on cuda"):
        wrapper(a, b)


@pytest.mark.parametrize("module", [sfc_matmul, sfc_matmul_cached,
                                    paged_attention, ops, _build],
                         ids=lambda m: m.__name__)
def test_kernel_wrappers_catch_no_launch_error(module):
    """No try/except in a wrapper module: a failed launch or build
    reaches the caller, and nothing switches to the plain version."""
    tree = ast.parse(Path(module.__file__).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("sfc_matmul", {})
    assert not list(tmp_path.iterdir())


def test_build_keys_on_the_sources():
    paths = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert len(set(paths.values())) == len(_build.SOURCES)
    for name, path in paths.items():
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert (_build.CSRC / f"{name}.cu").exists()
    with pytest.raises(ValueError, match="unknown kernel source"):
        _build.build(("nope",))


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""     # no card, even on a GPU machine
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=120)


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    here = _run_smoke(ROOT)
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run_smoke(tmp_path)
    for out in (here, alone):
        assert out.returncode != 0
        for line in out.stdout.splitlines():
            try:
                result = json.loads(line)
            except ValueError:
                continue
            assert "ok" not in result, out.stdout


def test_nvml_backend_raises_without_the_library(monkeypatch):
    """The constructor raises (the library cannot load) and holds no
    try/except: a missing library never degrades into a backend that
    reads nothing.  available() reports it."""
    from repro_torch.power import backends

    monkeypatch.setattr(backends, "NVML_LIBRARY", "libnvidia-ml-missing.so.1")
    with pytest.raises(OSError):
        backends.NvmlBackend()
    assert not backends.NvmlBackend.available()
    tree = ast.parse(Path(backends.__file__).read_text())
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "NvmlBackend")
    init = next(n for n in cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__")
    assert not [n for n in ast.walk(init) if isinstance(n, ast.Try)]


def test_chip_smoke_prints_no_json_line_without_a_card():
    """Without a card no phase runs: no line of the result (kernels,
    serve_modes, study_energy, tuner, ok) is printed, and nothing of the
    NVML phase."""
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert not [line for line in out.stdout.splitlines()
                if line.startswith("{")]
    assert "[nvml]" not in out.stdout


def test_gemm_hook_is_taken_only_inside_count_step():
    from repro_torch.launch.opcount import count_step

    a = torch.zeros(4, 8, device="meta")
    b = torch.zeros(8, 4, device="meta")
    for fn, x, y in ((ops.sfc_matmul, a, b),
                     (ops.sfc_matmul_batched, a[None], b[None])):
        with pytest.raises(ValueError, match="runs on cuda"):
            fn(x, y)
        count = count_step(fn, x, y)
        # N = 4 is no multiple of 8: B1's tile path
        assert count["kernels"] == {
            "b1_tile" if fn is ops.sfc_matmul else "b3":
            {"launches": 1, "flops": 2.0 * 4 * 8 * 4}}
        with pytest.raises(ValueError, match="runs on cuda"):
            fn(x, y)
    assert ops.gemm_counter is None


DRYRUN_FILES = [PORT / "launch" / n
                for n in ("dryrun.py", "opcount.py", "roofline.py")]


def test_dryrun_touches_no_cuda(tmp_path):
    """The dry-run's modules name no ``torch.cuda``, and a cell run with
    no card visible leaves CUDA uninitialised."""
    for path in DRYRUN_FILES:
        tree = ast.parse(path.read_text())
        bad = [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
               and n.attr == "cuda" and isinstance(n.value, ast.Name)
               and n.value.id == "torch"]
        assert not bad, path.name
    code = ("import sys, torch\n"
            "from repro_torch.launch import dryrun\n"
            f"r = dryrun.run_cell('qwen3_1_7b', 'decode_32k', 'single', "
            f"{str(tmp_path)!r})\n"
            "print(r['status'], torch.cuda.is_initialized())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["ok", "False"]


def test_this_xdist_worker_runs_its_share_of_the_cores():
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        pytest.skip("not a pytest-xdist worker")
    workers = int(os.environ["PYTEST_XDIST_WORKER_COUNT"])
    assert torch.get_num_threads() == max(1, os.cpu_count() // workers)


@pytest.mark.parametrize("workers", [None, 3, 64])
def test_root_conftest_gives_a_worker_its_share(workers):
    """The root ``conftest.py`` loaded in a fresh process, as an xdist
    worker of ``workers`` loads it (None: no worker): the worker's
    threads and what it hands to its children, or nothing touched."""
    keys = ("PYTEST_XDIST_WORKER", "PYTEST_XDIST_WORKER_COUNT",
            "OMP_NUM_THREADS", "MKL_NUM_THREADS")
    env = {k: v for k, v in os.environ.items() if k not in keys}
    if workers is not None:
        env.update(PYTEST_XDIST_WORKER="gw0",
                   PYTEST_XDIST_WORKER_COUNT=str(workers))
    code = ("import importlib.util, os, sys\n"
            f"spec = importlib.util.spec_from_file_location("
            f"'root_conftest', {str(ROOT / 'conftest.py')!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "loaded = 'torch' in sys.modules\n"
            "import torch\n"
            "print(loaded, torch.get_num_threads(),"
            " os.environ.get('OMP_NUM_THREADS'),"
            " os.environ.get('MKL_NUM_THREADS'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded, threads, omp, mkl = out.stdout.split()
    if workers is None:
        assert (loaded, omp, mkl) == ("False", "None", "None")
    else:
        share = str(max(1, os.cpu_count() // workers))
        assert (loaded, threads, omp, mkl) == ("True", share, share, share)
