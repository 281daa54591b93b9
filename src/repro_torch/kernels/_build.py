"""Build and bind the CUDA kernels: ``nvcc`` by hand into one shared
library per source, with a plain C interface, loaded through ``ctypes``.

* Sources come only from ``kernels/csrc/``.  Each ``<name>.cu`` builds
  into ``<build dir>/<name>-<hash>.so``, keyed on a hash of the source,
  the shared headers and the flags, so a changed source rebuilds and an
  unchanged one is reused.
* The build directory is ``build/repro_torch_kernels/`` at the root of
  the checkout (``REPRO_TORCH_BUILD_DIR`` overrides it).
* Nothing is built or loaded when a module is imported: a wrapper calls
  :func:`load` on its first launch, and :func:`build` starts one
  ``nvcc`` per missing library, all at once.
* A missing ``nvcc`` or a failed build raises.  Nothing here switches a
  caller to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("sfc_matmul", "paged_attention", "sfc_matmul_cached")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> checkout root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and DEFAULT_NVCC.exists():
        path = str(DEFAULT_NVCC)
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels cannot be built on this "
            "machine (CUDA tensors need the kernels; CPU tensors take "
            "the plain versions)")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Build every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns the
    seconds each build took (0.0 for one already built).  The
    ``-Xptxas -v`` report of each build is kept beside its library as
    ``<lib>.log``."""
    for name in names:
        if name not in SOURCES:
            raise ValueError(f"unknown kernel source {name!r}")
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = path.with_suffix(".log").open("w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log, tmp,
                       path)
    failed = []
    while procs:
        for name in [n for n, p in procs.items() if p[0].poll() is not None]:
            proc, log, tmp, path = procs.pop(name)
            secs[name] = time.perf_counter() - t0
            log.close()
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                              f"{path.with_suffix('.log').read_text()}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, path)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return secs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``name`` (built on first use), with each
    function in ``signatures`` given its ``(argtypes, restype)``."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _LIBS[name] = lib
    return lib
