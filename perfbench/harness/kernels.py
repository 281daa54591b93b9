"""Which device kernels are the port's hand-written ones, by name.

``sfc_matmul.cu`` holds B1 (one GEMM: ``sfc_matmul_rows_bf16``,
``sfc_matmul_rows_f32``, ``sfc_matmul_tile``) and B3 (the same templates
instantiated with ``kBatched = true``, their last template argument);
``paged_attention.cu`` holds B2 (``paged_attn_kernel``).  A profiler
names a kernel by its demangled signature, e.g.
``void (anonymous namespace)::sfc_matmul_tile<float, true, true>(float
const*, ...)``.
"""
from __future__ import annotations

__all__ = ["template_args", "is_b1", "is_b2", "is_b3"]

_SFC = ("sfc_matmul_rows_bf16", "sfc_matmul_rows_f32", "sfc_matmul_tile")


def _base(name: str) -> str:
    """The name without return type, namespace or parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].strip().removeprefix("void ").strip()


def template_args(name: str) -> list[str]:
    """The top-level template arguments of a kernel's name."""
    base = _base(name)
    if "<" not in base:
        return []
    inner = base[base.index("<") + 1:base.rindex(">")]
    args, depth, cur = [], 0, ""
    for ch in inner:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        if ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
        else:
            cur += ch
    args.append(cur.strip())
    return args


def _sfc_batched(name: str) -> bool | None:
    base = _base(name)
    if base.split("<", 1)[0] not in _SFC:
        return None
    args = template_args(name)
    return bool(args) and args[-1] == "true"


def is_b1(name: str) -> bool:
    return _sfc_batched(name) is False


def is_b3(name: str) -> bool:
    return _sfc_batched(name) is True


def is_b2(name: str) -> bool:
    return _base(name).split("<", 1)[0] == "paged_attn_kernel"
