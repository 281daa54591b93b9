"""What ``nvcc`` made of a kernel source: its ``-Xptxas -v`` report and
a summary of one kernel's SASS.  Needs the CUDA toolkit (``nvcc``,
``cuobjdump``, ``cu++filt``); run on the machine with the card:

    python -m repro_torch.kernels.sass sfc_matmul \\
        --kernel 'sfc_matmul_rows<__nv_bfloat16, 4, false>' --out sass.txt

It builds the library (:func:`repro_torch.kernels._build.build`), prints
registers, spills and shared memory per kernel (demangled), and for
each kernel whose name contains ``--kernel``: its instruction mix and
every loop (a backward branch) as the sequence of its global loads
(``LDG``), shared loads (``LDS``), barriers and runs of ``FFMA``, so one
can read whether loads are sent back to back before their first use.
``--out`` keeps the whole disassembly.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

from repro_torch.kernels import _build

__all__ = ["parse_ptxas", "ptxas_report", "disassemble", "summarize"]


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(path).exists():
        raise RuntimeError(f"{name} not found (CUDA toolkit)")
    return path


def _demangle(names: list[str]) -> list[str]:
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return out.splitlines()


def _short(name: str) -> str:
    """``void <unnamed>::k<float, (bool)1>(const T1 *, ...)`` ->
    ``k<float, (bool)1>``"""
    name = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::", "", name)
    return name.split(">(")[0] + ">" if ">(" in name else name


def parse_ptxas(log: str) -> list[tuple[str, str]]:
    """(mangled kernel name, "R regs, spill S/L B, X B static smem") for
    each entry function of an ``-Xptxas -v`` report."""
    rows, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((fn, f"{m.group(1)} regs, {spill}, "
                             f"{smem.group(1) if smem else 0} B static "
                             f"smem"))
            fn = None
    return rows


def ptxas_report(name: str) -> list[str]:
    """One line per kernel of the built ``name``: demangled name,
    registers, spill bytes and static shared memory."""
    _build.build((name,))
    rows = parse_ptxas(_build._lib_path(name).with_suffix(".log").read_text())
    names = _demangle([r[0] for r in rows]) if rows else []
    return [f"{_short(n)}: {r[1]}" for n, r in zip(names, rows)]


def disassemble(name: str) -> dict[str, list[str]]:
    """Demangled kernel name -> its SASS instruction lines."""
    _build.build((name,))
    text = subprocess.run([_tool("cuobjdump"), "-sass",
                           str(_build._lib_path(name))], capture_output=True,
                          text=True, check=True).stdout
    funcs: dict[str, list[str]] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            funcs[cur].append(line.strip())
    names = _demangle(list(funcs))
    return {_short(n): v for n, v in zip(names, funcs.values())}


def _op(line: str) -> tuple[int, str]:
    m = re.match(r"/\*([0-9a-f]+)\*/\s+(?:@!?\w+\s+)?([A-Z0-9_.]+)(.*)",
                 line)
    return int(m.group(1), 16), m.group(2) + " " + m.group(3).split(";")[0]


def summarize(lines: list[str]) -> list[str]:
    """Instruction mix and loops of one kernel's SASS."""
    ops = [_op(x) for x in lines]
    mix = Counter(o.split()[0].split(".")[0] for _, o in ops)
    out = [f"  {len(ops)} instructions; " + ", ".join(
        f"{k} {v}" for k, v in mix.most_common(14))]
    addr = {a: i for i, (a, _) in enumerate(ops)}
    for i, (a, o) in enumerate(ops):
        tgt = re.search(r"0x([0-9a-f]+)", o) if o.startswith("BRA") else None
        start = addr.get(int(tgt.group(1), 16)) if tgt else None
        if start is None or ops[start][0] >= a:
            continue
        body = [x for _, x in ops[start:i + 1]]
        seq, run = [], 0
        for x in body:
            kind = x.split()[0]
            if kind.startswith("FFMA"):
                run += 1
                continue
            if run:
                seq.append(f"FFMA x{run}")
                run = 0
            if kind.startswith(("LDG", "LDS", "LDSM", "BAR", "LDGSTS",
                                "LDGDEPBAR", "DEPBAR", "LD.", "SHFL",
                                "STS", "UCGABAR", "ULDC")):
                seq.append(kind)
        if run:
            seq.append(f"FFMA x{run}")
        out.append(f"  loop {ops[start][0]:#06x}-{a:#06x} "
                   f"({i + 1 - start} instructions): " + ", ".join(seq))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", choices=_build.SOURCES)
    ap.add_argument("--kernel", default="",
                    help="summarize the SASS of kernels whose demangled "
                         "name contains this")
    ap.add_argument("--out", help="write the whole disassembly here")
    args = ap.parse_args(argv)
    print(f"[ptxas] {args.source}.cu ({' '.join(_build.NVCC_FLAGS)})")
    for line in ptxas_report(args.source):
        print(f"  {line}")
    funcs = disassemble(args.source)
    if args.out:
        with open(args.out, "w") as f:
            for n, lines in funcs.items():
                f.write(f"// {n}\n" + "\n".join(lines) + "\n\n")
    if args.kernel:
        for n, lines in funcs.items():
            if args.kernel in n:
                print(f"[sass] {n}")
                for line in summarize(lines):
                    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
