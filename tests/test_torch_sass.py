"""The SASS and ptxas report helpers of ``repro_torch.kernels.sass``,
on fixed text (the toolkit that produces it runs only beside the
card)."""
import pytest

pytest.importorskip("torch")  # the repro_torch package imports torch

from repro_torch.kernels.sass import _short, parse_ptxas, summarize

PTXAS = """\
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 20 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'
ptxas info    : Function properties for _Z3barPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 1024 bytes smem, 380 bytes cmem[0]
"""

SASS = """\
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.128.CONSTANT R4, [R2.64] ;
        /*0020*/                   LDG.E.128.CONSTANT R8, [R2.64+0x10] ;
        /*0030*/                   LDS.U16 R12, [R6] ;
        /*0040*/                   FFMA R20, R4, R12, R20 ;
        /*0050*/                   FFMA R21, R5, R12, R21 ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/               @P0 BRA 0x10 ;
        /*0080*/                   EXIT ;
""".splitlines()


def test_parse_ptxas_reads_registers_spills_and_smem():
    assert parse_ptxas(PTXAS) == [
        ("_Z3fooPf", "128 regs, spill 20/28 B, 0 B static smem"),
        ("_Z3barPf", "40 regs, spill 0/0 B, 1024 B static smem")]


@pytest.mark.parametrize("name,short", [
    ("void <unnamed>::sfc_matmul_tile<float, (bool)1, (bool)1>(const T1 *, "
     "int, <unnamed>::Epilogue)", "sfc_matmul_tile<float, (bool)1, (bool)1>"),
    ("void (anonymous namespace)::k<__nv_bfloat16>(__nv_bfloat16 const*)",
     "k<__nv_bfloat16>"),
    ("plain_name", "plain_name")])
def test_short_names(name, short):
    assert _short(name) == short


def test_summarize_mix_and_loop_sequence():
    mix, loop = summarize([line.strip() for line in SASS])
    assert mix.startswith("  9 instructions; ")
    assert "LDG 2" in mix and "FFMA 2" in mix
    assert loop == ("  loop 0x0010-0x0070 (7 instructions): "
                    "LDG.E.128.CONSTANT, LDG.E.128.CONSTANT, LDS.U16, "
                    "FFMA x2, BAR.SYNC.DEFER_BLOCKING")
