"""What the kernel build reads back from a compiled library, on the CPU.

``kernels/build.py`` names each kernel instantiation from its mangled
name (``kernel_label``), reads ``cuobjdump -sass`` output into each
kernel's instructions (``sass_functions``) and counts the instruction
classes the 16-bit arithmetic is judged by (``sass_class``,
``sass_counts``): ``chip_smoke.py``'s ``ptxas_report`` and
``tools/sass_diff.py`` use them on the card.  Here they run on SASS text
in the form ``cuobjdump`` prints, through a stand-in ``cuobjdump``.
"""

import os
import stat
import sys

import pytest

from repro_torch.kernels import build

#: Mangled names as nvcc gives them for the kernels' instantiations (the
#: anonymous namespace carries a hash of the file) and the labels.
LABELS = [
    ("_ZN52_GLOBAL__N__5178818b_19_queued_superstep_cu_793540bd12queue_"
     "kernelILi2ELi4ELi2ELb0EEEvPK13__nv_bfloat16PS1_NS_3GeoEif",
     "queue_kernel<2,4,2,0>"),
    ("_ZN54_GLOBAL__N__5b72b5c8_21_streamed_superstep_cu_b6b120b915streamed"
     "_kernelILi1ELi4ELi3ELi2EEEvPK6__halfPS1_PKjPKiiifNS_3GeoE",
     "streamed_kernel<1,4,3,2>"),
    ("_ZN12_GLOBAL__N_112queue_kernelILi3ELi1ELi4ELb1EEEvPKfPfNS_3GeoEif",
     "queue_kernel<3,1,4,1>"),
    ("_ZN45_GLOBAL__N__4d83c425_12_wrap_halo_cu_38ca2b7916wrap_halo_kernelEP"
     "fPKxixxx", "wrap_halo_kernel"),
    ("_Z6kernelPf", "_Z6kernelPf"),
]

SASS = """
\tcode for sm_90a
\t\tFunction : {a}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
    /*0000*/  LDC R1, c[0x0][0x28] ; /* 0x0 */
                                   /* 0x000fe40000000800 */
    /*0010*/  @!P0 HMUL2.BF16_V2 R3, R4, c[0x3][0x0] ; /* 0x0 */
    /*0020*/  HFMA2.MMA.BF16_V2 R5, R2, R3, -RZ ; /* 0x0 */
    /*0030*/  HFMA2.MMA R6, -RZ, RZ, 0, 0 ; /* 0x0 */
    /*0040*/  HADD2.BF16_V2 R7, R5, R3 ; /* 0x0 */
    /*0050*/  PRMT R8, R3, 0x5432, R4 ; /* 0x0 */
    /*0060*/  EXIT ; /* 0x0 */
\t\t..........

\t\tFunction : {b}
    /*0000*/  F2FP.F16.F32.PACK_AB R0, RZ, R2 ; /* 0x0 */
    /*0010*/  HADD2.F32 R6, -RZ, R7.H0_H0 ; /* 0x0 */
    /*0020*/  FMUL R6, R6, c[0x3][0x4] ; /* 0x0 */
    /*0030*/  @P1 FADD R6, R6, R9 ; /* 0x0 */
    /*0040*/  EXIT ; /* 0x0 */
"""


@pytest.mark.parametrize("mangled,label", LABELS)
def test_kernel_label_reads_template_arguments(mangled, label):
    assert build.kernel_label(mangled) == label


@pytest.mark.parametrize("instruction,cls", [
    ("HMUL2.BF16_V2 R3, R4, c[0x3][0x0]", "packed"),
    ("@!P0 HADD2 R1, R2, R3", "packed"),
    ("HFMA2.MMA.BF16_V2 R5, R2, R3, -RZ", "packed"),
    ("HFMA2.MMA R6, -RZ, RZ, 0, 0", ""),
    ("HFMA2 R6, -RZ, RZ, 1.875, 0", ""),
    ("HADD2.F32 R6, -RZ, R7.H0_H0", "widen"),
    ("F2FP.BF16.F32.PACK_AB R0, RZ, R2", "cvt"),
    ("F2F.F16.F32 R0, R2", "cvt"),
    ("FMUL R6, R6, c[0x3][0x4]", "fp32"),
    ("@P1 FFMA R1, R2, R3, R4", "fp32"),
    ("PRMT R8, R3, 0x5432, R4", ""),
    ("IMAD.U32 R1, R2, 0x10000, RZ", ""),
])
def test_sass_class_of_each_instruction(instruction, cls):
    """Packed pair arithmetic on either pipe, but not a constant moved by
    ``HFMA2``; a half widened by ``HADD2.F32``; ``F2F``/``F2FP``
    conversions; float32 arithmetic; nothing else."""
    assert build.sass_class(instruction) == cls


def _fake_cuobjdump(tmp_path, monkeypatch, text):
    """A ``cuobjdump`` under ``$CUDA_HOME/bin`` that prints ``text``."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (tmp_path / "sass.txt").write_text(text)
    tool = bindir / "cuobjdump"
    tool.write_text(f"#!{sys.executable}\n"
                    f"import sys\n"
                    f"assert sys.argv[1] == '-sass'\n"
                    f"sys.stdout.write(open({str(tmp_path / 'sass.txt')!r})"
                    f".read())\n")
    tool.chmod(tool.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    return tool


def test_sass_functions_and_counts_through_cuobjdump(tmp_path, monkeypatch):
    """``sass`` runs ``cuobjdump -sass`` on a library; ``sass_functions``
    keeps each kernel's instructions with their predicates and without
    addresses or encodings; ``sass_counts`` counts the classes."""
    a, b = LABELS[0][0], LABELS[1][0]
    tool = _fake_cuobjdump(tmp_path, monkeypatch, SASS.format(a=a, b=b))
    assert build.cuobjdump() == str(tool)
    funcs = build.sass_functions(build.sass(tmp_path / "lib.so"))
    assert list(funcs) == [a, b]
    assert funcs[a] == ("LDC R1, c[0x0][0x28]",
                        "@!P0 HMUL2.BF16_V2 R3, R4, c[0x3][0x0]",
                        "HFMA2.MMA.BF16_V2 R5, R2, R3, -RZ",
                        "HFMA2.MMA R6, -RZ, RZ, 0, 0",
                        "HADD2.BF16_V2 R7, R5, R3",
                        "PRMT R8, R3, 0x5432, R4", "EXIT")
    assert build.sass_counts(funcs[a]) == dict(cvt=0, widen=0, packed=3,
                                               fp32=0)
    assert build.sass_counts(funcs[b]) == dict(cvt=1, widen=1, packed=0,
                                               fp32=2)


def test_no_cuobjdump_is_an_empty_path(tmp_path, monkeypatch):
    """Without the tool, ``cuobjdump()`` is "" and ``sass`` raises."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    exists = os.path.exists
    monkeypatch.setattr(build.os.path, "exists",
                        lambda p: exists(p) and str(p).startswith(
                            str(tmp_path)))
    assert build.cuobjdump() == ""
    with pytest.raises(RuntimeError, match="cuobjdump"):
        build.sass(tmp_path / "lib.so")
