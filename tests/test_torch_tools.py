"""The measuring tools of the sweep kernels, on canned text: the
``cuobjdump -sass`` parser that ``tools/compare_launches.py`` (``--sass``)
and ``tools/sass_count.py`` share, and ``chip_smoke``'s reading of nvcc's
``-Xptxas -v`` report (phase 1's register check). No card or CUDA toolkit
is needed."""

import sys
from pathlib import Path

import pytest

import chip_smoke

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import compare_launches  # noqa: E402
import sass_count  # noqa: E402

K1 = ("_ZN41_GLOBAL__N__0a1b2c3d_17_stencil_sweep_cu_9f8e7d6c"
      "17sweep_step_kernelILi1ELi0ELb0EEEv9SweepArgs")
K2 = ("_ZN41_GLOBAL__N__0a1b2c3d_14_finish_coef_cu_5e4d3c2b"
      "18finish_coef_kernelILi512ELi2EEEvPKdiiPdPfS3_PKi")
K3 = ("_ZN41_GLOBAL__N__7f6e5d4c_15_split_sweep_cu_1a2b3c4d"
      "20sweep_step_sc_kernelILi1ELi1ELb1EEEv9SweepArgs")

# Two cubins, each closed by the headers of the next; the first holds K1
# (two loops: a predicated branch back to 0x30, a wider one back to 0x20,
# and the self-branch every kernel ends with) and K2, the second K3.
DUMP = f"""
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

\tcode for sm_90a
\t\tFunction : {K1}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/              LDC R1, c[0x0][0x28] ;  /* 0x00000a00ff017b82 */
                                                  /* 0x000fe40000000800 */
        /*0010*/              S2R R0, SR_TID.X ;  /* 0x0000000000007919 */
                                                  /* 0x000e220000002100 */
        /*0020*/              LDC.64 R2, c[0x0][0x210] ;  /* 0x00008400ff027b82 */
        /*0030*/              FFMA R4, R2, R3, R0 ;  /* 0x0000000302047223 */
        /*0040*/              ISETP.GE.AND P0, PT, R4, c[0x0][0x3a0], PT ;  /* 0x0000e80004007a0c */
        /*0050*/              @!P0 BRA 0x30 ;  /* 0xfffffffc00f48947 */
        /*0060*/              LDG.E R5, desc[UR4][R2.64] ;  /* 0x0000000402057981 */
        /*0070*/              BRA 0x20 ;  /* 0xfffffffc00e87947 */
        /*0080*/              EXIT ;  /* 0x000000000000794d */
        /*0090*/              BRA 0x90;  /* 0xfffffffc00fc7947 */
\t\t..........................

\t\tFunction : {K2}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/              LDC R1, c[0x0][0x28] ;  /* 0x00000a00ff017b82 */
        /*0010*/              @UP1 LDC R6, c[0x3][0x10] ;  /* 0x00000c00ff067b82 */
        /*0020*/              EXIT ;  /* 0x000000000000794d */
\t\t..........................



Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

\tcode for sm_90a
\t\tFunction : {K3}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/              LDC R1, c[0x0][0x28] ;  /* 0x00000a00ff017b82 */
        /*0010*/              EXIT ;  /* 0x000000000000794d */
\t\t..........................



Fatbin ptx code:
================
arch = sm_90a
code version = [8,4]
host = linux
compile_size = 64bit
compressed
"""


def test_parse_sass_splits_the_kernels_of_both_cubins():
    code = compare_launches.parse_sass(DUMP)
    assert list(code) == [K1, K2, K3]
    assert [len(code[k]) for k in (K1, K2, K3)] == [10, 3, 2]


@pytest.mark.parametrize("kernel, last", [
    (K1, (0x90, "BRA 0x90")),            # the headers of the second cubin follow K2, not K1
    (K2, (0x20, "EXIT")),                # the second cubin's headers are not K2's code
    (K3, (0x10, "EXIT")),                # nor the PTX section's, after the last kernel
], ids=["K1", "K2 before a cubin", "K3 last"])
def test_parse_sass_keeps_instruction_lines_only(kernel, last):
    code = compare_launches.parse_sass(DUMP)[kernel]
    assert code[-1] == last
    assert all(isinstance(addr, int) and ";" not in ins and "/*" not in ins for addr, ins in code)


def test_largest_loop_is_the_widest_backward_branch():
    code = compare_launches.parse_sass(DUMP)[K1]
    # @!P0 BRA 0x30 spans 0x30..0x50, BRA 0x20 spans 0x20..0x70, and the
    # closing BRA 0x90 to itself is no loop
    assert sass_count.largest_loop(code) == (0x20, 0x70)
    assert sass_count.loop_body(code) == [ins for addr, ins in code if 0x20 <= addr <= 0x70]
    assert len(sass_count.loop_body(code)) == 6
    assert sass_count.loop_body(compare_launches.parse_sass(DUMP)[K3]) == []


@pytest.mark.parametrize("ins, op", [
    ("@!P0 BRA 0x30", "BRA"),
    ("@UP1 LDC R6, c[0x3][0x10]", "LDC"),
    ("ISETP.GE.AND P0, PT, R4, c[0x0][0x3a0], PT", "ISETP"),
    ("@P2 IADD3.X R7, R9, R11, RZ, P0, !PT", "IADD3"),
    ("LDG.E R5, desc[UR4][R2.64]", "LDG"),
])
def test_opcode_drops_predicate_and_modifiers(ins, op):
    assert sass_count.opcode(ins) == op


def test_masked_kernels_key_the_plane_checkless_form_by_the_older_name():
    masked = compare_launches.masked_kernels(DUMP)
    assert sorted(masked) == sorted([
        "sweep_step_kernelILi1ELi0EEEv9SweepArgs",           # Lb0E cut: no plane checks
        "finish_coef_kernelILi512ELi2EEEvPKdiiPdPfS3_PKi",
        "sweep_step_sc_kernelILi1ELi1ELb1EEEv9SweepArgs",    # Lb1E kept
    ])
    assert [compare_launches.family(k) for k in sorted(masked)] == ["K2", "K1 f32", "K3"]
    assert compare_launches.family("sweep_step_bf16_kernelILi1ELi1EEEv9SweepArgs") == "K1 bf16"


def test_masked_kernels_mask_the_parameter_bank_only():
    masked = compare_launches.masked_kernels(DUMP)
    k1 = masked["sweep_step_kernelILi1ELi0EEEv9SweepArgs"]
    assert k1[2] == "LDC.64 R2, c[0x0][P]"
    assert k1[4] == "ISETP.GE.AND P0, PT, R4, c[0x0][P], PT"
    k2 = masked["finish_coef_kernelILi512ELi2EEEvPKdiiPdPfS3_PKi"]
    assert k2[1] == "@UP1 LDC R6, c[0x3][0x10]"
    # two builds that differ only in a parameter's offset compare equal
    moved = compare_launches.masked_kernels(DUMP.replace("c[0x0][0x210]", "c[0x0][0x218]"))
    assert moved == masked


# --- phase 1's register check (chip_smoke), on a canned -Xptxas -v report

def _entry(kernel, ext, s, win, registers, spill=0):
    name = (f"_ZN41_GLOBAL__N__0a1b2c3d_17_x_cu_9f8e7d6c{len(kernel)}{kernel}"
            f"ILi{ext}ELi{str(s).replace('-', 'n')}ELb{int(win)}EEEv9SweepArgs")
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used {registers} registers, used 1 barriers, 5376 bytes smem, "
            f"560 bytes cmem[0]\n")


def _log(change):
    """A build log of every main-path sweep (both forms) at the registers
    that fit its launch bounds, with ``change`` = {"kernel,ext,s,win":
    (registers, spill), or None to leave it out}, and one sweep outside
    the main paths."""
    text = "ptxas info    : 11 bytes gmem\n"
    for (kernel, ext, s), blocks in chip_smoke.MAIN_SWEEPS.items():
        fit = 65536 // (blocks * chip_smoke.SWEEP_THREADS[kernel]) // 8 * 8
        for win in (False, True):
            entry = change.get(f"{kernel},{ext},{s},{int(win)}", (fit, 0))
            if entry is not None:
                text += _entry(kernel, ext, s, win, *entry)
    return text + _entry("sweep_step_kernel", 3, -1, True, 168, 40)


@pytest.mark.parametrize("change, failed", [
    ({}, []),
    ({"sweep_step_kernel,1,1,0": (80, 8)}, [("sweep_step_kernel", 1, 1, False)]),
    ({"sweep_step_kernel,1,2,1": (88, 0)}, [("sweep_step_kernel", 1, 2, True)]),
    ({"sweep_step_sc_kernel,1,0,0": (72, 0)}, [("sweep_step_sc_kernel", 1, 0, False)]),
    ({"sweep_step_bf16_kernel,1,2,0": (81, 0)}, [("sweep_step_bf16_kernel", 1, 2, False)]),
    ({"sweep_step_sc_kernel,1,1,1": (56, 0)}, []),
    ({"sweep_step_bf16_kernel,1,1,1": None}, [("sweep_step_bf16_kernel", 1, 1, True)]),
], ids=["all fit", "K1 S=1 spills", "K1 S=2 at 88", "K3 at 72", "bf16 at 81", "K3 under its cap",
        "bf16 missing"])
def test_register_check_reads_spills_and_blocks(change, failed):
    rows, bad = chip_smoke.register_check(_log(change))
    assert len(rows) == 2 * len(chip_smoke.MAIN_SWEEPS) - (None in change.values())
    assert all(r[1] == 1 for r in rows)  # the EXT-3 run-time-count sweep is not a main-path row
    assert [r[:4] for r in bad] == failed


def test_register_check_takes_every_form_of_a_sweep():
    """K1's sweeps at EXT 1 build with and without the unroll (a template
    argument after the plane checks): each form is a row of its own."""
    extra = _entry("sweep_step_kernel", 1, 0, False, 64).replace("ELb0EEEv", "ELb0ELi1EEEv")
    rows, bad = chip_smoke.register_check(_log({}) + extra)
    assert len(rows) == 2 * len(chip_smoke.MAIN_SWEEPS) + 1 and bad == []


def test_ptxas_report_and_sweep_instance():
    log = _entry("sweep_step_sc_kernel", 2, 1, True, 64, 4) + _entry("sweep_step_kernel", 3, -1,
                                                                      False, 168)
    rep = chip_smoke.ptxas_report(log)
    assert sorted((chip_smoke.sweep_instance(k), v["registers"], v["spill_stores"])
                  for k, v in rep.items()) == [(("sweep_step_kernel", 3, -1, False), 168, 0),
                                               (("sweep_step_sc_kernel", 2, 1, True), 64, 4)]
    assert chip_smoke.sweep_instance(K2) is None


@pytest.mark.parametrize("registers, threads, blocks", [
    (80, 256, 3), (81, 256, 2), (72, 256, 3), (32, 256, 8), (64, 512, 2), (65, 512, 1),
    (128, 512, 1),
])
def test_blocks_per_sm(registers, threads, blocks):
    assert chip_smoke.blocks_per_sm(registers, threads) == blocks
