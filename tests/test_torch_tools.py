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
    """A sweep's entry; a wide-route kernel (S a string of chip_smoke.WIDE_S)
    has no stored-state count among its template arguments."""
    count = "" if isinstance(s, str) else f"ELi{str(s).replace('-', 'n')}"
    name = (f"_ZN41_GLOBAL__N__0a1b2c3d_17_x_cu_9f8e7d6c{len(kernel)}{kernel}"
            f"ILi{ext}{count}ELb{int(win)}EEEv9SweepArgs")
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


# Case names of compare_launches.py's dumps and tune_sweep.py's timed cases,
# and whether the two trees may compute them apart: K1 with Coulomb or
# SimpleCornell B (f32 and bf16 stores, partial rows included), and the
# solves of those potentials; never K3 (ComplexCoulomb included), another
# kind of B, streamed B, a mesh chunk or K2.
B_CASES = [
    ("K1 Coulomb ThreePoint (37, 45, 29) S=0 False (0, 0, 0)", True),
    ("K1 Coulomb SevenPoint (9, 40, 70) S=2 True (3, 5, 2) bf16 partials", True),
    ("K1 SimpleCornell ThreePoint (64, 64, 128) S=1 (3, 5, 2) partials", True),
    ("K1 bf16 Coulomb 512^3 S=2 reduce", True),
    ("K1 SimpleCornell deep 136x256x512 windowed S=1 reduce", True),
    ("solve coulomb_states.yaml Coulomb #2 state 2", True),
    ("solve cornell.yaml SimpleCornell #0 state 0", True),
    ("K1 Periodic ThreePoint (37, 45, 29) S=1 (0, 0, 0)", False),
    ("K1 Harmonic SevenPoint (64, 64, 128) S=0 (0, 0, 0) partials", False),
    ("K1 NoPotential ThreePoint (37, 45, 29) S=0 (0, 0, 0)", False),
    ("K1 streamed ThreePoint (37, 45, 29) S=1 (3, 5, 2)", False),
    ("K1 bf16 256^3 S=1 reduce", False),
    ("K3 Coulomb ThreePoint (37, 45, 29) S=1 True (0, 0, 0) partials", False),
    ("K1 ComplexCoulomb ThreePoint (37, 45, 29) S=0", False),
    ("mesh chunk S=1", False),
    ("solve complex_cornell.yaml #0 state 0", False),
    ("solve 2 x (2, 2, 1) #1 state 1 phi", False),
    ("copy_ 256^3 (K1 ground's bytes)", False),
]


@pytest.mark.parametrize("key, changed", B_CASES, ids=[k for k, _c in B_CASES])
def test_b_changed_names_k1_coulomb_and_cornell_only(key, changed):
    assert compare_launches.b_changed(key) is changed


# K1's launches with three or four stored states run its many-state kernels,
# with five or more its wide route, and K3's with three or more stored
# pairs its wide route: their overlaps add in another order than the
# run-time count of a tree before them, so they may leave the other tree's
# bits whatever their B. K1 and K3 with fewer states are held bit for bit.
MANY_CASES = [
    ("K1 Harmonic 256^3 S=3 reduce", True),
    ("K1 bf16 streamed 512^3 S=4 reduce", True),
    ("K1 Coulomb ThreePoint (37, 45, 29) S=3 True (3, 5, 2) bf16 partials", True),
    ("K1 Harmonic 256^3 S=5 reduce", True),
    ("K1 bf16 streamed 512^3 S=5 reduce", True),
    ("K1 Harmonic 256^3 S=2 reduce", False),
    ("K3 256^3 S=3 reduce", True),
    ("K3 Coulomb ThreePoint (37, 45, 29) S=4 True (0, 0, 0) partials", True),
    ("K1 Harmonic 512^3 S=12 reduce", True),
    ("K3 256^3 S=2 reduce", False),
    ("K3 Harmonic ThreePoint (37, 45, 29) S=1 True (0, 0, 0)", False),
    ("mesh chunk S=3", False),
]


@pytest.mark.parametrize("key, changed", MANY_CASES, ids=[k for k, _c in MANY_CASES])
def test_b_changed_names_k1_many_state_launches(key, changed):
    assert compare_launches.b_changed(key) is changed


@pytest.mark.parametrize("kernel, family", [
    ("sweep_step_many_kernel", "K1 f32 many"),
    ("sweep_step_bf16_many_kernel", "K1 bf16 many"),
    ("sweep_step_many_costly_kernel", "K1 f32 many costly B"),
    ("sweep_step_bf16_many_costly_kernel", "K1 bf16 many costly B"),
])
def test_many_state_kernels_are_families_and_main_sweeps_of_their_own(kernel, family):
    assert compare_launches.family(f"{kernel}ILi1ELi4EEEv9SweepArgs") == family
    name = (f"_ZN41_GLOBAL__N__0a1b2c3d_17_x_cu_9f8e7d6c{len(kernel)}{kernel}"
            f"ILi1ELi4ELb0EEEv9SweepArgs")
    assert chip_smoke.sweep_instance(name) == (kernel, 1, 4, False)
    assert chip_smoke.MAIN_SWEEPS[kernel, 1, 4] == 2
    want = ["Coulomb", "SimpleCornell", "Periodic"] if "costly" in kernel else [
        "NoPotential", "Harmonic", "streamed"]
    assert sass_count.kinds_of(f"_ZN1_{len(kernel)}{kernel}ILi1ELi4ELb0EEEv9SweepArgs") == want


@pytest.mark.parametrize("kernel, family, counts", [
    ("sweep_step_wide_kernel", "K1 f32 wide", "5+"),
    ("sweep_step_bf16_wide_kernel", "K1 bf16 wide", "5+"),
    ("sweep_step_sc_wide_kernel", "K3 wide", "3+"),
])
def test_wide_route_kernels_are_families_and_main_sweeps_of_their_own(kernel, family, counts):
    """The wide route's kernels (no stored-state count among their template
    arguments) form families of their own and are main-path sweeps that
    phase 1 holds to two blocks an SM."""
    assert compare_launches.family(f"{kernel}ILi1EEEv9SweepArgsi") == family
    name = (f"_ZN41_GLOBAL__N__0a1b2c3d_17_x_cu_9f8e7d6c{len(kernel)}{kernel}"
            f"ILi3ELb1EEEv9SweepArgsi")
    assert chip_smoke.sweep_instance(name) == (kernel, 3, counts, True)
    assert chip_smoke.MAIN_SWEEPS[kernel, 1, counts] == 2
    kinds = sass_count.kinds_of(f"_ZN1_{len(kernel)}{kernel}ILi1ELb0EEEv9SweepArgsi")
    assert kinds == (None if "_sc_" in kernel else [
        "NoPotential", "Harmonic", "Coulomb", "SimpleCornell", "Periodic", "streamed"])


@pytest.mark.parametrize("kernel, counts", [
    ("sweep_step_wide_kernel", "5+"), ("sweep_step_bf16_wide_kernel", "5+"),
    ("sweep_step_sc_wide_kernel", "3+"),
])
def test_wide_route_kernels_past_the_rings_are_apart_from_the_main_sweeps(kernel, counts):
    """The wide route's kernel of the states its rings do not hold (OVER, a
    second bool among its template arguments, always with the plane checks)
    is an instance of its own, not a main-path sweep; the kernel the rings
    hold stays the main-path one."""
    stem = f"_ZN41_GLOBAL__N__0a1b2c3d_17_x_cu_9f8e7d6c{len(kernel)}{kernel}"
    over = chip_smoke.sweep_instance(f"{stem}ILi1ELb1ELb1EEEv9SweepArgsi")
    assert over == (kernel, 1, counts + " past the rings", True)
    assert over[:3] not in chip_smoke.MAIN_SWEEPS
    held = chip_smoke.sweep_instance(f"{stem}ILi1ELb0ELb0EEEv9SweepArgsi")
    assert held == (kernel, 1, counts, False) and chip_smoke.MAIN_SWEEPS[held[:3]] == 2


def test_changed_close_holds_each_output_to_its_tolerance():
    import torch

    close = compare_launches.changed_close
    psi = torch.linspace(-2.0, 4.0, 1000)
    assert close("K1 Coulomb x", psi + 3e-6, psi) == (True, pytest.approx(7.5e-7, rel=0.1))
    assert not close("K1 Coulomb x", psi + 5e-6, psi)[0]
    rows = torch.tensor([[4.0, 0.5], [5.0, -0.25]], dtype=torch.float64)  # sums 9, 0.25
    assert close("K1 Coulomb x partials", rows + torch.tensor([[0.0, 2.9e-5], [0.0, 0.0]]), rows)[0]
    assert not close("K1 Coulomb x partials", rows + torch.tensor([[0.0, 3.1e-5], [0.0, 0.0]]), rows)[0]
    assert not close("K1 Coulomb x partials", rows * (1 + 2e-5), rows)[0]
    solve = {"steps": 4000, "energy": -0.5, "screen_update": 500}
    assert close("solve c Coulomb #0", dict(solve, steps=4500, energy=-0.5 * (1 + 9e-7)),
                 solve)[0]
    assert not close("solve c Coulomb #0", dict(solve, steps=4501), solve)[0]
    assert not close("solve c Coulomb #0", dict(solve, energy=-0.5 * (1 + 2e-6)), solve)[0]


def test_compare_digests_holds_changed_cases_within_tolerance(tmp_path):
    import torch

    psi = torch.linspace(-1.0, 1.0, 64)

    def kept(name, t):
        torch.save(t, tmp_path / name)
        return {"digest": name, "file": str(tmp_path / name)}

    other = {"K1 Harmonic a": "d1", "K1 Coulomb a": kept("o1", psi),
             "K1 Coulomb b": kept("o2", psi), "K3 Coulomb a": "d2",
             "solve c Coulomb #0": {"steps": 10, "energy": -0.5, "screen_update": 5}}
    this = {"K1 Harmonic a": "d1", "K1 Coulomb a": kept("t1", psi + 1e-7),
            "K1 Coulomb b": kept("t2", psi + 1e-5), "K3 Coulomb a": "d3",
            "solve c Coulomb #0": {"steps": 10, "energy": -0.5, "screen_update": 5}}
    differ, changed = compare_launches.compare_digests(other, this)
    assert differ == ["K1 Coulomb b", "K3 Coulomb a"]
    assert sorted(changed) == ["K1 Coulomb a", "K1 Coulomb b"]
    assert changed["K1 Coulomb a"] == pytest.approx(1e-7, rel=0.3)  # f32 steps
    this["K3 Coulomb a"], this["K1 Coulomb b"] = "d2", other["K1 Coulomb b"]  # the same bits
    assert compare_launches.compare_digests(other, this)[0] == []


@pytest.mark.parametrize("name, kinds", [
    ("_ZN1_17sweep_step_kernelILi1ELi0ELb0ELi3EEEv9SweepArgs", "cheap"),
    ("_ZN1_24sweep_step_costly_kernelILi1ELi1ELb1ELi1ELi1EEEv9SweepArgs", "costly"),
    ("_ZN1_24sweep_step_costly_kernelILi3ELin1ELb0ELi1ELi2EEEv9SweepArgs", "costly"),
    ("_ZN1_22sweep_step_bf16_kernelILi1ELi2ELb1EEEv9SweepArgs", "cheap"),
    ("_ZN1_29sweep_step_bf16_costly_kernelILi2ELi1ELb0EEEv9SweepArgs", "costly"),
    (K1, "cheap"),
    (K3, None),
    (K2, None),
])
def test_kinds_of_names_the_sources_of_b_a_k1_kernel_serves(name, kinds):
    want = {"cheap": ["NoPotential", "Harmonic", "streamed"],
            "costly": ["Coulomb", "SimpleCornell", "Periodic"], None: None}[kinds]
    assert sass_count.kinds_of(name) == want


def test_costly_b_kernels_are_families_and_main_sweeps_of_their_own():
    assert compare_launches.family("sweep_step_costly_kernelILi1ELi0ELi1ELi1EEEv9SweepArgs") \
        == "K1 f32 costly B"
    assert compare_launches.family("sweep_step_bf16_costly_kernelILi1ELi1EEEv9SweepArgs") \
        == "K1 bf16 costly B"
    name = ("_ZN41_GLOBAL__N__0a1b2c3d_17_x_cu_9f8e7d6c29sweep_step_bf16_costly_kernel"
            "ILi1ELi2ELb1EEEv9SweepArgs")
    assert chip_smoke.sweep_instance(name) == ("sweep_step_bf16_costly_kernel", 1, 2, True)


def test_costly_summary_gives_each_trees_worst_and_misses():
    errs = {"other": {"a": [2e-7, 1e-9], "b": [4e-7, 3e-9]},
            "this": {"a": [6e-7, 2e-9], "b": [1.2e-6, 1e-9]}}
    got = compare_launches.costly_summary(errs)
    assert got["cases"] == 2 and got["same_cases"] and got["gates"] == [1e-6, 1e-5]
    assert got["other"] == {"worst": [4e-7, 3e-9], "missed": []}
    assert got["this"] == {"worst": [1.2e-6, 2e-9], "missed": ["b"]}


@pytest.mark.parametrize("main", chip_smoke.COSTLY_B_MAIN,
                         ids=[c[0] for c in chip_smoke.COSTLY_B_MAIN])
def test_costly_b_case_list_holds_each_main_path_block(main):
    name, kind, physics, glob, shape, origin, red, modes = main
    cases = [(args, kw) for label, args, kw in
             chip_smoke.costly_b_case_list(("Coulomb", "SimpleCornell"), ("ThreePoint",))
             if f" {name} " in label]
    assert len(cases) == len(modes)
    for (args, kw), (n_store, apply, stream) in zip(cases, modes):
        assert args == ("ThreePoint", kind, n_store, apply, glob, shape, origin)
        assert kw == {"stream": stream, "physics": physics, "red": red}


def test_trace_split_starts_the_loop_at_the_first_state_setup(tmp_path):
    """chip_smoke.trace_split takes the solve loop's wall from the first
    ``wafer.state_setup`` span, not from the first ``wafer.*`` span: a
    job's trace opens with ``wafer.load_potentials``, whose time and
    kernels belong to the job's set-up."""
    import json

    def span(name, ts, dur, cat="user_annotation"):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}

    events = [span("wafer.load_potentials", 0, 1000),
              span("fill_potential_kernel", 400, 300, "kernel"),
              span("wafer.state_setup", 1000, 100),
              span("wafer.evolve_chunk", 1100, 500),
              span("wafer.state_setup", 1300, 10, "gpu_user_annotation"),
              span("void sweep_step_kernel<1, 0, false, 3>", 1150, 200, "kernel"),
              span("reduce_kernel", 1400, 50, "kernel"),
              span("cudaMemcpyAsync", 1500, 100, "cuda_runtime")]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    split = chip_smoke.trace_split(path)
    assert split["wall_ms"] == pytest.approx(0.6)
    assert split["kernel_events"] == 2 and split["chunk_kernel_events"] == 1
    assert split["chunk_kernels_ms"] == pytest.approx(0.2)
    assert split["measure_kernels_ms"] == pytest.approx(0.05)
    assert split["host_read_ms"] == pytest.approx(0.1)
    assert split["python_between_launches_ms"] == pytest.approx(0.25)
    assert split["spans"] == ["wafer.evolve_chunk", "wafer.load_potentials", "wafer.state_setup"]
