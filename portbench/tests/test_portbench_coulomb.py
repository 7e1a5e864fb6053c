"""A small Coulomb three-state job, the 256³ north star's configuration at
20³, held to the plain reference on the CPU: the port's job through the
timed path's own call (``driver.Loop.job``: ``solver.run``), judged by
``check.Judge``, its energies against the reference H's exact lowest
levels (``scipy.sparse.linalg.eigsh``), and the reference's own solve in
f32 and in the control's bfloat16 on the same configuration."""

import numpy as np
import pytest
import scipy.sparse.linalg as sla
import torch

from portbench import calibrate, check, driver, spec
from portbench.reference import evolve, hamiltonian, potentials

CPU = torch.device("cpu")

# The north star's keys (256³, dn 0.0625, dt 1.3e-3, screen_update 500) cut
# to a 10-wide box: the 1s level and the 2p triplet lie below the box's 2s.
RAW = {
    "project_name": "portbench coulomb small", "wavenum": 0, "wavemax": 2,
    "grid": {"size": {"x": 20, "y": 20, "z": 20}, "dn": 0.5, "dt": 0.05},
    "tolerance": 1e-6, "central_difference": "ThreePoint", "max_steps": 100000,
    "output": {"screen_update": 100, "file_type": "Json", "save_wavefns": False,
               "save_potential": False},
    "potential": "Coulomb", "mass": 1.0, "init_condition": "Coulomb", "sig": 1.0,
    "init_symmetry": "NotConstrained", "precision": "f32",
}

# Each limit with the readings it was set above: the port's job at dt 0.05
# from seeds 2**31 + 5, 11 and 12; the control (bfloat16) reads 0.23,
# 4.9e-3, 0.074 and 4.7e-4.
LIMITS = {
    # the port's reported E against the reference's Rayleigh quotient of the
    # same ψ: f32 sums over 8,000 points; read 1.8e-7 to 5.3e-7
    "energy_gap": 1e-5,
    # ⟨r²⟩ the same way (V∞ is 0, so not compared); read 2.0e-8
    "moment_gap": 1e-6,
    # the semi-implicit step's fixed point is an eigenvector of H only to
    # O(dt): read 5.4e-3 at dt 0.05 (8.8e-3 at 0.08)
    "residual": 0.02,
    # f32 Gram-Schmidt on every step; read 5.5e-9 to 8.1e-9
    "overlap": 1e-6,
}
# |E − level|: the Rayleigh quotient of that O(dt) departure is off by its
# square over the gap to the next level: read 3.3e-5 (1s), at most 7.1e-7
# (2p); the control 1.0e-2 to 1.5e-2
LEVEL_GAP = 1e-4


def exact_levels(raw, count):
    """The ``count`` lowest eigenvalues of the reference H on the grid."""
    v = potentials.real_potential(raw, CPU)
    dn, mass = float(raw["grid"]["dn"]), float(raw["mass"])

    def matvec(x):
        psi = torch.from_numpy(np.ascontiguousarray(x).reshape(v.shape))
        return hamiltonian.apply_h(psi, v, dn, mass).reshape(-1).numpy()

    op = sla.LinearOperator((v.numel(),) * 2, matvec=matvec, dtype=np.float64)
    return np.sort(sla.eigsh(op, k=count, which="SA", tol=1e-12)[0])


@pytest.fixture(scope="module")
def levels():
    return exact_levels(RAW, 6)


def test_the_reference_h_has_the_1s_level_and_the_2p_triplet_lowest(levels):
    assert levels[0] == pytest.approx(-0.43930, abs=1e-5)
    assert np.ptp(levels[1:4]) < 1e-10 and levels[1] == pytest.approx(-0.060395, abs=1e-6)
    assert levels[4] > levels[3] + 0.05


def assert_lowest_levels(energies, levels):
    """E₀ is the lowest level; E₁ and E₂ each one of the next four (the
    n = 2 multiplet, which the box splits into the 2p triplet and 2s)."""
    assert abs(energies[0] - levels[0]) < LEVEL_GAP
    for e in energies[1:]:
        assert min(abs(e - levels[1:5])) < LEVEL_GAP


def test_the_ports_coulomb_three_state_job_is_the_references_lowest_levels(levels, tmp_path):
    (tmp_path / "input").mkdir()
    config = spec.port_config(RAW, tmp_path)
    from wafer_torch.io import run_dir

    run_dir.check_output_dir(config.project_name, config.output_root)
    results = driver.Loop(config, CPU).job(2**31 + 5)
    assert [r.converged for r in results] == [True] * 3
    numbers = check.Judge(RAW, CPU).solve(check.port_states(results))
    assert "level_gap" not in numbers
    worst, failed = check.verdict([numbers], LIMITS)
    assert failed == 0, worst
    assert_lowest_levels([r.observables.energy / r.observables.norm2 for r in results], levels)


def reference_solve(dtype):
    solver = evolve.Solver(RAW, dtype, CPU)
    states, lower = [], []
    for w in range(3):
        psi, _steps = solver.solve_state(7000 + w, lower, max_chunks=calibrate.CONTROL_CHUNKS)
        lower.append(psi)
        states.append((psi[0], solver.observables(psi)))
    return states


def test_the_reference_solves_a_coulomb_job_and_its_control_reads_worse(levels):
    judge = check.Judge(RAW, CPU)
    f32 = reference_solve(torch.float32)
    assert_lowest_levels([s[1]["energy"] / s[1]["norm2"] for s in f32], levels)
    _worst, failed = check.verdict([judge.solve(f32)], LIMITS)
    assert failed == 0
    _worst, failed = check.verdict([judge.solve(reference_solve(torch.bfloat16))], LIMITS)
    assert failed == 1
