"""The control: the plain reference, put in the program's place and run in
bfloat16 (the precision below the configurations' f32), is not correct by
the cells' limits; run in f32 at the same size it is. At 16³ on the CPU,
with at most two states;
``portbench/calibrate.py --control 3`` runs it on the card at each cell's
own size."""

import pytest
import torch

from portbench import calibrate, check, spec
from portbench.reference import evolve
from test_portbench_run import small, small_mix

CPU = torch.device("cpu")
CELLS = spec.benchmark()["workloads"]


def reference_solve(cell, dtype):
    raw = spec.run_raw(small(cell["config"]), small_mix(cell["traffic"]))
    solver = evolve.Solver(raw, dtype, CPU)
    states, lower = [], []
    for w in range(raw["wavemax"] + 1):
        psi, _steps = solver.solve_state(1000 + w, lower, max_chunks=200)
        lower.append(psi)
        states.append((psi if psi.shape[0] == 2 else psi[0], solver.observables(psi)))
    numbers = check.Judge(raw, CPU).solve(states)
    return check.verdict([numbers], spec.limits(cell["name"]))


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_the_control_in_bfloat16_is_not_correct(cell):
    _worst, failed = reference_solve(cell, getattr(torch, calibrate.CONTROL_DTYPE))
    assert failed == 1


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_the_reference_in_f32_is_correct(cell):
    worst, failed = reference_solve(cell, torch.float32)
    assert failed == 0, worst
