"""The ``coulomb_256.three_states`` cell's files and its ``gate_engaged``
reader on the CPU: the reader on synthetic traces; the configuration,
traffic and limits files building the port's ``Config`` of the 256³
north star; and the cell's limits holding the 20³ Coulomb stand-in of
``test_portbench_coulomb.py``: its port job passes them, and the same job
fails them when its chunks return their state unchanged, when its energy
is altered by 1 %, and for the bfloat16 control."""

import pytest
import torch

from portbench import check, driver, spec
from portbench.record import Record, Trace
from test_portbench_coulomb import RAW, reference_solve

CPU = torch.device("cpu")
CELL = "coulomb_256.three_states"
LIMITS = spec.limits(CELL)
# ``benchmarks/r2_validate.py`` ``northstar()``: the run BASELINE.json's north star names
NORTH_STAR = {
    "grid": {"size": {"x": 256, "y": 256, "z": 256}, "dn": 0.0625, "dt": 1.3e-3},
    "tolerance": 1e-6, "central_difference": "ThreePoint", "max_steps": 500000,
    "potential": "Coulomb", "mass": 1.0, "init_condition": "Coulomb", "sig": 1.0,
    "init_symmetry": "NotConstrained", "precision": "f32",
}


def record(spans):
    return Record(grid=(4, 4, 4), b_streams=False, setup_s=1.0, window_s=2.0, chunk_steps=0,
                  trace=Trace(window_s=2.0, spans=spans))


def job():
    """A traced job: the ground state's measures (not counted), state 1's
    four boundaries with one after a delayed chunk, state 2's two with
    one."""
    return [
        ("portbench.solve", 0.0, 1.0),
        ("portbench.state.0", 0.0, 0.3),
        ("wafer.measure", 0.1, 0.01), ("wafer.measure", 0.2, 0.01),
        ("portbench.state.1", 0.3, 0.4),
        ("wafer.measure", 0.31, 0.01), ("wafer.measure", 0.4, 0.01),
        ("wafer.measure", 0.5, 0.01), ("wafer.admixture", 0.501, 0.002),
        ("wafer.measure", 0.6, 0.01),
        ("portbench.state.2", 0.7, 0.3),
        ("wafer.measure", 0.71, 0.01), ("wafer.admixture", 0.711, 0.002),
        ("wafer.measure", 0.8, 0.01),
    ]


def read(rec):
    return spec.reader("gate_engaged")(rec)


def test_gate_engaged_is_the_excited_states_share_of_delayed_boundaries():
    assert read(record(job())) == pytest.approx(100.0 * 2 / 6)


def test_gate_engaged_reads_zero_where_no_excited_chunk_ran_delayed():
    spans = [s for s in job() if s[0] != "wafer.admixture"]
    assert read(record(spans)) == 0.0


def test_gate_engaged_is_nothing_without_a_trace_or_an_excited_measure():
    assert read(Record(grid=(4, 4, 4), b_streams=False, setup_s=1.0, window_s=2.0,
                       chunk_steps=0)) is None
    ground = [s for s in job() if s[1] < 0.3 and s[0] != "portbench.solve"]
    assert read(record(ground)) is None


def test_gate_engaged_is_nothing_from_a_program_that_does_not_trace_its_gate(monkeypatch):
    import dataclasses

    from wafer_torch import solver

    fields = [f for f in dataclasses.fields(solver.SolveResult) if f.name != "gate"]
    monkeypatch.setattr(dataclasses, "fields", lambda cls: fields)
    assert read(record(job())) is None


def test_the_metric_is_declared_for_the_cell_alone():
    (metric,) = [m for m in spec.benchmark()["per_layer"] if m["name"] == "gate_engaged"]
    assert metric == {"name": "gate_engaged", "unit": "%", "better": "higher",
                      "source": "program_span", "layer": "solve loop", "moves": "solve_s",
                      "workloads": [CELL]}


def test_the_files_build_the_north_stars_config(tmp_path):
    cell = spec.workload(spec.benchmark(), CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("coulomb_256", "three_states", 1)
    raw = spec.run_raw(spec.configuration("coulomb_256"), spec.traffic("three_states"))
    assert {k: raw[k] for k in NORTH_STAR} == NORTH_STAR
    assert raw["output"]["screen_update"] == 500 and raw["wavemax"] == 2
    config = spec.port_config(raw, tmp_path)
    assert config.grid.size.as_tuple() == (256, 256, 256)
    assert (config.grid.dn, config.grid.dt, config.tolerance) == (0.0625, 1.3e-3, 1e-6)
    assert config.potential.value == "Coulomb" and config.delayed_gram
    assert spec.pool(spec.traffic("three_states")) == [3562513743]
    assert set(LIMITS) == {"energy_gap", "moment_gap", "residual", "overlap"}


def port_numbers(tmp_path, monkeypatch=None, unchanged=False, altered=False):
    """The stand-in's port job, judged: its numbers."""
    from wafer_torch import solver
    from wafer_torch.io import run_dir
    from wafer_torch.ops import stencil

    if unchanged:
        monkeypatch.setattr(stencil, "evolve_chunk", lambda phi, *a, **k: phi)
    if altered:
        read_obs = solver.read_observables

        def read_altered(sums):
            obs = read_obs(sums)
            obs.energy = obs.energy * (1.0 + 1e-2)
            return obs

        monkeypatch.setattr(solver, "read_observables", read_altered)
    (tmp_path / "input").mkdir()
    config = spec.port_config(RAW, tmp_path)
    run_dir.check_output_dir(config.project_name, config.output_root)
    results = driver.Loop(config, CPU).job(2**31 + 11)
    return check.Judge(RAW, CPU).solve(check.port_states(results))


def test_the_stand_ins_port_job_passes_the_cells_limits(tmp_path):
    worst, failed = check.verdict([port_numbers(tmp_path)], LIMITS)
    assert failed == 0, worst


def test_a_chunk_that_returns_its_state_unchanged_fails_the_cells_limits(tmp_path, monkeypatch):
    worst, failed = check.verdict([port_numbers(tmp_path, monkeypatch, unchanged=True)], LIMITS)
    assert failed == 1 and worst["residual"] > LIMITS["residual"]


def test_an_energy_altered_by_one_percent_fails_the_cells_limits(tmp_path, monkeypatch):
    worst, failed = check.verdict([port_numbers(tmp_path, monkeypatch, altered=True)], LIMITS)
    assert failed == 1 and worst["energy_gap"] > LIMITS["energy_gap"]


def test_the_bfloat16_control_fails_the_cells_limits():
    worst, failed = check.verdict([check.Judge(RAW, CPU).solve(reference_solve(torch.bfloat16))],
                                  LIMITS)
    assert failed == 1 and worst["energy_gap"] > LIMITS["energy_gap"]
