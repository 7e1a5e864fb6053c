"""The harness driven on the CPU at a small size: its result line, its
refusals, and ``correct`` coming out false when the timed path is broken
underneath. ``measure`` is ``run.py``'s run after the look for a card; the
port runs its plain ops here. One test, marked ``gpu``, runs a cell on the
card."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from portbench import run, spec

CPU = torch.device("cpu")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def small(config_name: str) -> dict:
    """The cell's configuration at 16³, with a finer step than its own so
    the semi-implicit step's bias stays under the cell's residual limit."""
    raw = spec.configuration(config_name)
    if raw["potential"] == "Harmonic":
        raw["grid"] = {"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.4, "dt": 0.004}
    else:
        raw["grid"] = {"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.5, "dt": 0.05}
    raw["output"] = {**raw["output"], "screen_update": 100}
    return raw


def small_mix(traffic_name: str) -> dict:
    """The cell's traffic with at most its first two states: at 16³ the
    sixth state converges against a lattice split of the 3.5 level some
    seven times the example's, too slowly for a test run."""
    mix = spec.traffic(traffic_name)
    return {**mix, "wavemax": min(int(mix["wavemax"]), 1)}


def measure(cell_name, monkeypatch, capsys, tmp_path, trace=0, seconds=2.0):
    bench = spec.benchmark()
    cell = spec.workload(bench, cell_name)
    tiny, mix = small(cell["config"]), small_mix(cell["traffic"])
    monkeypatch.setattr(spec, "configuration", lambda name: tiny)
    monkeypatch.setattr(spec, "traffic", lambda name: mix)
    args = types.SimpleNamespace(workload=cell_name, seed=2**31 + 977, seconds=seconds, trace=trace)
    rc = run.measure(args, bench, cell, CPU, tmp_path)
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


CELLS = [c["name"] for c in spec.benchmark()["workloads"]]
HARMONIC = next(name for name in CELLS if name.startswith("harmonic"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_its_line_has_the_contracts_keys(cell, monkeypatch, capsys, tmp_path):
    rc, line, err = measure(cell, monkeypatch, capsys, tmp_path)
    assert rc == 0
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    e2e = {m["name"] for m in spec.metrics_of(spec.benchmark(), cell, "end_to_end")}
    assert set(line["metrics"]) == e2e
    for name, check in line["checks"].items():
        assert check["value"] <= check["limit"]
        assert f"check {name} " in err
    assert err.strip().splitlines()[-1].startswith("check ")


def test_a_traced_run_reports_per_layer_metrics(monkeypatch, capsys, tmp_path):
    rc, line, _err = measure(HARMONIC, monkeypatch, capsys, tmp_path, trace=1,
                             seconds=6.0)
    assert rc == 0 and set(line) == KEYS | {"breakdown"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"steps_per_solve", "host_share", "chunk_rate", "measure_ms"} <= set(line["metrics"])
    assert "update_rate" not in line["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(cell, monkeypatch, capsys, tmp_path):
    from wafer_torch.ops import split_complex, stencil

    monkeypatch.setattr(stencil, "evolve_chunk", lambda phi, *a, **k: phi)
    monkeypatch.setattr(split_complex, "evolve_chunk_sc", lambda pr, pi, *a, **k: (pr, pi))
    _rc, line, _err = measure(cell, monkeypatch, capsys, tmp_path)
    assert line["correct"] is False and line["failed"] >= 1
    assert line["checks"]["residual"]["value"] > line["checks"]["residual"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch, capsys, tmp_path):
    from wafer_torch import solver

    read = solver.read_observables

    def altered(sums):
        obs = read(sums)
        obs.energy = obs.energy * (1.0 + 1e-2)
        return obs

    monkeypatch.setattr(solver, "read_observables", altered)
    _rc, line, _err = measure(cell, monkeypatch, capsys, tmp_path)
    assert line["correct"] is False and line["failed"] == line["attempted"]
    assert line["checks"]["energy_gap"]["value"] > line["checks"]["energy_gap"]["limit"]


def test_one_job_after_the_window_starts_from_an_initial_condition_drawn_from_the_seed(
        monkeypatch, capsys, tmp_path):
    from portbench import driver

    cell = CELLS[0]
    seeds, real = [], driver.fresh
    monkeypatch.setattr(driver, "fresh",
                        lambda config, device, seed: seeds.append(seed) or real(config, device, seed))
    rc, line, err = measure(cell, monkeypatch, capsys, tmp_path)
    assert rc == 0 and seeds == [spec.solve_seed(2**31 + 977, 0)]
    mix = spec.traffic(spec.workload(spec.benchmark(), cell)["traffic"])
    assert seeds[0] not in spec.pool(mix)
    in_window = int(err.split(f"seed {2**31 + 977}: ", 1)[1].split()[0])
    assert line["correct"] is True and line["attempted"] == in_window + 1


def test_forbidden_modules_are_matched_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "wafer_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "wafer_tpu.solver", types.ModuleType("wafer_tpu.solver"))
    assert run.forbidden_modules() == ["jax", "wafer_tpu"]


def test_nothing_the_harness_imports_loads_jax_or_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import portbench.run, portbench.driver, portbench.check, portbench.trace, portbench.calibrate;"
        "from portbench import spec; from portbench.reference import evolve;"
        "import wafer_torch.solver, wafer_torch.cli;"
        "[spec.reader(m['name']) for k in ('end_to_end', 'per_layer') for m in spec.benchmark()[k]];"
        "print(sorted({n.split('.')[0] for n in sys.modules} & {'jax', 'jaxlib', 'flax', 'wafer_tpu'}))"
    )
    out = subprocess.run([sys.executable, "-c", code, str(spec.ROOT)], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_without_a_card_it_prints_no_result_and_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(spec.ROOT / "portbench" / "run.py"), "--workload",
                          HARMONIC, "--seed", str(2**33), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_beside_its_own_files_alone_it_prints_no_result_and_fails(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          HARMONIC, "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run only there")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, str(spec.ROOT / "portbench" / "run.py"), "--workload",
                          HARMONIC, "--seed", str(2**31 + 5), "--seconds", "5",
                          "--trace", "0"], capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
