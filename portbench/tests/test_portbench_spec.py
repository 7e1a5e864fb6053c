"""BENCHMARK.json keeps to the benchmark's contract, every file it names
loads, and each metric reader's arithmetic holds on a synthetic run."""

import json
import math
import re

import pytest

from portbench import spec
from portbench.record import Record, Solve, Trace

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_keys(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    texts = [entry[k] for k in ("why", "layer") if k in entry]
    if "file" in entry:
        texts.append(entry["source"])
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs_load_and_are_used():
    used = {c["config"] for c in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        raw = spec.load_json(spec.ROOT / c["file"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert raw["source"] == c["source"] and raw["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in used


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cells_load_and_build_the_ports_config(cell, tmp_path):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    mix = spec.traffic(cell["traffic"])
    raw = spec.run_raw(spec.configuration(cell["config"]), mix)
    config = spec.port_config(raw, tmp_path)
    assert config.wavemax == mix["wavemax"] and config.wavenum == 0
    assert config.precision == "f32" and config.sync_update is None and config.delayed_gram
    assert not config.output.save_wavefns and not config.output.save_potential
    assert config.output_root.startswith(str(tmp_path))
    limits = spec.limits(cell["name"])
    assert limits and all(v > 0 for v in limits.values())


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs) == len(set(CELLS))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_readers_load(metric):
    assert callable(spec.reader(metric["name"]))
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if metric in BENCH["end_to_end"] else {"layer", "moves"}
    assert set(metric) <= allowed
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_end_to_end_bounds_and_moves():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and len(names) == len(BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert m["moves"] in names
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"solve loop", "chunk graph", "measure", "chunk drivers", "kernels", "device"}
    for cell in CELLS:
        assert any(cell in m.get("workloads", [cell]) for m in BENCH["per_layer"])


def synthetic():
    """Two finished jobs and a traced stretch of known sums on a 4³ grid."""
    trace = Trace(window_s=2.0, device_ops=[
        ("void (anonymous namespace)::sweep_step_kernel<1, 0, false, 1>(SweepArgs)", 0.0, 0.5, 0),
        ("void (anonymous namespace)::sweep_step_bf16_wide_kernel<1, false, false>(SweepArgs, int)", 0.6, 0.3, 5),
        ("void (anonymous namespace)::finish_coef_kernel<256>(double const*, int)", 0.9, 2e-6, 5),
        ("void (anonymous namespace)::sweep_step_sc_kernel<1, 0, false>(SweepArgs)", 1.0, 0.2, 0),
    ], spans=[("portbench.state.0", 0.0, 0.55), ("wafer.measure", 0.5, 0.1),
              ("portbench.state.5", 0.55, 1.0), ("wafer.measure", 0.92, 0.03)])
    return Record(grid=(4, 4, 4), b_streams=False, setup_s=7.5, window_s=10.0,
                  chunk_steps=5000,
                  solves=[Solve(seconds=4.0, steps=2000, chunk_seconds=3.0, capture_ms=10.0),
                          Solve(seconds=2.0, steps=1000, chunk_seconds=1.0, capture_ms=20.0)],
                  trace=trace)


def test_metric_arithmetic():
    rec = synthetic()
    read = lambda name: spec.reader(name)(rec)  # noqa: E731
    assert read("setup_s") == 7.5
    assert read("update_rate") == pytest.approx(64 * 5000 / 10.0 / 1e9)
    assert read("solve_s") == pytest.approx(3.0)
    assert read("steps_per_solve") == pytest.approx(1500.0)
    assert read("host_share") == pytest.approx(100 * (1 - 4.0 / 6.0))
    assert read("capture_ms") == pytest.approx(15.0)
    assert read("chunk_rate") == pytest.approx(64 * 3000 / 4.0 / 1e9)
    assert read("measure_ms") == pytest.approx(65.0)
    assert read("k2_us") == pytest.approx(2.0)
    busy = 0.5 + 0.3 + 2e-6 + 0.2
    assert read("device_idle") == pytest.approx(100 * (1 - busy / 2.0))
    padded = 6 ** 3
    k1 = (8 * padded) / 3.35e12 + (8 * padded + 2 * 5 * padded) / 3.35e12
    assert read("k1_roofline") == pytest.approx(100 * k1 / 0.8)
    assert read("k3_roofline") == pytest.approx(100 * (16 * padded / 3.35e12) / 0.2)


def test_readers_return_nothing_without_their_source():
    rec = Record(grid=(4, 4, 4), b_streams=True, setup_s=1.0, window_s=1.0, chunk_steps=0)
    for m in BENCH["per_layer"]:
        assert spec.reader(m["name"])(rec) is None
    assert spec.reader("solve_s")(rec) is None
    assert spec.reader("update_rate")(rec) == 0.0
    assert not math.isnan(spec.reader("setup_s")(rec))
