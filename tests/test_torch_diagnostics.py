"""The runtime diagnostics of the port: ``trace_dir`` (the reference wraps
the CLI's run in ``jax.profiler.trace``, the port in
``torch.profiler.profile``) and ``debug_nans`` (the reference sets
``jax_debug_nans``; the port checks ψ after every chunk and the
observables and ψ after every measure, and raises ``NonFiniteError``).

The reference's ``solver.run`` ignores ``trace_dir``; the port's does too,
so the solve is the same with or without it."""

import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_hostlayer import port_config
from wafer_torch import cli, errors as terrors, solver as tsolver
from wafer_torch.io import run_dir as trun_dir
from wafer_torch.ops import stencil
from wafer_torch.ops.observables import Observables
from wafer_torch.parallel import make_mesh
from wafer_torch.parallel.sharded import ShardedOps

CPU = torch.device("cpu")
SPANS = ["wafer.evolve_chunk", "wafer.measure", "wafer.snapshot", "wafer.write_wavefunction"]


def _raw(**over):
    raw = {
        "project_name": "torch diag", "grid": {"size": {"x": 12, "y": 12, "z": 12},
                                               "dn": 0.3, "dt": 0.02},
        "tolerance": 1e-5, "central_difference": "ThreePoint", "wavenum": 0, "wavemax": 0,
        "output": {"screen_update": 50, "snap_update": 100, "file_type": "Json",
                   "save_wavefns": True, "save_potential": False},
        "potential": "Harmonic", "mass": 1.0, "init_condition": "Constant", "sig": 1.0,
        "init_symmetry": "NotConstrained", "max_steps": 100000, "precision": "f32",
    }
    raw.update(over)
    return raw


def _trace_names(trace_dir):
    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return {e["name"] for e in events if "name" in e}


def test_cli_trace_dir_writes_a_chrome_trace(tmp_run, monkeypatch):
    """``trace_dir`` through the CLI: the directory is made, one Chrome
    trace JSON lands in it, and it holds the loop's spans and torch's ops."""
    monkeypatch.setenv("WAFER_DEVICE", "cpu")
    with open("cfg.yaml", "w") as fh:
        yaml.safe_dump(_raw(trace_dir="traces/run1"), fh)
    assert cli.main(["-c", "cfg.yaml"]) == 0
    names = _trace_names("traces/run1")
    assert set(SPANS) <= names
    assert any(n.startswith("aten::") for n in names)


def test_cli_trace_is_written_when_the_run_fails(tmp_run, monkeypatch):
    """As ``jax.profiler.trace`` on leaving its context, the trace is
    written when the run raises (here past ``max_steps``)."""
    monkeypatch.setenv("WAFER_DEVICE", "cpu")
    with open("cfg.yaml", "w") as fh:
        yaml.safe_dump(_raw(trace_dir="trace", max_steps=100, tolerance=1e-12), fh)
    assert cli.main(["-c", "cfg.yaml"]) == 1
    assert {"wafer.measure", "wafer.evolve_chunk"} <= _trace_names("trace")


def test_solver_run_ignores_trace_dir(tmp_run):
    """``solver.run`` ignores ``trace_dir`` (no directory, the same
    trajectory); under a profiler the spans are recorded."""
    from torch.profiler import ProfilerActivity, profile

    results = []
    for over in ({}, {"trace_dir": "never_made"}):
        trun_dir.reset_proj_date()
        cfg = port_config(**{k: v for k, v in _raw(**over).items() if k != "output"},
                          output={"screen_update": 50, "file_type": "Json"})
        trun_dir.check_output_dir(cfg.project_name)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            (res,) = tsolver.run(cfg, device=CPU)
        results.append(res)
        assert {"wafer.measure", "wafer.evolve_chunk"} <= {e.key for e in prof.key_averages()}
    assert not os.path.exists("never_made")
    assert results[0].steps == results[1].steps
    assert torch.equal(results[0].phi, results[1].phi)


def _poison(monkeypatch, module, name, at):
    """``module.name`` returning ψ filled with NaN from its ``at``-th call."""
    calls = [0]
    orig = getattr(module, name)

    def poisoned(*args, **kwargs):
        calls[0] += 1
        out = orig(*args, **kwargs)
        if calls[0] < at:
            return out
        if isinstance(out, list):
            return [torch.full_like(b, float("nan")) for b in out]
        return torch.full_like(out, float("nan"))

    monkeypatch.setattr(module, name, poisoned)


@pytest.mark.parametrize("debug_nans, what", [(True, "ψ after the evolve chunk"), (False, "norm²")])
def test_debug_nans_names_the_chunk(tmp_run, monkeypatch, debug_nans, what):
    """ψ set to NaN by the second chunk: with ``debug_nans`` NonFiniteError
    names that chunk and its step (100); without it the norm² guard raises
    at the next measure, at the same step."""
    _poison(monkeypatch, stencil, "evolve_chunk", at=2)
    cfg = port_config(**{k: v for k, v in _raw(debug_nans=debug_nans).items() if k != "output"},
                      output={"screen_update": 50, "file_type": "Json"})
    with pytest.raises(terrors.NonFiniteError, match=f"non-finite {what} at step 100:"):
        tsolver.run(cfg, device=CPU)


def test_debug_nans_on_a_mesh(tmp_run, monkeypatch):
    """On a mesh every block is checked: NaN from the first chunk raises at
    step 50 naming the chunk."""
    _poison(monkeypatch, ShardedOps, "evolve_chunk", at=1)
    cfg = port_config(**{k: v for k, v in _raw(debug_nans=True).items() if k != "output"},
                      output={"screen_update": 50, "file_type": "Json"}, mesh={"x": 2})
    with pytest.raises(terrors.NonFiniteError, match="ψ after the evolve chunk at step 50:"):
        tsolver.run(cfg, mesh=make_mesh((2, 1, 1), [CPU] * 2))


def test_check_nans_reads_nan_only():
    """The observables are checked in order, a complex energy in both
    parts; Inf passes (as ``jax_debug_nans``: the norm² guard catches it)."""
    phi = torch.zeros(4, 4, 4)
    good = Observables(energy=1.0, norm2=1.0, v_infinity=0.0, r2=1.0)
    tsolver._check_nans(good, phi, "ψ after the measure", 7)
    tsolver._check_nans(good, [phi, torch.full((2, 2), float("inf"))], "ψ", 7)
    for field, name in (("energy", "energy"), ("norm2", "norm²"), ("v_infinity", "V∞"),
                        ("r2", "⟨r²⟩")):
        bad = Observables(**{**good.__dict__, field: float("nan")})
        with pytest.raises(terrors.NonFiniteError, match=f"non-finite {name} at step 7"):
            tsolver._check_nans(bad, phi, "ψ after the measure", 7)
    imag_nan = Observables(**{**good.__dict__, "energy": complex(1.0, float("nan"))})
    with pytest.raises(terrors.NonFiniteError, match="non-finite energy"):
        tsolver._check_nans(imag_nan, phi, "ψ after the measure", 7)
    phi[1, 2, 3] = float("nan")
    with pytest.raises(terrors.NonFiniteError, match="non-finite ψ after the measure at step 7"):
        tsolver._check_nans(good, [torch.zeros(2), phi], "ψ after the measure", 7)


def test_debug_nans_leaves_a_sound_run_as_it_is(tmp_run):
    """A run that stays finite gives the same state with the checks on."""
    results = []
    for flag in (False, True):
        cfg = port_config(**{k: v for k, v in _raw(debug_nans=flag).items() if k != "output"},
                          output={"screen_update": 50, "file_type": "Json"})
        trun_dir.reset_proj_date()
        trun_dir.check_output_dir(cfg.project_name)
        (res,) = tsolver.run(cfg, device=CPU)
        results.append(res)
    assert results[0].steps == results[1].steps
    assert np.array_equal(results[0].phi.numpy(), results[1].phi.numpy())
