"""The port's solver slice on the CPU against ``wafer_tpu.solver`` on the
same configuration and initial conditions.

Seeded initial conditions cannot match across packages (jax.random vs
torch.Generator, a documented divergence), so excited states start from
the same ``input/wavefunction_1_partial.json`` drawn from a numpy seed,
as tests/test_solver.py does. Energy tolerance 2e-4, as there."""

import logging
import math
import os

import numpy as np
import pytest
import torch

from tests.test_torch_hostlayer import configs, port_config
from wafer_torch import cli as tcli, errors as terrors, solver as tsolver
from wafer_torch.errors import NotPortedError
from wafer_torch.io import run_dir as trun_dir
from wafer_tpu import errors, solver as jsolver
from wafer_tpu.io import formats, run_dir

CPU = torch.device("cpu")
LOG = logging.getLogger("wafer")


def _energies(results):
    return [r.observables.energy / r.observables.norm2 for r in results]


def _both(cfgs, **kw):
    """Run the reference and the port on their configs ``cfgs`` (from
    :func:`configs`), each in its package's own run directory."""
    jcfg, tcfg = cfgs
    run_dir.check_output_dir(jcfg.project_name)
    ref = jsolver.run(jcfg, **kw)
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(tcfg.project_name)
    out = tsolver.run(tcfg, device=CPU, **kw)
    return ref, out


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_harmonic_ground_and_first_excited_match_jax(tmp_run, precision):
    """E₀ and E₁ of the 3D oscillator through run → _run_single → solve,
    with per-step Gram-Schmidt and the default-on delayed-GS gate."""
    cfg, tcfg = configs(
        precision=precision,
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-5,
        init_condition="Constant",
        output={"screen_update": 50, "file_type": "Json"},
        max_steps=20000,
        wavemax=1,
    )
    rng = np.random.default_rng(11)
    with open("input/wavefunction_1_partial.json", "w") as fh:
        fh.write(formats.array_to_json(rng.normal(size=cfg.work_size())))
    ref, out = _both((cfg, tcfg), seed=5)
    e_ref, e_out = _energies(ref), _energies(out)
    assert [r.wnum for r in out] == [0, 1]
    for a, b in zip(e_ref, e_out):
        assert abs(a - b) < 2e-4, (e_ref, e_out)
    assert abs(e_out[0] - 1.5) < 0.05 and abs(e_out[1] - 2.5) < 0.1
    phi0, phi1 = out[0].phi.double(), out[1].phi.double()
    ov = float(torch.sum(phi0 * phi1)) / math.sqrt(float(torch.sum(phi0 ** 2) * torch.sum(phi1 ** 2)))
    assert abs(ov) < 1e-4
    assert all(r.chunk_seconds > 0.0 for r in out)


def test_excited_per_step_gram_schmidt_matches_jax(tmp_run):
    """delayed_gram off: every excited chunk projects at every step."""
    cfg, tcfg = configs(
        precision="f32", delayed_gram=False,
        grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-5, output={"screen_update": 50, "file_type": "Json"},
        max_steps=20000, wavemax=1,
    )
    rng = np.random.default_rng(12)
    with open("input/wavefunction_1_partial.json", "w") as fh:
        fh.write(formats.array_to_json(rng.normal(size=cfg.work_size())))
    ref, out = _both((cfg, tcfg), seed=5)
    for a, b in zip(_energies(ref), _energies(out)):
        assert abs(a - b) < 2e-4


@pytest.mark.parametrize(
    "overrides",
    [
        # hydrogenic ground state (Coulomb IC, clamped singularity)
        dict(potential="Coulomb", init_condition="Coulomb", tolerance=1e-6,
             grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.5, "dt": 0.05}),
        # 7-point stencil, ext = 3 halo handling
        dict(central_difference="SevenPoint", tolerance=1e-6,
             grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.008}),
        # deep well (V = −100): f32 overflow unless the drift guard engages
        dict(potential="Dodecahedron", precision="f32", tolerance=1e-4,
             grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.01},
             output={"screen_update": 200, "file_type": "Json"}),
    ],
    ids=["coulomb", "sevenpoint", "deep_well_f32"],
)
def test_oracle_configs_match_jax(tmp_run, overrides):
    overrides = {"output": {"screen_update": 100, "file_type": "Json"},
                 "max_steps": 100000, **overrides}
    ref, out = _both(configs(**overrides))
    (e_ref,), (e_out,) = _energies(ref), _energies(out)
    assert out[0].converged and abs(e_ref - e_out) < 2e-4, (e_ref, e_out)


def test_delayed_gram_equivalence(tmp_run):
    """Delayed re-orthogonalisation (default) vs per-step projection
    converge to the same excited energy, as the reference's
    test_delayed_gram_equivalence requires of it."""
    common = dict(
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.015},
        tolerance=1e-8, init_condition="Constant", wavemax=1,
        output={"screen_update": 100, "file_type": "Json"}, max_steps=300000,
    )
    rng = np.random.default_rng(13)
    with open("input/wavefunction_1_partial.json", "w") as fh:
        fh.write(formats.array_to_json(rng.normal(size=(16, 16, 16))))
    energies = []
    for delayed in (False, True):
        trun_dir.reset_proj_date()
        cfg = port_config(delayed_gram=delayed, **common)
        trun_dir.check_output_dir(cfg.project_name)
        res = tsolver.run(cfg, device=CPU)
        energies.append(_energies(res)[1])
        phi0, phi1 = res[0].phi, res[1].phi
        ov = float(torch.sum(phi0 * phi1)) / math.sqrt(
            float(torch.sum(phi0 ** 2) * torch.sum(phi1 ** 2)))
        assert abs(ov) < 1e-6
    assert abs(energies[0] - energies[1]) < 100 * 1e-8, energies


def test_run_without_a_device_runs_on_the_cli_device(tmp_run, monkeypatch):
    """solver.run with neither a device nor a mesh takes the CLI's device:
    under WAFER_DEVICE=cpu the CPU, with the energy of an explicit CPU run."""
    monkeypatch.setenv("WAFER_DEVICE", "cpu")
    kw = dict(grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.3, "dt": 0.02},
              tolerance=1e-4, output={"screen_update": 50, "file_type": "Json"},
              max_steps=100000)
    energies = []
    for device in (None, CPU):
        trun_dir.reset_proj_date()
        cfg = port_config(**kw)
        trun_dir.check_output_dir(cfg.project_name)
        (res,) = tsolver.run(cfg) if device is None else tsolver.run(cfg, device=device)
        assert res.converged and res.phi.device.type == "cpu"
        energies.append(_energies([res])[0])
    assert energies[0] == energies[1]


def test_run_without_a_device_or_a_card_raises(tmp_run, monkeypatch):
    """Without WAFER_DEVICE and without CUDA, solver.run names the missing
    card instead of falling back to the CPU."""
    monkeypatch.delenv("WAFER_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(terrors.DeviceUnavailableError, match="no CUDA device"):
        tsolver.run(port_config())


def test_max_steps_guard_matches_jax(tmp_run):
    cfg, tcfg = configs(
        grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.2, "dt": 0.01},
        tolerance=1e-30, output={"screen_update": 50, "file_type": "Json"}, max_steps=100,
    )
    run_dir.check_output_dir(cfg.project_name)
    trun_dir.check_output_dir(tcfg.project_name)
    with pytest.raises(errors.MaxStepError):
        jsolver.run(cfg)
    with pytest.raises(terrors.MaxStepError):
        tsolver.run(tcfg, device=CPU)


def test_nonfinite_guard_matches_jax(tmp_run):
    """SevenPoint at dt 0.029, dn 0.3 is unstable in f32: both packages
    abort non-finite instead of converging."""
    cfg, tcfg = configs(
        central_difference="SevenPoint", precision="f32",
        grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.3, "dt": 0.029},
        tolerance=1e-30, output={"screen_update": 200, "file_type": "Json"}, max_steps=100000,
    )
    run_dir.check_output_dir(cfg.project_name)
    trun_dir.check_output_dir(tcfg.project_name)
    with pytest.raises(errors.NonFiniteError):
        jsolver.run(cfg)
    with pytest.raises(terrors.NonFiniteError):
        tsolver.run(tcfg, device=CPU)


def test_drift_guard_engages_and_matches_jax(tmp_run, caplog):
    """A hot IC engages per-step renormalisation and releases it once E
    settles (hysteresis), in both packages, to the same energy."""
    n, dn, dt = 16, 0.2, 0.012
    x = (np.arange(n) - (n - 1) / 2.0) * dn
    r2 = x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2
    hot = np.exp(-r2 / (2.0 * dn * dn)).astype(np.float32)
    hot /= np.sqrt(np.sum(hot.astype(np.float64) ** 2)).astype(np.float32)
    hot = np.pad(hot, 1)
    cfg, tcfg = configs(
        grid={"size": {"x": n, "y": n, "z": n}, "dn": dn, "dt": dt},
        tolerance=1e-6, precision="f32",
        output={"screen_update": 200, "file_type": "Json"}, max_steps=60000,
    )
    run_dir.check_output_dir(cfg.project_name)
    trun_dir.check_output_dir(tcfg.project_name)
    import jax.numpy as jnp

    with caplog.at_level(logging.INFO, logger="wafer"):
        ref = jsolver._run_single(cfg, LOG, ic_overrides={0: jnp.asarray(hot)})[0]
    ref_msgs = [r.message for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="wafer"):
        out = tsolver._run_single(tcfg, LOG, ic_overrides={0: torch.from_numpy(hot)}, device=CPU)[0]
    msgs = [r.message for r in caplog.records]
    for m in ("renormalising the ground state every step", "resuming per-chunk normalisation"):
        assert any(m in s for s in ref_msgs) and any(m in s for s in msgs), m
    assert abs(_energies([ref])[0] - _energies([out])[0]) < 2e-4
    assert ref.steps == out.steps


def test_snapshot_lifecycle(tmp_run):
    """``snap_update`` writes ``wavefunction_0_partial`` while running and
    removes it at convergence (reference: src/grid.rs:137-158)."""
    cfg = port_config(
        grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-5, precision="f32", max_steps=20000,
        output={"screen_update": 50, "snap_update": 100, "file_type": "Json",
                "save_wavefns": True},
    )
    trun_dir.check_output_dir(cfg.project_name)
    res = tsolver.run(cfg, device=CPU)[0]
    d = trun_dir.get_project_dir(cfg.project_name)
    assert os.path.exists(d + "/wavefunction_0.json")
    assert not os.path.exists(d + "/wavefunction_0_partial.json")
    assert res.converged and res.steps >= 100


def test_cli_writes_observables(tmp_run, capsys, monkeypatch):
    import yaml

    raw = {
        "project_name": "torch cli", "grid": {"size": {"x": 12, "y": 12, "z": 12},
                                              "dn": 0.3, "dt": 0.02},
        "tolerance": 1e-5, "central_difference": "ThreePoint", "wavenum": 0, "wavemax": 0,
        "output": {"screen_update": 100, "file_type": "Json", "save_wavefns": True,
                   "save_potential": True},
        "potential": "Harmonic", "mass": 1.0, "init_condition": "Constant", "sig": 1.0,
        "init_symmetry": "NotConstrained", "max_steps": 100000, "precision": "f32",
    }
    with open("test.yaml", "w") as fh:
        yaml.safe_dump(raw, fh)
    monkeypatch.setenv("WAFER_DEVICE", "cpu")
    assert tcli.main(["-c", "test.yaml"]) == 0
    out = capsys.readouterr().out
    assert "Ground state energy" in out and "Simulation complete" in out
    d = trun_dir.get_project_dir("torch cli")
    for name in ("observables_0.json", "wavefunction_0.json", "potential.json",
                 "simulation.log", "test.yaml"):
        assert os.path.exists(os.path.join(d, name)), name


@pytest.mark.parametrize(
    "overrides, item",
    [
        ({"mesh": {"x": 2, "slices": 2}}, "A10b"),
        ({"multigrid": [2], "mesh": {"x": 2, "slices": 2}}, "A10b"),
        ({"sync_update": 4}, "A9b"),
        ({"trace_dir": "trace"}, "A11"),
        ({"debug_nans": True}, "A11"),
    ],
)
def test_unported_features_raise(tmp_run, overrides, item):
    cfg = port_config(grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.2, "dt": 0.004},
                      **overrides)
    with pytest.raises(NotPortedError, match=f"ROADMAP.md {item}\\)") as exc:
        tsolver.run(cfg, device=CPU)
    assert isinstance(exc.value, terrors.ConfigParseError)


def test_backend_resolution():
    """auto → the kernel only for f32 on a CUDA device; pallas demands it;
    xla forces the plain ops (tests run on the CPU)."""
    phi32, phi64 = torch.zeros(4, 4, 4), torch.zeros(4, 4, 4, dtype=torch.float64)
    assert tsolver._resolve_backend(port_config(precision="f32"), phi32) == "plain"
    assert tsolver._resolve_backend(port_config(), phi64) == "plain"
    assert tsolver._resolve_backend(port_config(backend="xla"), phi32) == "plain"
    with pytest.raises(terrors.ConfigParseError):
        tsolver._resolve_backend(port_config(precision="f32", backend="pallas"), phi32)
    meta = torch.zeros(4, 4, 4, device="meta")
    assert tsolver._resolve_backend(port_config(precision="f32"), meta) == "plain"


def test_host_helpers_match_jax():
    cfg, tcfg = configs(tolerance=1e-6, output={"screen_update": 100})
    for order in ("ThreePoint", "FivePoint", "SevenPoint"):
        for dn, m in ((0.3, 1.0), (0.2, 2.5)):
            assert tsolver.stable_dt_bound(order, dn, m) == jsolver.stable_dt_bound(order, dn, m)
    for step, old, new in ((500, 1e-1, 1e-2), (0, float("inf"), 1e-2), (300, 1e-3, 2e-3),
                           (100, 0.0, 1e-3), (700, 3e-4, 1e-4)):
        assert tsolver.eta(step, old, new, tcfg) == jsolver.eta(step, old, new, cfg)


# --------------------------------------------------------------------------- #
# the ported gate logic, fed the same scalar sequences as the reference
# (tests/test_solver.py: test_delayed_gram_gate_hysteresis,
# test_delayed_gram_state_learns_regrowth,
# test_drift_guard_disengages_after_transient)
# --------------------------------------------------------------------------- #


def test_delayed_gram_gate_matches_jax():
    log = logging.getLogger("test")
    for engaged in (False, True):
        for de in np.linspace(0.0, 25.0, 251):
            for measured in (None, 1e-7, 5e-5, 2e-4, 3e-2):
                for delta0 in (1e-6, 1e-4):
                    args = (engaged, 1.5 + de, 1.5, 0.01, 100, 1e-6, log)
                    kw = dict(measured_delta=measured, delta0=delta0)
                    assert tsolver.delayed_gram_gate(*args, **kw) == jsolver.delayed_gram_gate(
                        *args, **kw
                    )
    # the reference test's fixed points
    assert tsolver.delayed_gram_gate(False, 2.5, 1.5, 0.01, 100, 1e-6, log)
    assert not tsolver.delayed_gram_gate(True, 41.5, 1.5, 0.01, 100, 1e-6, log)


def test_delayed_gram_state_matches_jax():
    """The quark-like regrowth sequence of the reference test: release,
    learned δ₀, cooldown, decay back to delayed mode — step for step."""
    log = logging.getLogger("test")
    kw = dict(dt=0.003, su=500, tolerance=1e-6, log=log)
    seq = [(2.023, None), (2.023, 2.5e-2)] + [(2.023, 1e-7)] * 50
    seq += [(2.023, 3e-4), (1.9, 1e-7), (1.7, 2e-4)] + [(1.6, 1e-8)] * 20
    st_t, st_j = tsolver.DelayedGramState(), jsolver.DelayedGramState()
    engaged = []
    for energy, measured in seq:
        a = st_t.update(energy, 1.5, measured_delta=measured, **kw)
        b = st_j.update(energy, 1.5, measured_delta=measured, **kw)
        assert a == b and st_t.delta0 == st_j.delta0
        engaged.append(a)
    assert engaged[0] and not engaged[1] and st_t.engaged is engaged[-1]
    assert any(engaged[20:52])  # the decayed δ₀ re-admits delayed mode


def test_drift_guard_matches_jax():
    log = logging.getLogger("test")
    energies = [900.0, 400.0, 160.0, 40.0, 12.0, 5.0, 1.6, 1.5, 300.0, 1.5]
    for efold in (60.0, 600.0):
        st_t = st_j = False
        for e in energies:
            st_t = tsolver.drift_guard(st_t, e, 0.25, 0.012, 200, efold, log)
            st_j = jsolver.drift_guard(st_j, e, 0.25, 0.012, 200, efold, log)
            assert st_t == st_j


def test_release_log_prints_the_compared_threshold(caplog):
    """The port logs the release threshold it compares against
    (_DGS_RELEASE_DELTA), not 100·δ₀ of a learned δ₀."""
    log = logging.getLogger("wafer.test")
    with caplog.at_level(logging.INFO, logger="wafer.test"):
        assert not tsolver.delayed_gram_gate(
            True, 2.0, 1.5, 0.003, 500, 1e-6, log, measured_delta=5e-3, delta0=6e-5,
        )
    (msg,) = [r.message for r in caplog.records]
    assert "exceeds the 1e-04 release threshold" in msg
    assert tsolver._DGS_RELEASE_DELTA == jsolver._DGS_RELEASE_DELTA


def test_cli_banner_counts_the_platform_devices(tmp_run, capsys, monkeypatch):
    """The banner prints the devices of the run's platform that the process
    sees, as the reference prints ``len(jax.devices())``: 1 on the CPU,
    ``torch.cuda.device_count()`` on CUDA."""
    import yaml

    raw = {
        "project_name": "torch banner", "grid": {"size": {"x": 12, "y": 12, "z": 12},
                                                 "dn": 0.3, "dt": 0.02},
        "tolerance": 1e-4, "central_difference": "ThreePoint", "wavenum": 0, "wavemax": 0,
        "output": {"screen_update": 100, "file_type": "Json", "save_wavefns": False,
                   "save_potential": False},
        "potential": "Harmonic", "mass": 1.0, "init_condition": "Constant", "sig": 1.0,
        "init_symmetry": "NotConstrained", "max_steps": 100000, "precision": "f32",
    }
    with open("banner.yaml", "w") as fh:
        yaml.safe_dump(raw, fh)
    monkeypatch.setenv("WAFER_DEVICE", "cpu")
    assert tcli.main(["-c", "banner.yaml"]) == 0
    assert "Parallel tasks running on 1 cpu." in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tcli.device_count(torch.device("cuda", 0)) == 4
    assert tcli.device_count(CPU) == 1
