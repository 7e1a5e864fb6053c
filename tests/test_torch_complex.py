"""Complex ψ through the port's solver against ``wafer_tpu`` on the same
configuration, with the reference routed to its split-complex driver
(``_solve_split``, as tests/test_complex.py routes it) unless a test says
otherwise.

Oracle: V = (1 + iγ)·r²/2 has E_n = (n + 3/2)·√(1 + iγ) at mass 1.
Seeded Gaussian initial conditions cannot match across packages (a
documented divergence), so tests that compare the two hand both the same
initial pair. Energy tolerance 2e-4 in Re and in Im, as the real slice's
tests; the split f64 run against the reference's native-complex solve
within 1e-6, as tests/test_complex.py holds its own two paths."""

import cmath
import glob
import json
import logging
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import base_config
from wafer_torch import cli as tcli, convert, geometry as tgeo, solver as tsolver
from wafer_torch.models import initial as tinit, potentials as tpot
from wafer_torch.utils.host import DTYPES
from wafer_tpu import solver as jsolver
from wafer_tpu.io import formats, run_dir, writers
from wafer_tpu.models import potentials as jpot
from wafer_tpu.ops import split_complex as jsc

CPU = torch.device("cpu")
LOG = logging.getLogger("wafer")


@pytest.fixture
def split_ref(monkeypatch):
    """Route the reference's complex solves to its split-complex driver."""
    monkeypatch.setattr(jsc, "backend_supports_complex", lambda: False)


def _energies(results):
    return [r.observables.energy / r.observables.norm2 for r in results]


def _close(e_ref, e_out, tol=2e-4):
    for a, b in zip(e_ref, e_out):
        assert abs(a.real - b.real) < tol and abs(a.imag - b.imag) < tol, (e_ref, e_out)


def _both(cfg, **kw):
    run_dir.check_output_dir(cfg.project_name)
    ref = jsolver.run(cfg, **kw)
    run_dir.reset_proj_date()
    run_dir.check_output_dir(cfg.project_name)
    return ref, tsolver.run(cfg, device=CPU, **kw)


def _harmonic(**over):
    raw = dict(
        potential="ComplexHarmonic", absorb=0.2,
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-6, init_condition="Constant",
        output={"screen_update": 100, "file_type": "Json"}, max_steps=100000,
    )
    raw.update(over)
    return base_config(**raw)


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_complex_harmonic_ground_and_excited_match_jax(tmp_run, split_ref, precision):
    """E₀ and E₁ through run → _run_single → solve on (re, im) pairs, with
    the excited seed drawn from the same complex ``_partial`` file."""
    cfg = _harmonic(precision=precision, wavemax=1)
    rng = np.random.default_rng(21)
    seed1 = rng.normal(size=cfg.work_size()) + 1j * rng.normal(size=cfg.work_size())
    with open("input/wavefunction_1_partial.json", "w") as fh:
        fh.write(formats.array_to_json(seed1))
    ref, out = _both(cfg, seed=5)
    e_ref, e_out = _energies(ref), _energies(out)
    _close(e_ref, e_out)
    oracle = [(n + 1.5) * cmath.sqrt(1 + 0.2j) for n in (0, 1)]
    assert abs(e_out[0] - oracle[0]) < 0.01 and abs(e_out[1] - oracle[1]) < 0.05, e_out
    assert all(r.phi.shape[0] == 2 and r.phi.dtype == DTYPES[precision] for r in out)
    (l0r, l0i), (l1r, l1i) = (r.phi.double() for r in out)
    ov = torch.hypot(torch.sum(l0r * l1r + l0i * l1i), torch.sum(l0r * l1i - l0i * l1r))
    assert float(ov) < 1e-4


def test_complex_coulomb_matches_jax(tmp_run, split_ref):
    cfg = base_config(
        potential="ComplexCoulomb", absorb=0.1, init_condition="Coulomb", tolerance=1e-6,
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.5, "dt": 0.05},
        output={"screen_update": 100, "file_type": "Json"}, max_steps=100000,
    )
    ref, out = _both(cfg)
    _close(_energies(ref), _energies(out))
    assert _energies(out)[0].real < 0.0 and out[0].converged


def _cornell(absorb, **over):
    raw = dict(
        potential="ComplexFullCornell", absorb=absorb, mass=4.65, sig=0.223,
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.5, "dt": 0.05},
        tolerance=1e-6, precision="f64", output={"screen_update": 100, "file_type": "Json"},
        max_steps=200000,
    )
    raw.update(over)
    return base_config(**raw)


def test_complex_full_cornell_matches_jax(tmp_run, split_ref):
    """absorb 0 reproduces the real FullCornell run from the same IC;
    absorb 0.2 matches the reference from the same IC pair, with the
    thermal width Im E ≈ 0.2·Re E > 0 and a finite binding energy."""
    ext = 1
    rng = np.random.default_rng(22)
    g = np.pad(rng.normal(size=(16, 16, 16)), ext)
    run_dir.check_output_dir("test")
    real = tsolver._run_single(_cornell(0.0, potential="FullCornell"), LOG,
                               ic_overrides={0: torch.from_numpy(g)}, device=CPU)[0]
    c0 = tsolver._run_single(_cornell(0.0), LOG, ic_overrides={0: convert.pair(g, 0 * g)},
                             device=CPU)[0]
    e_real, e_c0 = _energies([real])[0], _energies([c0])[0]
    assert abs(e_c0.imag) < 1e-10 and abs(e_c0.real - e_real) < 1e-6, (e_real, e_c0)

    cfg = _cornell(0.2)
    ref = jsolver._run_single(cfg, LOG, ic_overrides={0: (jnp.asarray(g), jnp.zeros_like(g))})[0]
    out = tsolver._run_single(cfg, LOG, ic_overrides={0: convert.pair(g, 0 * g)}, device=CPU)[0]
    (e_ref,), (e_out,) = _energies([ref]), _energies([out])
    _close([e_ref], [e_out])
    assert out.converged and e_out.imag > 0.0
    assert abs(e_out.imag - 0.2 * e_out.real) / abs(e_out.real) < 0.2, e_out
    obs = out.observables
    assert np.isfinite(((obs.energy - obs.v_infinity) / obs.norm2).real)


def test_split_f64_matches_native_complex_reference(tmp_run):
    """The port's f64 pairs against the reference's native complex128 solve."""
    cfg = _harmonic(tolerance=1e-7, precision="f64")
    ref, out = _both(cfg)
    e_ref, e_out = _energies(ref)[0], _energies(out)[0]
    assert isinstance(e_ref, complex) and isinstance(e_out, complex)
    assert abs(e_ref.real - e_out.real) < 1e-6 and abs(e_ref.imag - e_out.imag) < 1e-6


def test_split_delayed_gram_gate_matches_jax(tmp_run, split_ref, caplog):
    """The delayed-GS gate, fed the split Rayleigh quotients, engages on
    the split path in both packages and they converge to the same E₁."""
    cfg = _harmonic(wavemax=1, tolerance=1e-6, precision="f64",
                    output={"screen_update": 100, "file_type": "Json"})
    rng = np.random.default_rng(23)
    with open("input/wavefunction_1_partial.json", "w") as fh:
        fh.write(formats.array_to_json(
            rng.normal(size=cfg.work_size()) + 1j * rng.normal(size=cfg.work_size())))
    msgs = {}
    for name, fn in (("ref", lambda c: jsolver.run(c, seed=5)),
                     ("port", lambda c: tsolver.run(c, device=CPU, seed=5))):
        run_dir.reset_proj_date()
        run_dir.check_output_dir(cfg.project_name)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="wafer"):
            msgs[name] = (_energies(fn(cfg))[1], [r.message for r in caplog.records])
    _close([msgs["ref"][0]], [msgs["port"][0]])
    for name in msgs:
        assert any("Delayed re-orthogonalisation engaged" in m for m in msgs[name][1]), name


def _hot_harmonic():
    """A narrow Gaussian in a ComplexHarmonic box: a hot kinetic transient."""
    n, dn, dt = 16, 0.2, 0.012
    x = (np.arange(n) - (n - 1) / 2.0) * dn
    r2 = x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2
    hot = np.exp(-r2 / (2.0 * dn * dn)).astype(np.float32)
    hot = np.pad(hot / np.sqrt(np.sum(hot.astype(np.float64) ** 2)).astype(np.float32), 1)
    # tolerance 1e-5: at 1e-6 the f32 chunk-to-chunk noise decides the
    # converging chunk in either package
    cfg = _harmonic(grid={"size": {"x": n, "y": n, "z": n}, "dn": dn, "dt": dt},
                    precision="f32", tolerance=1e-5, max_steps=60000,
                    output={"screen_update": 200, "file_type": "Json"})
    return cfg, hot


def _noisy_cornell():
    """ComplexFullCornell (the +4m ≈ 18.6 offset, gauge-shifted) from a
    σ = 0.223 noise IC, as examples/complex_cornell.yaml starts."""
    rng = np.random.default_rng(24)
    noise = np.pad(0.223 * rng.normal(size=(16, 16, 16)), 1).astype(np.float32)
    cfg = _cornell(0.2, precision="f32", tolerance=1e-5,
                   output={"screen_update": 500, "file_type": "Json"})
    return cfg, noise


@pytest.mark.parametrize("case", [_hot_harmonic, _noisy_cornell], ids=["hot_harmonic", "cornell"])
def test_split_drift_guard_matches_jax(tmp_run, split_ref, caplog, case):
    """A hot IC pair engages per-step renormalisation on Re(E) − v_shift
    and releases it as E settles, in both packages, to the same E in the
    same number of steps."""
    cfg, re = case()
    run_dir.check_output_dir(cfg.project_name)
    with caplog.at_level(logging.INFO, logger="wafer"):
        ref = jsolver._run_single(cfg, LOG, ic_overrides={
            0: (jnp.asarray(re), jnp.zeros_like(jnp.asarray(re)))})[0]
    ref_msgs = [r.message for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="wafer"):
        out = tsolver._run_single(cfg, LOG, ic_overrides={
            0: convert.pair(re, np.zeros_like(re))}, device=CPU)[0]
    msgs = [r.message for r in caplog.records]
    for m in ("renormalising the ground state every step", "resuming per-chunk normalisation"):
        assert any(m in s for s in ref_msgs) and any(m in s for s in msgs), m
    _close(_energies([ref]), _energies([out]))
    assert ref.steps == out.steps


def test_split_snapshot_lifecycle(tmp_run, monkeypatch):
    """``snap_update``: complex ``wavefunction_0_partial`` files are written
    while running and removed at convergence."""
    partial_writes = []
    orig = writers.wavefunction

    def spy(data, wnum, converged, *a, **k):
        if not converged:
            partial_writes.append(np.iscomplexobj(data))
        return orig(data, wnum, converged, *a, **k)

    monkeypatch.setattr(writers, "wavefunction", spy)
    cfg = _harmonic(output={"screen_update": 100, "snap_update": 100, "file_type": "Json",
                            "save_wavefns": True}, init_symmetry="AboutZ")
    run_dir.check_output_dir(cfg.project_name)
    res = tsolver.run(cfg, device=CPU)[0]
    d = run_dir.get_project_dir(cfg.project_name)
    assert partial_writes and all(partial_writes)
    assert not glob.glob(d + "/wavefunction_0_partial.*")
    with open(d + "/wavefunction_0.json") as fh:
        assert np.iscomplexobj(formats.array_from_json(fh.read()))
    assert abs(res.observables.energy / res.observables.norm2 - 1.5 * cmath.sqrt(1 + 0.2j)) < 0.05


def test_split_restart_from_disk(tmp_run):
    """wavenum 1: the lower state loads from a complex file as an (re, im)
    pair, and the excited state reconverges to the first run's E₁."""
    cfg = _harmonic(wavemax=1, output={"screen_update": 100, "file_type": "Json",
                                       "save_wavefns": True})
    run_dir.check_output_dir(cfg.project_name)
    first = tsolver.run(cfg, device=CPU)
    d = run_dir.get_project_dir(cfg.project_name)
    shutil.copy(d + "/wavefunction_0.json", "input/wavefunction_0.json")
    run_dir.reset_proj_date()
    cfg2 = _harmonic(wavenum=1, wavemax=1)
    run_dir.check_output_dir(cfg2.project_name)
    again = tsolver.run(cfg2, device=CPU)
    assert [r.wnum for r in again] == [1] and again[0].phi.shape[0] == 2
    assert not again[0].phi.is_complex()
    assert abs(_energies(again)[0] - _energies(first)[1]) < 5e-3


def test_split_initial_conditions_and_potentials_match_jax():
    """The split IC rule (the real counterpart's generator, zero im part),
    the per-component clone perturbation, and the split potential bundle
    (pairs, with the real counterpart's gauge shift and V(∞) array)."""
    from wafer_tpu.models import initial as jinit

    common = dict(precision="f64", init_condition="Coulomb", init_symmetry="AboutY",
                  mass=4.65, sig=0.223,
                  grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02})
    cfg = base_config(potential="ComplexFullCornell", absorb=0.2, **common)
    real_cfg = base_config(potential="FullCornell", **common)
    pair = tinit.set_initial_conditions(cfg)
    np.testing.assert_allclose(pair[0].numpy(), np.asarray(jinit.set_initial_conditions(real_cfg)),
                               rtol=1e-12, atol=1e-14)
    assert float(pair[1].abs().max()) == 0.0

    p = tinit.perturb_clone(cfg, pair, 1, seed=3)
    assert torch.equal(p, tinit.perturb_clone(cfg, pair, 1, seed=3))
    rms = lambda t: float(torch.sqrt(torch.mean(tgeo.work_area(t, 1) ** 2)))  # noqa: E731
    assert 0.9e-3 < rms(p[1]) / rms(pair[0]) < 1.1e-3  # im noise at the re rms
    assert not torch.equal(p[0] - pair[0], p[1])  # the components draw apart

    pots = tpot.load_arrays(cfg)
    vr, vi = jpot.generate_split(cfg)
    np.testing.assert_allclose(pots.v.numpy(), np.stack([vr, vi]), rtol=1e-12)
    real_pots = jpot.load_arrays(real_cfg)
    assert pots.v_shift == pytest.approx(real_pots.v_shift, rel=1e-12)
    ar, ai, br, bi = jpot.build_ab_split(vr, vi, cfg.grid.dt, real_pots.v_shift)
    np.testing.assert_allclose(pots.a.numpy(), np.stack([ar, ai]), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(pots.b.numpy(), np.stack([br, bi]), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(pots.pot_sub_array.numpy(), np.asarray(real_pots.pot_sub_array),
                               rtol=1e-12)


def test_cli_prints_complex_energy(tmp_run, capsys, monkeypatch):
    """A complex run through the CLI prints Im(E), and the shared writer's
    summary carries ``energy_im``; the observables file keeps the
    reference's fields (Re E)."""
    import yaml

    raw = {
        "project_name": "torch cplx", "grid": {"size": {"x": 12, "y": 12, "z": 12},
                                               "dn": 0.3, "dt": 0.02},
        "tolerance": 1e-5, "central_difference": "ThreePoint", "wavenum": 0, "wavemax": 0,
        "output": {"screen_update": 100, "file_type": "Json", "save_wavefns": False,
                   "save_potential": True},
        "potential": "ComplexHarmonic", "absorb": 0.2, "mass": 1.0,
        "init_condition": "Constant", "sig": 1.0, "init_symmetry": "NotConstrained",
        "max_steps": 100000, "precision": "f32",
    }
    with open("cplx.yaml", "w") as fh:
        yaml.safe_dump(raw, fh)
    summaries = []
    orig = writers.finalise_measurement
    monkeypatch.setattr(writers, "finalise_measurement",
                        lambda *a, **k: summaries.append(orig(*a, **k)) or summaries[-1])
    monkeypatch.setenv("WAFER_DEVICE", "cpu")
    assert tcli.main(["-c", "cplx.yaml"]) == 0
    assert "Im(energy)" in capsys.readouterr().out
    (summary,) = summaries
    assert 0.1 < summary["energy_im"] < 0.2 and 1.5 < summary["energy"] < 1.7  # 12³ box
    d = run_dir.get_project_dir("torch cplx")
    with open(os.path.join(d, "observables_0.json")) as fh:
        assert json.load(fh)["energy"] == pytest.approx(summary["energy"])
    assert os.path.exists(os.path.join(d, "potential.json"))
