"""Multigrid in the port (``solver._run_multigrid``): the coarse→fine level
ladder against ``wafer_tpu``'s on the same schedules, against the port's own
direct run, and the hand-over ``_upsample_state`` against the reference's.

The schedule and its base configuration are tests/test_multigrid.py's. The
Gaussian IC's noise cannot reproduce jax.random (a documented divergence),
so the two packages start from different draws and meet at the same
converged fixed point."""

import cmath
import glob
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_hostlayer import configs
from wafer_torch import solver as tsolver
from wafer_torch.errors import ConfigParseError
from wafer_torch.io import run_dir as trun_dir
from wafer_tpu import solver as jsolver
from wafer_tpu.io import formats, run_dir
from wafer_tpu.models import potentials as jpot
from wafer_tpu.ops import split_complex as jsc

CPU = torch.device("cpu")


def _mg(**over):
    """(reference config, port config) of tests/test_multigrid.py's base:
    32³ Harmonic, Gaussian IC seed 7, tolerance 1e-7."""
    base = dict(
        grid={"size": {"x": 32, "y": 32, "z": 32}, "dn": 0.2, "dt": 0.012},
        tolerance=1e-7, potential="Harmonic", init_condition="Gaussian",
        output={"screen_update": 100, "file_type": "Json"}, max_steps=200000, seed=7,
    )
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            base[k] = {**base[k], **v}
        else:
            base[k] = v
    return configs(**base)


def _energy(r):
    return r.observables.energy / r.observables.norm2


def _run_port(cfg):
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(cfg.project_name)
    return tsolver.run(cfg, device=CPU)


def _run_ref(cfg):
    run_dir.reset_proj_date()
    run_dir.check_output_dir(cfg.project_name)
    return jsolver.run(cfg)


def test_multigrid_matches_jax_and_own_direct_run(tmp_run, caplog):
    """The [2] schedule, two states: the port's energies within 2e-4 of the
    reference's multigrid run, the same level log lines, and against the
    port's own direct run the same fixed point (5e-6) in fewer fine-level
    steps."""
    jcfg, tcfg = _mg(wavemax=1, multigrid=[2])
    with caplog.at_level(logging.INFO, logger="wafer"):
        ref = _run_ref(jcfg)
    ref_msgs = [r.message for r in caplog.records if r.message.startswith("Multigrid level")]
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="wafer"):
        mg = _run_port(tcfg)
    msgs = [r.message for r in caplog.records if r.message.startswith("Multigrid level")]
    assert msgs == ref_msgs == [
        "Multigrid level 1/2: 16 x 16 x 16 (dn=0.4, dt=0.048, tol=1e-07)",
        "Multigrid level 2/2: 32 x 32 x 32 (dn=0.2, dt=0.012, tol=1e-07)",
    ]
    assert [r.wnum for r in mg] == [r.wnum for r in ref] == [0, 1]
    for r_ref, r_mg in zip(ref, mg):
        assert abs(_energy(r_ref) - _energy(r_mg)) < 2e-4, (r_ref.wnum, _energy(r_ref),
                                                            _energy(r_mg))
        assert r_mg.phi.shape == (34, 34, 34) and r_mg.converged

    direct = _run_port(_mg(wavemax=1)[1])
    for r_d, r_mg in zip(direct, mg):
        assert abs(_energy(r_d) - _energy(r_mg)) < 5e-6, (r_d.wnum, _energy(r_d), _energy(r_mg))
        assert r_mg.steps < r_d.steps, (r_d.wnum, r_d.steps, r_mg.steps)


def test_multigrid_two_coarse_levels_and_tolerance_match_jax(tmp_run, caplog):
    """A [4, 2] ladder with a looser multigrid_tolerance on the coarse
    levels, f32: the same level grids and tolerances logged, and the same
    final energy as the reference."""
    jcfg, tcfg = _mg(multigrid=[4, 2], multigrid_tolerance=1e-5, tolerance=1e-6,
                     precision="f32")
    with caplog.at_level(logging.INFO, logger="wafer"):
        ref = _run_ref(jcfg)[0]
    ref_msgs = [r.message for r in caplog.records if r.message.startswith("Multigrid level")]
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="wafer"):
        out = _run_port(tcfg)[0]
    msgs = [r.message for r in caplog.records if r.message.startswith("Multigrid level")]
    assert msgs == ref_msgs == [
        "Multigrid level 1/3: 8 x 8 x 8 (dn=0.8, dt=0.192, tol=1e-05)",
        "Multigrid level 2/3: 16 x 16 x 16 (dn=0.4, dt=0.048, tol=1e-05)",
        "Multigrid level 3/3: 32 x 32 x 32 (dn=0.2, dt=0.012, tol=1e-06)",
    ]
    assert out.phi.dtype == torch.float32
    assert abs(_energy(ref) - _energy(out)) < 2e-4, (_energy(ref), _energy(out))


def test_multigrid_intermediate_levels_write_no_wavefunctions(tmp_run):
    """Intermediate levels leave no coarse-size wavefunction, snapshot or
    potential file; the final level honours the configured output."""
    cfg = _mg(multigrid=[2], output={"save_wavefns": True, "save_potential": True,
                                     "snap_update": 200})[1]
    _run_port(cfg)
    d = trun_dir.get_project_dir(cfg.project_name)
    (wf,) = glob.glob(d + "/wavefunction_0.*")
    with open(wf) as fh:
        assert json.load(fh)["dim"] == [32, 32, 32]  # the final work size
    with open(d + "/potential.json") as fh:
        assert json.load(fh)["dim"] == [32, 32, 32]
    assert not glob.glob(d + "/wavefunction_0_partial.*")


def test_multigrid_complex_pair_matches_jax(tmp_run, monkeypatch):
    """ComplexHarmonic on the [2] schedule: the (re, im) pair upsamples
    componentwise, converges to the complex oracle and to the reference's
    split-complex multigrid energy."""
    monkeypatch.setattr(jsc, "backend_supports_complex", lambda: False)
    calls = []
    orig = tsolver._upsample_state

    def spy(phi, cfg_to):
        out = orig(phi, cfg_to)
        calls.append((tuple(phi.shape), tuple(out.shape)))
        return out

    monkeypatch.setattr(tsolver, "_upsample_state", spy)
    jcfg, tcfg = _mg(potential="ComplexHarmonic", absorb=0.2, tolerance=1e-6,
                     grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
                     init_condition="Constant", multigrid=[2])
    ref = _run_ref(jcfg)[0]
    out = _run_port(tcfg)[0]
    assert calls == [((2, 10, 10, 10), (2, 18, 18, 18))]
    assert out.phi.shape == (2, 18, 18, 18) and not out.phi.is_complex()
    e_ref, e_out = _energy(ref), _energy(out)
    assert abs(e_out - 1.5 * cmath.sqrt(1 + 0.2j)) < 0.05, e_out
    assert abs(e_ref.real - e_out.real) < 2e-4 and abs(e_ref.imag - e_out.imag) < 2e-4


def test_multigrid_from_file_potential_matches_jax(tmp_run):
    """A FromFile potential: each coarse level loads the same file and the
    port's readers resample it with the port's trilerp."""
    jcfg, _t = _mg(grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02})
    v = np.asarray(jpot.generate(jcfg))
    with open("input/potential.json", "w") as fh:
        fh.write(formats.array_to_json(v[1:-1, 1:-1, 1:-1]))
    jff, tff = _mg(grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
                   tolerance=1e-6, potential="FromFile", multigrid=[2])
    ref = _run_ref(jff)[0]
    out = _run_port(tff)[0]
    assert abs(_energy(ref) - _energy(out)) < 2e-4, (_energy(ref), _energy(out))


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("sym", ["NotConstrained", "AntisymAboutZ", "AboutY"])
@pytest.mark.parametrize("order", ["ThreePoint", "SevenPoint"])
def test_upsample_state_matches_jax(order, sym, precision):
    """``_upsample_state`` gives the reference's array bit for bit: trilerp
    in f64, cast to the level dtype, the zero shell, the symmetry."""
    jcfg, tcfg = _mg(central_difference=order, init_symmetry=sym, precision=precision)
    ext = tcfg.central_difference.ext
    dtype = np.float32 if precision == "f32" else np.float64
    w = np.random.default_rng(8).standard_normal((16 + 2 * ext,) * 3).astype(dtype)
    ref = np.asarray(jsolver._upsample_state(jnp.asarray(w), jcfg))
    out = tsolver._upsample_state(torch.from_numpy(w), tcfg)
    assert out.dtype == tcfg.real_dtype and out.shape == ref.shape == (32 + 2 * ext,) * 3
    assert np.array_equal(out.numpy(), ref)
    assert float(out[:ext].abs().max()) == 0.0 and float(out[:, :, -ext:].abs().max()) == 0.0


def test_upsample_state_pair_is_componentwise():
    """A (re, im) pair upsamples as its two components, each the reference's
    split upsample."""
    jcfg, tcfg = _mg(potential="ComplexHarmonic", absorb=0.2, precision="f32")
    rng = np.random.default_rng(9)
    re, im = (rng.standard_normal((18, 18, 18)).astype(np.float32) for _ in range(2))
    ref = jsolver._upsample_state((jnp.asarray(re), jnp.asarray(im)), jcfg)
    out = tsolver._upsample_state(torch.from_numpy(np.stack([re, im])), tcfg)
    assert out.shape == (2, 34, 34, 34)
    for c in range(2):
        assert np.array_equal(out[c].numpy(), np.asarray(ref[c]))
        assert torch.equal(out[c], tsolver._upsample_state(torch.from_numpy((re, im)[c]), tcfg))


def test_multigrid_over_processes_needs_a_mesh(tmp_run, monkeypatch):
    """Multigrid in a process of a multi-process run (``WAFER_COORDINATOR``;
    the start patched) without a multi-device mesh raises ConfigParseError
    before level 1: the coarse levels are not solved first."""
    from tests.test_torch_distributed import fake_start

    def no_solve(*a, **k):
        raise AssertionError("a level was solved")

    monkeypatch.setattr(tsolver, "_run_single", no_solve)
    monkeypatch.setattr(tsolver, "solve", no_solve)
    fake_start(monkeypatch)
    cfg = _mg(multigrid=[2])[1]
    with pytest.raises(ConfigParseError, match=r"multi-process run.*multi-device mesh"):
        tsolver.run(cfg, device=CPU)


def test_multigrid_sync_update_matches_per_chunk(tmp_run):
    """``sync_update: 4`` (once refused) under multigrid [2], two states:
    every level batched equals the per-chunk run (f64: the same steps and
    observables, ψ bit for bit)."""
    results = []
    for sync in (1, 4):
        cfg = _mg(multigrid=[2], sync_update=sync, wavemax=1, delayed_gram=False,
                  grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.4, "dt": 0.024})[1]
        results.append(_run_port(cfg))
    for a, b in zip(*results):
        assert a.steps == b.steps and a.observables == b.observables, (a.wnum, a.steps, b.steps)
        assert torch.equal(a.phi, b.phi) and b.batch["batches"] >= 1
