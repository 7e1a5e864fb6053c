"""``sync_update`` batching in the port on the CPU (counterpart of
wafer_tpu's ``pick_batch_k`` / ``make_batched_runner``): the batch
planner against the reference's, the port's batched solves against its
own per-chunk solves (f64: the same steps, energies within 1e-12, ψ bit
for bit) on one device, for pairs, on flat and multi-slice meshes and
under multigrid, and against the reference's batched solve (energies
within 2e-4, the cross-package bound of tests/test_torch_solver.py).

Idle chunks after the device's verdict compute on the CPU (the plain
sweeps ignore the kernels' done flag) and their work is discarded by the
batch's masks, so the results are the per-chunk ones."""

import glob
import itertools
import logging
import os

import numpy as np
import pytest
import torch

from tests.test_torch_hostlayer import configs, port_config
from wafer_torch import batch as tbatch, errors as terrors, solver as tsolver
from wafer_torch.io import run_dir as trun_dir, writers as twriters
from wafer_torch.ops import stencil
from wafer_torch.parallel import make_mesh
from wafer_torch.parallel.multislice import make_multislice_mesh
from wafer_tpu import solver as jsolver
from wafer_tpu.io import formats, run_dir

CPU = torch.device("cpu")

# the reference's sync tests (tests/test_solver.py:466-501): Gaussian IC,
# f64, delayed_gram off on both sides (it is inactive under batching)
COMMON = dict(
    grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.25, "dt": 0.015},
    tolerance=1e-7, potential="Harmonic", init_condition="Gaussian",
    output={"screen_update": 50, "file_type": "Json"}, max_steps=100000, wavemax=1,
    delayed_gram=False,
)


def _run(cfg, mesh=None, seed=9):
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(cfg.project_name)
    return tsolver.run(cfg, device=CPU, seed=seed, mesh=mesh)


def _energy(r):
    return r.observables.energy / r.observables.norm2


# --------------------------------------------------------------------------- #
# the planner
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("su", [1, 50, 100])
@pytest.mark.parametrize("k_sync", [1, 2, 3, 4, 8, 16])
def test_pick_batch_k_matches_reference(k_sync, su):
    """Over steps × snap_update × max_steps, the cases of the reference's
    tail-ladder and snapshot tests (tests/test_solver.py:533, :561)
    included."""
    for snap, max_steps in itertools.product((None, 150, 200, 1000), (None, 700, 1000, 1234)):
        for step in range(0, 2000 + su, su):
            ref = jsolver.pick_batch_k(step, k_sync, su, snap, max_steps)
            assert tsolver.pick_batch_k(step, k_sync, su, snap, max_steps) == ref, (
                step, k_sync, su, snap, max_steps)
    assert tsolver.pick_batch_k is tbatch.pick_batch_k


# --------------------------------------------------------------------------- #
# batched against per-chunk in the port (f64: bit for bit)
# --------------------------------------------------------------------------- #


def _mesh(shape, slices=1):
    n = slices * shape[0] * shape[1] * shape[2]
    if slices > 1:
        return make_multislice_mesh(shape, slices, [CPU] * n)
    return make_mesh(shape, [CPU] * n)


CASES = {
    "real": (dict(), None),
    "pair": (dict(potential="ComplexHarmonic", absorb=0.2,
                  grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02}), None),
    "mesh_2x1x1": (dict(mesh={"x": 2}), lambda: _mesh((2, 1, 1))),
    "mesh_2x2x1": (dict(mesh={"x": 2, "y": 2}), lambda: _mesh((2, 2, 1))),
    "multislice_2x2x1x1": (dict(mesh={"x": 2, "slices": 2, "slice_update": 2}),
                           lambda: _mesh((2, 1, 1), 2)),
    "multigrid_2_mesh": (dict(multigrid=[2], mesh={"x": 2}), lambda: _mesh((2, 1, 1))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_equals_per_chunk(tmp_run, case):
    """sync_update 8 against 1 on the same config and seed: every state at
    the same step, E/N within 1e-12, ψ bit for bit; more than one batch a
    state (one at multigrid's final level), and the chunks after each
    state's verdict counted idle."""
    extra, mesh = CASES[case]
    results = []
    for sync in (1, 8):
        cfg = port_config(**{**COMMON, **extra}, sync_update=sync)
        results.append(_run(cfg, mesh() if mesh else None))
    for ref, out in zip(*results):
        assert out.steps == ref.steps, (case, ref.wnum, ref.steps, out.steps)
        assert abs(_energy(out) - _energy(ref)) < 1e-12, (case, _energy(ref), _energy(out))
        assert torch.equal(out.phi, ref.phi), case
        assert ref.batch is None
        # the final multigrid level starts from the converged coarse state
        assert out.batch["batches"] >= (1 if "multigrid" in case else 2)
        assert out.batch["captures"] == 0
        assert 1 <= out.batch["idle_chunks"] <= 8


def test_batched_multigrid_levels(tmp_run):
    """multigrid [2] on one device: each level batched equals per-chunk."""
    results = []
    for sync in (1, 4):
        cfg = port_config(**{**COMMON, "multigrid": [2], "wavemax": 0}, sync_update=sync)
        results.append(_run(cfg))
    (ref,), (out,) = results
    assert out.steps == ref.steps and torch.equal(out.phi, ref.phi)
    assert out.observables == ref.observables


def test_f32_drift_guard_engaging_mid_run(tmp_run, caplog):
    """f32 on a (2, 2, 2) mesh with a hot Gaussian IC (the reference's
    test_sharded_sync_update_f32_precision): the drift guard engages and
    releases mid-run; a batch applies its verdict at the next batch, so
    the trajectories agree to f32 rounding: the same steps, E/N within
    1e-5."""
    common = dict(
        precision="f32", grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.25, "dt": 0.015},
        tolerance=1e-5, potential="Harmonic", init_condition="Gaussian",
        output={"screen_update": 100, "file_type": "Json"}, max_steps=100000,
        mesh={"x": 2, "y": 2, "z": 2},
    )
    results = []
    with caplog.at_level(logging.INFO, logger="wafer"):
        for sync in (1, 8):
            results.append(_run(port_config(**common, sync_update=sync), _mesh((2, 2, 2))))
    assert "renormalising the ground state every step" in caplog.text
    (ref,), (out,) = results
    assert out.steps == ref.steps
    assert abs(_energy(out) - _energy(ref)) < 1e-5, (_energy(ref), _energy(out))


# --------------------------------------------------------------------------- #
# against the reference's batched solve
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("potential", ["Harmonic", "ComplexHarmonic"])
def test_batched_matches_jax_batched(tmp_run, monkeypatch, potential):
    """sync_update 8 in both packages on the same raw config: E₀ and E₁
    from a Constant IC and the same excited seed file (seeded ICs differ
    across packages) at the same steps, E/N within 2e-4."""
    from wafer_tpu.ops import split_complex as jsc

    monkeypatch.setattr(jsc, "backend_supports_complex", lambda: False)
    jcfg, tcfg = configs(
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-6, potential=potential, absorb=0.2, init_condition="Constant",
        output={"screen_update": 50, "file_type": "Json"}, max_steps=20000, wavemax=1,
        delayed_gram=False, sync_update=8,
    )
    rng = np.random.default_rng(11)
    field = rng.normal(size=jcfg.work_size())
    if potential.startswith("Complex"):
        field = field + 1j * rng.normal(size=jcfg.work_size())
    with open("input/wavefunction_1_partial.json", "w") as fh:
        fh.write(formats.array_to_json(field))
    run_dir.check_output_dir(jcfg.project_name)
    ref = jsolver.run(jcfg, seed=5)
    out = _run(tcfg, seed=5)
    for r, o in zip(ref, out):
        assert o.steps == r.steps, (r.wnum, r.steps, o.steps)
        assert abs(_energy(o) - _energy(r)) < 2e-4, (r.wnum, _energy(r), _energy(o))


# --------------------------------------------------------------------------- #
# the per-chunk loop's cadence, guards and gates under batching
# --------------------------------------------------------------------------- #


def test_max_steps_and_snapshots_under_batching(tmp_run, monkeypatch):
    """The reference's max_steps/snapshot case (tests/test_solver.py:504):
    MaxStepError at the same step as per-chunk (the unconverged ψ written
    after the break is the same bits), and the partial file written at the
    same steps."""
    common = dict(
        grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.25, "dt": 0.015},
        tolerance=1e-30, potential="Harmonic", init_condition="Gaussian",
        output={"screen_update": 50, "snap_update": 150, "file_type": "Json",
                "save_wavefns": True},
        max_steps=700,
    )
    writes = {}
    orig = twriters.wavefunction

    def spy(data, wnum, converged, *a, **k):
        writes.setdefault(sync, []).append((converged, np.array(data)))
        return orig(data, wnum, converged, *a, **k)

    monkeypatch.setattr(twriters, "wavefunction", spy)
    for sync in (1, 8):
        with pytest.raises(terrors.MaxStepError):
            _run(port_config(**common, sync_update=sync), seed=4)
        d = trun_dir.get_project_dir("test")
        assert glob.glob(d + "/wavefunction_0_partial.*"), os.listdir(d)
    # snapshots at steps 0..750 by 150, then the unconverged ψ after the break
    assert len(writes[8]) == len(writes[1]) == 7
    for (c1, a1), (c8, a8) in zip(writes[1], writes[8]):
        assert c1 == c8 and np.array_equal(a1, a8)


def test_delayed_gram_is_inactive_under_batching(tmp_run, caplog):
    """delayed_gram on (the default) under batching: the gate stays off,
    the reference's message is logged, and the run equals delayed_gram
    off bit for bit."""
    results = []
    with caplog.at_level(logging.INFO, logger="wafer"):
        for dg in (True, False):
            results.append(_run(port_config(**{**COMMON, "delayed_gram": dg}, sync_update=8)))
    assert "delayed_gram is inactive under sync_update batching" in caplog.text
    assert "Delayed re-orthogonalisation engaged" not in caplog.text
    for a, b in zip(*results):
        assert a.steps == b.steps and torch.equal(a.phi, b.phi)


@pytest.mark.parametrize("sync", [1, 8])
def test_debug_nans_under_batching(tmp_run, monkeypatch, sync):
    """ψ made NaN by the second chunk: per-chunk and batched both raise
    NonFiniteError at that chunk's step (200), the batched loop at the
    first replayed row whose observables are NaN."""
    calls = [0]
    orig = stencil.evolve_chunk

    def poisoned(*args, **kwargs):
        calls[0] += 1
        out = orig(*args, **kwargs)
        return out.fill_(float("nan")) if calls[0] == 2 else out

    monkeypatch.setattr(stencil, "evolve_chunk", poisoned)
    cfg = port_config(**{**COMMON, "wavemax": 0,
                         "output": {"screen_update": 100, "file_type": "Json"}},
                      debug_nans=True, sync_update=sync)
    with pytest.raises(terrors.NonFiniteError, match="at step 200"):
        _run(cfg)


def test_batch_makes_one_host_read(tmp_run, monkeypatch):
    """Between a batch's first chunk and its read no tensor is read on the
    host: every reading method of a tensor is counted while the runner
    iterates, and the batch's rows are read once after."""
    reads = []
    inside = [False]
    names = ("tolist", "item", "__float__", "__int__", "__bool__", "__complex__", "numpy", "cpu")
    for name in names:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            if inside[0]:
                reads.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    orig_iter = tbatch.BatchRunner._iterations
    orig_read = tbatch.BatchRunner._read
    batches = [0]

    def iterations(self, *args, **kwargs):
        inside[0] = True
        try:
            orig_iter(self, *args, **kwargs)
        finally:
            inside[0] = False

    def read(self, rows, k):
        before = len(reads)
        inside[0] = True
        try:
            out = orig_read(self, rows, k)
        finally:
            inside[0] = False
        assert reads[before:] == ["tolist"]
        del reads[before:]
        batches[0] += 1
        return out

    monkeypatch.setattr(tbatch.BatchRunner, "_iterations", iterations)
    monkeypatch.setattr(tbatch.BatchRunner, "_read", read)
    for extra, mesh in (CASES["real"], CASES["pair"], CASES["mesh_2x2x1"]):
        _run(port_config(**{**COMMON, **extra}, sync_update=4), mesh() if mesh else None)
    assert batches[0] >= 6 and reads == []


def test_timer_adds_its_intervals():
    """The chunk timer sums every start/stop pair until it is read (a
    batch stops it around a capture)."""
    timer = tsolver._ChunkTimer(CPU)
    assert timer.read() is None
    for _ in range(3):
        timer.start()
        timer.stop()
    first = timer.read()
    assert first is not None and first >= 0.0 and timer.total == first
    assert timer.read() is None


def test_cli_runs_batches(tmp_run, monkeypatch, capsys):
    """``sync_update: 4`` through ``wafer_torch.cli`` on the CPU: the run
    converges, writes its observables, and logs the eager route."""
    import yaml

    from wafer_torch import cli

    raw = {
        "project_name": "torch batch cli", "grid": {"size": {"x": 12, "y": 12, "z": 12},
                                                    "dn": 0.3, "dt": 0.02},
        "tolerance": 1e-5, "central_difference": "ThreePoint", "wavenum": 0, "wavemax": 1,
        "output": {"screen_update": 50, "file_type": "Json", "save_wavefns": False,
                   "save_potential": False},
        "potential": "Harmonic", "mass": 1.0, "init_condition": "Constant", "sig": 1.0,
        "init_symmetry": "NotConstrained", "max_steps": 100000, "precision": "f32",
        "sync_update": 4,
    }
    with open("batch.yaml", "w") as fh:
        yaml.safe_dump(raw, fh)
    monkeypatch.setenv("WAFER_DEVICE", "cpu")
    assert cli.main(["-c", "batch.yaml"]) == 0
    assert "1st excited state energy" in capsys.readouterr().out
    d = trun_dir.get_project_dir("torch batch cli")
    assert os.path.exists(os.path.join(d, "observables_1.json"))
    with open(os.path.join(d, "simulation.log")) as fh:
        assert "batches of up to 4 chunks a host read, run eagerly (no CUDA device)" in fh.read()
