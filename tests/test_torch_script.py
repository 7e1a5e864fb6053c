"""``FromScript`` potentials (``io/script.py`` and the ``FROM_SCRIPT``
branch of ``models/potentials.load_arrays``) through the port against
``wafer_tpu`` on the CPU.

The repo's ``gen_potential.py`` (a 3D Pöschl-Teller well, λ = 6: the exact
continuum E₀ is −54, E₁ −48.5) makes a 16³ FivePoint f64 potential. Both
CLIs run it on one device, E₀ and then E₁ from the same
``input/wavefunction_1_partial.json`` drawn from a numpy seed (the
packages' seeded initial conditions differ by design); ``solver.run`` runs
it again on a (2, 1, 1) CPU mesh in each package. ``potential.json`` must
be byte-identical and the energies agree within 1e-10 relative: the same
f64 arithmetic on the same potential, in another summation order."""

import json
import logging
import os
import shutil
import stat

import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_hostlayer import REPO, configs, raw_config
from wafer_torch import cli as tcli, errors as terrors, solver as tsolver
from wafer_torch.io import run_dir as trun_dir
from wafer_torch.models import potentials as tpot
from wafer_torch.parallel import make_mesh
from wafer_tpu import cli as jcli, errors as jerrors, solver as jsolver
from wafer_tpu.io import formats, run_dir as jrun_dir
from wafer_tpu.models import potentials as jpot

LOG = logging.getLogger("wafer")
CPU = torch.device("cpu")
PROJECT = "script well"
REL = 1e-10
# 16³ FivePoint f64 in a 6.4-wide box; dt 0.01 is well inside the
# FivePoint bound dn²·m·12/(16·6)
RAW = dict(
    project_name=PROJECT, precision="f64", central_difference="FivePoint",
    potential="FromScript", grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.4, "dt": 0.01},
    tolerance=1e-9, max_steps=40000, wavemax=1,
    output={"screen_update": 100, "file_type": "Json", "save_wavefns": False,
            "save_potential": True},
)


def _rundir(root, name, partial):
    """A run directory under ``root`` holding an executable copy of the
    repo's gen_potential.py, the config and the excited state's start."""
    d = root / name
    (d / "input").mkdir(parents=True)
    (d / "output").mkdir()
    script = d / "gen_potential.py"
    shutil.copy(os.path.join(REPO, "gen_potential.py"), script)
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    with open(d / "cfg.yaml", "w") as fh:
        yaml.safe_dump(raw_config(**RAW), fh)
    with open(d / "input" / "wavefunction_1_partial.json", "w") as fh:
        fh.write(formats.array_to_json(partial))
    return d


def _partial():
    cfg, _t = configs(**RAW)
    return np.random.default_rng(19).normal(size=cfg.work_size())


def _observables(d):
    (proj,) = [p for p in (d / "output").iterdir() if p.name.startswith("script_well")]
    energies = []
    for wnum in (0, 1):
        with open(proj / f"observables_{wnum}.json") as fh:
            energies.append(json.load(fh)["energy"])
    return proj, energies


def test_from_script_cli_matches_reference(tmp_path, monkeypatch):
    """Both CLIs on one device: ``potential.json`` byte for byte, and E₀,
    E₁ within 1e-10 relative (and near the Pöschl-Teller levels)."""
    partial = _partial()
    ref_dir, port_dir = _rundir(tmp_path, "ref", partial), _rundir(tmp_path, "port", partial)
    monkeypatch.chdir(ref_dir)
    jrun_dir.reset_proj_date()
    assert jcli.main(["-c", "cfg.yaml"]) == 0
    monkeypatch.chdir(port_dir)
    monkeypatch.setenv("WAFER_DEVICE", "cpu")
    trun_dir.reset_proj_date()
    assert tcli.main(["-c", "cfg.yaml"]) == 0
    ref_proj, e_ref = _observables(ref_dir)
    port_proj, e_port = _observables(port_dir)
    assert (port_proj / "potential.json").read_bytes() == (ref_proj / "potential.json").read_bytes()
    for a, b in zip(e_ref, e_port):
        assert abs(a - b) <= REL * abs(a), (e_ref, e_port)
    assert -54.0 < e_port[0] < -53.5 and -48.8 < e_port[1] < -48.0, e_port


def test_from_script_mesh_matches_reference(tmp_run):
    """``solver.run`` on a (2, 1, 1) mesh, the port's shards on the CPU and
    the reference's on two virtual CPU devices: E₀ and E₁ within 1e-10
    relative."""
    script = tmp_run / "gen_potential.py"
    shutil.copy(os.path.join(REPO, "gen_potential.py"), script)
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    jcfg, tcfg = configs(**{**RAW, "mesh": {"x": 2}})
    for cfg in (jcfg, tcfg):
        cfg.script_location = "./gen_potential.py"
    with open("input/wavefunction_1_partial.json", "w") as fh:
        fh.write(formats.array_to_json(_partial()))
    jrun_dir.reset_proj_date()
    jrun_dir.check_output_dir(jcfg.project_name)
    ref = jsolver.run(jcfg, LOG)
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(tcfg.project_name)
    out = tsolver.run(tcfg, LOG, mesh=make_mesh((2, 1, 1), [CPU] * 2))
    assert [o.wnum for o in out] == [r.wnum for r in ref] == [0, 1]
    for r, o in zip(ref, out):
        e_r = r.observables.energy / r.observables.norm2
        e_o = o.observables.energy / o.observables.norm2
        assert abs(e_r - e_o) <= REL * abs(e_r), (r.wnum, e_r, e_o)


def test_from_script_without_a_script_raises_the_reference_error():
    """A FromScript config with no script location: ``load_arrays`` raises
    the reference's error, with its message."""
    jcfg, tcfg = configs(**RAW)
    jcfg.script_location = tcfg.script_location = None
    with pytest.raises(jerrors.ScriptNotFoundError) as j_err:
        jpot.load_arrays(jcfg, LOG)
    with pytest.raises(terrors.ScriptNotFoundError) as t_err:
        tpot.load_arrays(tcfg, LOG, device=CPU)
    assert str(t_err.value) == str(j_err.value)
    assert isinstance(t_err.value, terrors.WaferError)
