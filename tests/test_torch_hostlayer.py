"""The port's own host layer against ``wafer_tpu``'s: the YAML schema and its
validation, the error hierarchy, the five file formats (byte for byte),
the run directory, the terminal text and the trilinear resampler.

The port keeps a copy of each module, so the two packages' classes and
enums are distinct objects. :func:`configs` builds each package its own
``Config`` from one raw dict; the other ``test_torch_*`` files use it to
hand the reference and the port the same configuration."""

import copy
import dataclasses
import enum
import glob
import inspect
import logging
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from tests.conftest import base_config
from wafer_torch import config as tconfig, errors as terrors, solver as tsolver
from wafer_torch.io import readers as treaders, run_dir as trun_dir, writers as twriters
from wafer_torch.io.trilerp import trilerp_resize
from wafer_torch.ops import hopper_stencil
from wafer_torch.utils import terminal as tterm
from wafer_tpu import config as jconfig, errors as jerrors
from wafer_tpu.io import readers as jreaders, run_dir as jrun_dir, writers as jwriters
from wafer_tpu.io.trilerp import trilerp_resize as j_trilerp_resize
from wafer_tpu.utils import terminal as jterm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG = logging.getLogger("wafer")
CPU = torch.device("cpu")

# the defaults of tests/conftest.base_config
_BASE = {
    "project_name": "test",
    "grid": {"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.1, "dt": 3e-3},
    "tolerance": 1e-6,
    "central_difference": "ThreePoint",
    "max_steps": None,
    "wavenum": 0,
    "wavemax": 0,
    "output": {
        "screen_update": 100,
        "snap_update": None,
        "file_type": "Csv",
        "save_wavefns": False,
        "save_potential": False,
    },
    "potential": "Harmonic",
    "mass": 1.0,
    "init_condition": "Constant",
    "sig": 1.0,
    "init_symmetry": "NotConstrained",
}


def raw_config(**overrides) -> dict:
    """``base_config``'s raw dict with ``overrides`` merged in depth."""
    raw = copy.deepcopy(_BASE)

    def deep_update(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                deep_update(dst[k], v)
            else:
                dst[k] = copy.deepcopy(v)

    deep_update(raw, overrides)
    return raw


def port_config(**overrides) -> tconfig.Config:
    """The port's ``Config`` of ``base_config(**overrides)``."""
    return tconfig.Config.from_dict(raw_config(**overrides))


def configs(**overrides):
    """(reference ``Config``, port ``Config``) from one raw dict."""
    return jconfig.Config.from_dict(raw_config(**overrides)), port_config(**overrides)


def fields(cfg) -> dict:
    """A config's fields, enums by value, for comparison across packages."""

    def plain(x):
        if isinstance(x, enum.Enum):
            return x.value
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, list):
            return [plain(v) for v in x]
        return x

    return plain(dataclasses.asdict(cfg))


@pytest.mark.parametrize(
    "overrides",
    [{}, {"precision": "f32", "central_difference": "SevenPoint", "wavemax": 2},
     {"potential": "ComplexHarmonic", "absorb": 0.2, "multigrid": [2], "mesh": {"x": 2}}],
)
def test_config_helper_matches_base_config(overrides):
    """``configs`` builds what ``base_config`` builds, in each package."""
    j, t = configs(**overrides)
    assert isinstance(t, tconfig.Config) and not isinstance(t, jconfig.Config)
    assert fields(j) == fields(t) == fields(base_config(**overrides))


_EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*.yaml"))) + [
    os.path.join(REPO, "wafer.yaml")
]


@pytest.mark.parametrize("path", _EXAMPLES, ids=os.path.basename)
def test_example_configs_parse_alike(path):
    """Every shipped config parses to equal fields, prints the same table
    and maps its precision to the same dtypes in each package."""
    j = jconfig.Config.load(path, setup_output=False)
    t = tconfig.Config.load(path, setup_output=False)
    assert fields(j) == fields(t)
    assert j.pretty(100) == t.pretty(100) and j.pretty(80) == t.pretty(80)
    assert (j.padded_size(), j.work_size()) == (t.padded_size(), t.work_size())
    assert str(t.real_dtype) == f"torch.{np.dtype(j.real_dtype).name}"
    assert str(t.dtype) == f"torch.{np.dtype(j.dtype).name}"


def _mg_raw(**over):
    """tests/test_multigrid.py's base configuration."""
    base = dict(
        grid={"size": {"x": 32, "y": 32, "z": 32}, "dn": 0.2, "dt": 0.012},
        tolerance=1e-7, potential="Harmonic", init_condition="Gaussian",
        output={"screen_update": 100, "file_type": "Json"}, max_steps=200000, seed=7,
    )
    base.update(over)
    return raw_config(**base)


_INVALID = {
    # tests/test_multigrid.py:35-47
    "non-divisor": _mg_raw(multigrid=[3]),
    "not decreasing": _mg_raw(multigrid=[2, 2]),
    "coarse too small": _mg_raw(multigrid=[8]),
    "divisor < 2": _mg_raw(multigrid=[1]),
    "restart": _mg_raw(multigrid=[2], wavenum=1, wavemax=1),
    "looser tolerance": _mg_raw(multigrid=[2], multigrid_tolerance=1e-9),
    "empty schedule": _mg_raw(multigrid=[]),
    # the other validation rules and the parse errors
    "large dt": raw_config(grid={"dt": 0.01}),
    "wavenum > wavemax": raw_config(wavenum=2, wavemax=1),
    "precision": raw_config(precision="f16"),
    "backend": raw_config(backend="cuda"),
    "mesh": raw_config(mesh={"x": 0}),
    "slice_update": raw_config(mesh={"slice_update": 0}),
    "sync_update": raw_config(sync_update=0),
    "unknown potential": raw_config(potential="Square"),
    "missing key": {k: v for k, v in raw_config().items() if k != "mass"},
    "bad number": raw_config(tolerance="tight"),
}


@pytest.mark.parametrize("name", sorted(_INVALID))
def test_invalid_configs_raise_alike(name):
    """The same error class name and message in each package; the port's
    classes come from its own hierarchy."""
    with pytest.raises(jerrors.WaferError) as j:
        jconfig.Config.from_dict(copy.deepcopy(_INVALID[name]))
    with pytest.raises(terrors.WaferError) as t:
        tconfig.Config.from_dict(copy.deepcopy(_INVALID[name]))
    assert type(t.value).__name__ == type(j.value).__name__
    assert str(t.value) == str(j.value)
    assert not isinstance(t.value, jerrors.WaferError)


def test_error_hierarchy_is_copied():
    """Every reference error class has a port class of the same name, with
    bases of the same names; the port's own errors derive from them."""
    ref = dict(inspect.getmembers(jerrors, inspect.isclass))
    port = dict(inspect.getmembers(terrors, inspect.isclass))
    for name, cls in ref.items():
        assert [b.__name__ for b in port[name].__mro__] == [b.__name__ for b in cls.__mro__]
    for name in ("DeviceUnavailableError", "DistributedInitError", "KernelCompileError",
                 "KernelLaunchError", "ChunkGraphError"):
        assert issubclass(port[name], terrors.WaferError)
    assert str(terrors.LoadWavefunctionError(3)) == str(jerrors.LoadWavefunctionError(3))
    assert str(terrors.NonFiniteError("norm²", 7)) == str(jerrors.NonFiniteError("norm²", 7))


def _write_all(writers, run_dir, config_cls, root, ft, arrays):
    """Every file a run writes, through one package's writers."""
    cfg = config_cls.from_dict(raw_config(
        project_name="host layer", potential="SimpleCornell", mass=4.65, sig=0.223,
        output={"file_type": ft},
    ))
    cfg.output_root = root
    run_dir.check_output_dir(cfg.project_name, root)
    real, cplx = arrays
    writers.wavefunction(real, 0, True, cfg.project_name, cfg.output.file_type, output_root=root)
    writers.wavefunction(cplx, 1, False, cfg.project_name, cfg.output.file_type,
                         output_root=root)
    writers.potential(real * 3.0, cfg.project_name, cfg.output.file_type, output_root=root)
    writers.potential_sub(cfg)
    obs = SimpleNamespace(energy=3.0625, norm2=2.0, v_infinity=1.25, r2=0.75)
    out = writers.finalise_measurement(obs, 0, 16.0, cfg.project_name, cfg.output.file_type,
                                       output_root=root)
    return run_dir.get_project_dir(cfg.project_name, root), cfg, out


@pytest.mark.parametrize("ft", [f.value for f in jconfig.FileType])
def test_writers_write_identical_bytes(tmp_run, capsys, ft):
    """The same arrays through each package's writers give byte-identical
    files (wavefunctions real and complex, potential, pot_sub, observables),
    and each package's readers read them back."""
    rng = np.random.default_rng(31)
    real = rng.normal(size=(5, 4, 6))
    cplx = real + 1j * rng.normal(size=(5, 4, 6))
    dirs = {}
    for tag, mods in (("ref", (jwriters, jrun_dir, jconfig.Config)),
                      ("port", (twriters, trun_dir, tconfig.Config))):
        dirs[tag], cfg, summary = _write_all(*mods, f"out_{tag}", ft, (real, cplx))
        dirs[tag + "_summary"] = summary
    assert dirs["ref_summary"] == dirs["port_summary"]
    names = sorted(os.listdir(dirs["ref"]))
    assert names == sorted(os.listdir(dirs["port"]))
    assert len(names) == 5, names  # ψ₀, ψ₁ partial, V, pot_sub, observables
    for name in names:
        with open(os.path.join(dirs["ref"], name), "rb") as a, \
                open(os.path.join(dirs["port"], name), "rb") as b:
            assert a.read() == b.read(), name
    ext = jconfig.FileType(ft).extension
    for wnum, data in ((0, real), (1, cplx)):
        suffix = "" if wnum == 0 else "_partial"
        shutil.copy(os.path.join(dirs["port"], f"wavefunction_{wnum}{suffix}{ext}"), "input")
        args = (wnum, (7, 6, 8), 2, jconfig.FileType(ft), LOG)
        got_j = jreaders.wavefunction(*args, input_dir="input")
        got_t = treaders.wavefunction(*args[:3], tconfig.FileType(ft), LOG, input_dir="input")
        np.testing.assert_array_equal(got_t, got_j)
        np.testing.assert_array_equal(got_t[1:-1, 1:-1, 1:-1], data)


def test_readers_resample_alike(tmp_run):
    """A restart from a coarser file resamples through the port's trilerp
    to the reference's array, bit for bit."""
    from wafer_tpu.io import formats

    rng = np.random.default_rng(32)
    with open("input/wavefunction_0.json", "w") as fh:
        fh.write(formats.array_to_json(rng.normal(size=(6, 5, 7))))
    args = (0, (14, 12, 10), 2)
    got_j = jreaders.wavefunction(*args, jconfig.FileType.JSON, LOG, input_dir="input")
    got_t = treaders.wavefunction(*args, tconfig.FileType.JSON, LOG, input_dir="input")
    assert got_t.dtype == got_j.dtype and np.array_equal(got_t, got_j)


@pytest.mark.parametrize("direction", ["up", "down", "same"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_trilerp_bit_identical(dtype, direction):
    """The port's torch trilerp on the CPU gives the reference's numpy
    result bit for bit (f64, as numpy promotes)."""
    src, dst = {"up": ((9, 6, 11), (17, 12, 21)), "down": ((16, 13, 10), (7, 5, 9)),
                "same": ((6, 7, 8), (6, 7, 8))}[direction]
    v = np.random.default_rng(33).normal(size=src).astype(dtype)
    ref = j_trilerp_resize(v, dst)
    out = trilerp_resize(torch.from_numpy(v), dst)
    assert out.dtype == torch.float64 and ref.dtype == np.float64
    assert np.array_equal(out.numpy(), ref)


def test_native_codec_builds_into_kernels_dir(tmp_run):
    """The port's host codec builds from its own copy of the source into
    the gitignored ``_kernels/`` directory and tracks no binary; its bytes
    are the reference's."""
    from wafer_torch import native as tnative
    from wafer_tpu import native as jnative

    pkg = os.path.dirname(tnative.__file__)
    assert os.path.exists(os.path.join(pkg, "src", "wafer_native.cpp"))
    assert not glob.glob(os.path.join(pkg, "*.so")) and not glob.glob(os.path.join(pkg, "src", "*.so"))
    a = np.random.default_rng(34).normal(size=(3, 4, 5))
    if tnative.available():
        assert os.path.dirname(tnative._lib_path()).endswith(os.path.join("wafer_torch", "_kernels"))
        assert tnative.csv_encode(a) == jnative.csv_encode(a)
        assert tnative.mpk_encode(a) == jnative.mpk_encode(a)


def test_run_dir_state_is_per_package():
    trun_dir.reset_proj_date()
    jrun_dir.reset_proj_date()
    d = trun_dir.proj_date()
    assert trun_dir._PROJDATE == d and jrun_dir._PROJDATE is None
    for name in ("a b", ".hidden", "x/y", "ok-name_1.2"):
        assert trun_dir.sanitize_string(name) == jrun_dir.sanitize_string(name)


def test_terminal_text_matches(capsys):
    obs = SimpleNamespace(energy=3.0, norm2=2.0, v_infinity=0.5, r2=1.5)
    summary = {"state": 2, "energy": 1.5, "binding_energy": 1.25, "r": 0.8, "l_r": 20.0}
    texts = []
    for term in (jterm, tterm):
        term.print_banner("abc1234", 1, "cpu")
        for wnum in (0, 1, 12):
            term.print_observable_header(wnum)
        print(term.print_measurements(0.0, 1e-3, obs))
        print(term.print_measurements(2.5, 1e-3, obs))
        term.print_summary(summary)
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1]


def test_port_refuses_a_reference_config(tmp_run):
    """The reference's enums miss every lookup keyed on the port's (analytic
    B would silently fall to streamed B), so the port refuses its config."""
    j, t = configs()
    with pytest.raises(TypeError, match="wafer_torch.config.Config"):
        tsolver.run(j, device=CPU)
    with pytest.raises(TypeError, match="wafer_torch.config.Config"):
        tsolver._run_single(j, LOG, device=CPU)
    with pytest.raises(TypeError, match="wafer_torch.config.Config"):
        tsolver.solve(j, LOG, 3, None, 0, [], device=CPU)
    tconfig.require_port_config(t)
    assert hopper_stencil.analytic_params(t, 0.0) is not None
    assert hopper_stencil.analytic_params(j, 0.0) is None


def test_config_load_sets_up_the_port_run_dir(tmp_run):
    with open("cfg.yaml", "w") as fh:
        yaml.safe_dump(raw_config(project_name="load me"), fh)
    trun_dir.reset_proj_date()
    cfg = tconfig.Config.load("cfg.yaml")
    d = trun_dir.get_project_dir(cfg.project_name)
    assert os.path.exists(os.path.join(d, "cfg.yaml"))
