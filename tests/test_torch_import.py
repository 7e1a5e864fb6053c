"""The PyTorch port imports torch and never jax, builds its kernels only at
first use, and never falls back to the CPU silently.

The jax checks run in a subprocess: this process already imported jax
(tests/conftest.py)."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# any import of jax in the child raises; Config.dtype/real_dtype import
# jax.numpy, so a port path that calls them fails here too
_NO_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("wafer_torch imported " + name)
        return None
sys.meta_path.insert(0, _NoJax())
"""

_CONFIG = """\
project_name: no jax
grid: {size: {x: 16, y: 16, z: 16}, dn: 0.3, dt: 0.02}
tolerance: 1.0e-5
central_difference: ThreePoint
max_steps: 100000
wavenum: 0
wavemax: 1
output: {screen_update: 100, snap_update: 200, file_type: Json, save_wavefns: true, save_potential: true}
potential: Harmonic
mass: 1.0
init_condition: Constant
sig: 1.0
init_symmetry: NotConstrained
precision: f32
"""


_SHARED = {
    "wafer_tpu", "wafer_tpu.config", "wafer_tpu.errors", "wafer_tpu.native",
    "wafer_tpu.io", "wafer_tpu.io.formats", "wafer_tpu.io.readers", "wafer_tpu.io.writers",
    "wafer_tpu.io.run_dir", "wafer_tpu.io.trilerp", "wafer_tpu.io.script",
    "wafer_tpu.utils", "wafer_tpu.utils.logging", "wafer_tpu.utils.terminal",
}


def _child(code, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, WAFER_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX + textwrap.dedent(code)],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_port_modules_import_without_jax(tmp_path):
    out = _child(
        """
        import wafer_torch, wafer_torch.cli, wafer_torch.convert, wafer_torch.solver
        from wafer_torch.ops import _build, hopper_stencil, observables, stencil
        from wafer_torch.models import initial, potentials
        print("jax loaded:", "jax" in sys.modules)
        """,
        tmp_path,
    )
    assert out.strip().endswith("jax loaded: False")


def test_cpu_solve_through_cli_without_jax(tmp_path):
    """A 16³ two-state solve through the CLI on the CPU (snapshots,
    potential and wavefunction output) never imports jax and never builds
    a kernel."""
    (tmp_path / "cfg.yaml").write_text(_CONFIG)
    out = _child(
        """
        from wafer_torch import cli
        from wafer_torch.ops import hopper_stencil
        rc = cli.main(["-c", "cfg.yaml"])
        print(" ".join(sorted(m for m in sys.modules if m.startswith("wafer_tpu"))))
        print("rc", rc, "launches", sum(hopper_stencil.LAUNCHES.values()),
              "jax", "jax" in sys.modules)
        """,
        tmp_path,
    )
    shared, verdict = out.strip().splitlines()[-2:]
    assert verdict == "rc 0 launches 0 jax False"
    # only the host layer the port shares with the reference is loaded
    assert set(shared.split()) <= _SHARED, set(shared.split()) - _SHARED
    (run,) = (tmp_path / "output").iterdir()
    names = {p.name for p in run.iterdir()}
    assert {"observables_0.json", "observables_1.json", "potential.json",
            "wavefunction_1.json"} <= names
    assert not any("partial" in n for n in names)
    assert not (tmp_path / "wafer_torch").exists()


def test_cli_raises_without_cuda(monkeypatch, tmp_path):
    """No CUDA device and no WAFER_DEVICE: the CLI raises instead of
    running on the CPU."""
    from wafer_torch import cli
    from wafer_torch.errors import DeviceUnavailableError

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WAFER_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="WAFER_DEVICE=cpu"):
        cli.main(["-c", "missing.yaml"])


@pytest.mark.parametrize(
    "env, expect",
    [({"WAFER_DEVICE": "cpu"}, "cpu"), ({"WAFER_DEVICE": "not-a-device"}, None),
     ({}, None), ({"WAFER_DEVICE": "meta"}, None)],
)
def test_resolve_device(monkeypatch, env, expect):
    from wafer_torch.errors import DeviceUnavailableError
    from wafer_torch.utils.host import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if expect is None:
        with pytest.raises(DeviceUnavailableError):
            resolve_device(env)
    else:
        assert resolve_device(env).type == expect


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernel build needs nvcc; without it the wrapper's build raises a
    typed error (no fallback)."""
    from wafer_torch.errors import KernelCompileError
    from wafer_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(KernelCompileError, match="nvcc not found"):
        _build.build(tmp_path / "kernels")
    assert not (tmp_path / "kernels").exists()


def test_build_flags_and_hash():
    from wafer_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert [p.name for p in _build.sources()] == ["split_sweep.cu", "stencil_sweep.cu"]
    assert (_build.CSRC / "sweep_common.cuh").exists()  # included by both, hashed too
    assert _build.source_hash() == _build.source_hash()
    assert _build.BUILD_DIR.name == "_kernels"


def test_packaging_names_the_port():
    tomllib = pytest.importorskip("tomllib")
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        meta = tomllib.load(fh)
    assert "wafer_torch*" in meta["tool"]["setuptools"]["packages"]["find"]["include"]
    assert "csrc/*.cu" in meta["tool"]["setuptools"]["package-data"]["wafer_torch"]
    assert meta["project"]["scripts"]["wafer-torch"] == "wafer_torch.cli:main"
    assert any(d.startswith("torch") for d in meta["project"]["optional-dependencies"]["torch"])
    assert any(m.startswith("gpu:") for m in meta["tool"]["pytest"]["ini_options"]["markers"])
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "wafer_torch/_kernels/" in fh.read().split()
