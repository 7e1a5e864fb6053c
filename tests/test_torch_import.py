"""The PyTorch port imports torch and never jax, nor anything of the JAX
package ``wafer_tpu``; it builds its kernels only at first use and never
falls back to the CPU silently.

The import checks run in a subprocess: this process already imported jax
and wafer_tpu (tests/conftest.py)."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# any import of jax or of the JAX package in the child raises
_NO_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "wafer_tpu"):
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

# the same run as a [2] multigrid schedule: 8³ → 16³
_MG_CONFIG = _CONFIG.replace("project_name: no jax", "project_name: no jax mg") + "multigrid: [2]\n"


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
        import pkgutil, importlib, wafer_torch
        names = [m.name for m in pkgutil.walk_packages(wafer_torch.__path__, "wafer_torch.")]
        for name in names:
            importlib.import_module(name)
        print(len(names), "modules; jax loaded:", "jax" in sys.modules,
              "wafer_tpu loaded:", any(m.startswith("wafer_tpu") for m in sys.modules))
        """,
        tmp_path,
    )
    count, verdict = out.strip().splitlines()[-1].split(" modules; ")
    assert int(count) >= 25
    assert verdict == "jax loaded: False wafer_tpu loaded: False"


def test_cpu_solve_through_cli_without_jax(tmp_path):
    """A 16³ two-state solve and the same run on a [2] multigrid schedule,
    through the CLI on the CPU (snapshots, potential and wavefunction
    output), import neither jax nor wafer_tpu and build no kernel."""
    (tmp_path / "cfg.yaml").write_text(_CONFIG)
    (tmp_path / "mg.yaml").write_text(_MG_CONFIG)
    out = _child(
        """
        from wafer_torch import cli
        from wafer_torch.io import run_dir
        from wafer_torch.ops import hopper_stencil
        rcs = []
        for cfg in ("cfg.yaml", "mg.yaml"):
            run_dir.reset_proj_date()
            rcs.append(cli.main(["-c", cfg]))
        print("rc", rcs, "launches", sum(hopper_stencil.LAUNCHES.values()),
              "jax", "jax" in sys.modules,
              "wafer_tpu", any(m.startswith("wafer_tpu") for m in sys.modules))
        """,
        tmp_path,
    )
    verdict = out.strip().splitlines()[-1]
    assert verdict == "rc [0, 0] launches 0 jax False wafer_tpu False"
    runs = sorted((tmp_path / "output").iterdir())
    assert [r.name[:9] for r in runs] == ["no_jax_20", "no_jax_mg"]
    for run in runs:
        names = {p.name for p in run.iterdir()}
        assert {"observables_0.json", "observables_1.json", "potential.json",
                "wavefunction_1.json"} <= names
        assert not any("partial" in n for n in names)
    log = (runs[1] / "simulation.log").read_text()
    assert "Multigrid level 1/2: 8 x 8 x 8" in log and "Multigrid level 2/2: 16 x 16 x 16" in log
    assert not (tmp_path / "wafer_torch").exists()


_MESH_CONFIG = (_CONFIG.replace("project_name: no jax", "project_name: no jax mesh")
                .replace("wavemax: 1", "wavemax: 0") + "mesh: {x: 2, y: 1, z: 2}\n")


def test_sharded_solve_without_jax(tmp_path):
    """The parallel package runs a 16³ solve on a (2, 1, 2) mesh of CPU
    shards through ``solver.run(mesh=...)`` without jax or wafer_tpu; the
    CLI, which has one CPU device, refuses the mesh with the reference's
    error."""
    (tmp_path / "mesh.yaml").write_text(_MESH_CONFIG)
    out = _child(
        """
        import torch
        from wafer_torch import cli, solver
        from wafer_torch.config import Config
        from wafer_torch.io import run_dir
        from wafer_torch.parallel import make_mesh
        cfg = Config.load("mesh.yaml", script="gen_potential.py")
        run_dir.check_output_dir(cfg.project_name)
        (res,) = solver.run(cfg, mesh=make_mesh((2, 1, 2), [torch.device("cpu")] * 4))
        rc = cli.main(["-c", "mesh.yaml"])
        print("E", round(res.observables.energy / res.observables.norm2, 2), "rc", rc,
              "jax", "jax" in sys.modules,
              "wafer_tpu", any(m.startswith("wafer_tpu") for m in sys.modules))
        """,
        tmp_path,
    )
    assert out.strip().splitlines()[-1] == "E 1.5 rc 1 jax False wafer_tpu False"
    logs = sorted((tmp_path / "output").glob("*/simulation.log"))
    assert "mesh (2, 1, 2) needs 4 devices, have 1" in logs[-1].read_text()


def test_multiprocess_cli_without_jax(tmp_path):
    """Two ranks of the CLI (``WAFER_COORDINATOR`` and gloo on the CPU) run
    the 16³ solve on a (2, 1, 1) mesh, a shard a rank, without jax or
    wafer_tpu; each banner names its rank, and only rank 0 writes the run
    directory."""
    import chip_smoke

    port = chip_smoke.free_port()
    cfg = _MESH_CONFIG.replace("mesh: {x: 2, y: 1, z: 2}", "mesh: {x: 2, y: 1, z: 1}")
    code = _NO_JAX + textwrap.dedent("""
        from wafer_torch import cli
        rc = cli.main(["-c", "mesh.yaml"])
        print("rc", rc, "jax", "jax" in sys.modules,
              "wafer_tpu", any(m.startswith("wafer_tpu") for m in sys.modules))
        """)
    procs = []
    for rank in range(2):
        cwd = tmp_path / f"rank{rank}"
        cwd.mkdir()
        (cwd / "mesh.yaml").write_text(cfg)
        env = dict(os.environ, PYTHONPATH=REPO, WAFER_DEVICE="cpu",
                   WAFER_COORDINATOR=f"127.0.0.1:{port}", WAFER_NUM_PROCESSES="2",
                   WAFER_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=cwd, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        assert out.strip().splitlines()[-1] == "rc 0 jax False wafer_tpu False"
        assert f"process {rank} of 2." in out and "Simulation complete" in out
        # the state's summary is printed where it is written: on rank 0
        assert ("Ground state energy" in out) == (rank == 0)
    (run,) = (tmp_path / "rank0" / "output").iterdir()
    assert {"observables_0.json", "wavefunction_0.json", "potential.json"} <= {
        p.name for p in run.iterdir()}
    assert sorted(p.name for p in (tmp_path / "rank1").iterdir()) == ["mesh.yaml"]


_SYNC_MESH_CONFIG = (_MESH_CONFIG.replace("project_name: no jax mesh", "project_name: no jax sync")
                     .replace("screen_update: 100", "screen_update: 50") + "sync_update: 4\n")


def test_sharded_sync_update_without_jax(tmp_path):
    """``sync_update: 4`` on a (2, 1, 2) mesh of CPU shards (once refused)
    solves without jax or wafer_tpu: batches of chunks, one read each,
    through the sharded driver, to the per-chunk run's step and energy."""
    (tmp_path / "sync.yaml").write_text(_SYNC_MESH_CONFIG)
    out = _child(
        """
        import torch
        from wafer_torch import solver
        from wafer_torch.config import Config
        from wafer_torch.io import run_dir
        from wafer_torch.parallel import make_mesh
        res = []
        for sync in (1, 4):
            cfg = Config.load("sync.yaml", script="gen_potential.py")
            cfg.sync_update = sync
            run_dir.reset_proj_date()
            run_dir.check_output_dir(cfg.project_name)
            (r,) = solver.run(cfg, mesh=make_mesh((2, 1, 2), [torch.device("cpu")] * 4))
            res.append(r)
        a, b = res
        print("E", round(b.observables.energy / b.observables.norm2, 2),
              "same", a.steps == b.steps and a.observables == b.observables,
              "batches", b.batch["batches"] > 0, "jax", "jax" in sys.modules,
              "wafer_tpu", any(m.startswith("wafer_tpu") for m in sys.modules))
        """,
        tmp_path,
    )
    assert out.strip().splitlines()[-1] == (
        "E 1.5 same True batches True jax False wafer_tpu False")


_SLICES_CONFIG = (_CONFIG.replace("project_name: no jax", "project_name: no jax slices")
                  .replace("wavemax: 1", "wavemax: 0")
                  + "mesh: {x: 2, y: 1, z: 1, slices: 2, slice_update: 4}\n")
_TRACE_CONFIG = (_CONFIG.replace("project_name: no jax", "project_name: no jax trace")
                 .replace("wavemax: 1", "wavemax: 0") + "trace_dir: trace\ndebug_nans: true\n")


def test_multislice_and_trace_without_jax(tmp_path):
    """A 16³ solve on a 2 × (2, 1, 1) multi-slice mesh of CPU shards and a
    CLI run with ``trace_dir`` and ``debug_nans`` import neither jax nor
    wafer_tpu; the trace holds the loop's spans."""
    (tmp_path / "slices.yaml").write_text(_SLICES_CONFIG)
    (tmp_path / "trace.yaml").write_text(_TRACE_CONFIG)
    out = _child(
        """
        import glob, json, torch
        from wafer_torch import cli, solver
        from wafer_torch.config import Config
        from wafer_torch.io import run_dir
        from wafer_torch.parallel.multislice import make_multislice_mesh
        cfg = Config.load("slices.yaml", script="gen_potential.py")
        run_dir.check_output_dir(cfg.project_name)
        (res,) = solver.run(cfg, mesh=make_multislice_mesh((2, 1, 1), 2, [torch.device("cpu")] * 4))
        run_dir.reset_proj_date()
        rc = cli.main(["-c", "trace.yaml"])
        (path,) = glob.glob("trace/*.pt.trace.json")
        spans = sorted({e["name"] for e in json.load(open(path))["traceEvents"]
                        if str(e.get("name", "")).startswith("wafer.")})
        print("E", round(res.observables.energy / res.observables.norm2, 2), "rc", rc,
              "spans", ",".join(spans), "jax", "jax" in sys.modules,
              "wafer_tpu", any(m.startswith("wafer_tpu") for m in sys.modules))
        """,
        tmp_path,
    )
    assert out.strip().splitlines()[-1] == (
        "E 1.5 rc 0 spans wafer.evolve_chunk,wafer.measure,wafer.snapshot,"
        "wafer.write_wavefunction jax False wafer_tpu False")


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


_FAKE_NVCC = """#!/usr/bin/env python3
import sys, time
log = sys.argv[0] + ".calls"
with open(log, "a") as fh:
    fh.write("start %r %s\\n" % (time.monotonic(), " ".join(sys.argv[1:])))
if "-c" in sys.argv:
    time.sleep(0.5)
with open(sys.argv[sys.argv.index("-o") + 1], "w") as fh:
    fh.write("built")
with open(log, "a") as fh:
    fh.write("end %r\\n" % time.monotonic())
"""


def test_build_compiles_each_source_at_once_then_links(monkeypatch, tmp_path):
    """One nvcc per source, all started before any ends, then one link of
    their objects into the library; the objects are removed and the log
    keeps every command and each step's seconds."""
    from wafer_torch.ops import _build

    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "nvcc"
    fake.write_text(_FAKE_NVCC)
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep + os.environ["PATH"])
    lib = _build.build(tmp_path / "kernels")
    assert lib.name == f"libwafer_torch_{_build.source_hash()}.so" and lib.read_text() == "built"
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted([lib.name, lib.stem + ".log"])
    calls = (bindir / "nvcc.calls").read_text().splitlines()
    starts = [line.split(" ", 2) for line in calls if line.startswith("start")]
    compiles = [args for _s, _t, args in starts if " -c " in f" {args} "]
    assert len(compiles) == len(_build.sources()) == 6
    # one nvcc per source; the processes start together, in no fixed order
    assert sorted(args.split()[-1] for args in compiles) == sorted(map(str, _build.sources()))
    compile_starts = [float(t) for _s, t, args in starts if args in compiles]
    first_end = min(float(line.split()[1]) for line in calls if line.startswith("end"))
    assert max(compile_starts) < first_end  # all compiles ran at once
    (link,) = [args for _s, _t, args in starts if args not in compiles]
    assert "-shared" in link.split() and link.count(".o") == 6
    assert lib.with_suffix(".log").read_text().count("nvcc") == 7
    secs = _build.build_seconds(lib)
    assert sorted(secs) == sorted([p.name for p in _build.sources()] + ["link", "total"])
    assert all(secs[p.name] >= 0.5 for p in _build.sources())  # the fake's compile sleeps
    assert secs["total"] >= max(secs.values()) - 0.01
    assert _build.build(tmp_path / "kernels") == lib  # same hash: no rebuild
    assert len((bindir / "nvcc.calls").read_text().splitlines()) == len(calls)


def test_build_flags_and_hash():
    from wafer_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert [p.name for p in _build.sources()] == [
        "finish_coef.cu", "split_sweep.cu", "stencil_sweep.cu", "stencil_sweep_bf16.cu",
        "stencil_sweep_many.cu", "stencil_sweep_wide.cu"]
    assert (_build.CSRC / "sweep_common.cuh").exists()  # included by all six, hashed too
    assert _build.source_hash() == _build.source_hash()
    assert _build.BUILD_DIR.name == "_kernels"


def test_packaging_names_the_port():
    tomllib = pytest.importorskip("tomllib")
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        meta = tomllib.load(fh)
    assert "wafer_torch*" in meta["tool"]["setuptools"]["packages"]["find"]["include"]
    assert "csrc/*.cu" in meta["tool"]["setuptools"]["package-data"]["wafer_torch"]
    assert "src/*.cpp" in meta["tool"]["setuptools"]["package-data"]["wafer_torch.native"]
    assert meta["project"]["scripts"]["wafer-torch"] == "wafer_torch.cli:main"
    assert any(d.startswith("torch") for d in meta["project"]["optional-dependencies"]["torch"])
    assert any(m.startswith("gpu:") for m in meta["tool"]["pytest"]["ini_options"]["markers"])
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "wafer_torch/_kernels/" in fh.read().split()
