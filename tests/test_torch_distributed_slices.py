"""Multi-process runs of the port: (re, im) pairs, the multi-slice mesh
with one slice a rank, and ``sync_update`` batches over ranks.

Ranks are gloo subprocesses under ``WAFER_DEVICE=cpu``
(``chip_smoke.start_ranks``), at the sizes of
``__graft_entry__.dryrun_multichip``'s legs 8c, 9 and 9b. Each run equals
the port's single-process run on the same mesh (ψ bit for bit on every
rank, E/N exact, the same steps) and is within 2e-4 of ``wafer_tpu``'s
``run_sharded_split`` on the same config; leg 9's one chunk is held to the
single-process chunk bit for bit, to the flat mesh's within leg 9's own
1e-6 and to ``wafer_tpu``'s ``MultiSliceOps`` within the multi-slice
tests' f32 tolerance. Only rank 0 writes files."""

import logging

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_distributed import (
    RANK_TIMEOUT, assert_only_rank_0_wrote, assert_ranks_equal_one_process, leg_raw,
    run_cli_ranks,
)
from tests.test_torch_hostlayer import configs
from wafer_torch import solver as tsolver
from wafer_torch.io import run_dir as trun_dir
from wafer_torch.parallel.mesh import make_mesh as tmesh
from wafer_torch.parallel.multislice import make_multislice_mesh as tms_mesh
from wafer_tpu import geometry as jgeo
from wafer_tpu.io import run_dir
from wafer_tpu.models import potentials as jpot
from wafer_tpu.ops import split_complex as jsc
from wafer_tpu.parallel import make_mesh as jmesh
from wafer_tpu.parallel.multislice import MultiSliceOps as JMS, make_multislice_mesh as jms_mesh
from wafer_tpu.parallel.sharded_split import run_sharded_split

CPU = torch.device("cpu")
LOG = logging.getLogger("wafer")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _energy(r):
    return r.observables.energy / r.observables.norm2


def _complex_raw(x, mesh):
    """Legs 8c and 9b: ComplexHarmonic (absorb 0.2), dn 0.3, dt 0.02,
    an x × 16 × 16 grid."""
    return leg_raw(1, potential="ComplexHarmonic", absorb=0.2, max_steps=200000,
                   grid={"size": {"x": x, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02}, mesh=mesh)


def _split_reference(monkeypatch, jcfg, mesh=None):
    monkeypatch.setattr(jsc, "backend_supports_complex", lambda: False)
    run_dir.reset_proj_date()
    run_dir.check_output_dir(jcfg.project_name)
    return run_sharded_split(jcfg, LOG, mesh=mesh)


def test_split_complex_over_ranks(tmp_path, tmp_run, monkeypatch):
    """Leg 8c: the complex harmonic E₀ on (2, 1, 1) over two ranks (K3's
    pairs, conjugated overlaps), against one process, the reference and
    the complex oracle 1.5·√(1 + 0.2i)."""
    raw = _complex_raw(8, {"x": 2, "y": 1, "z": 1})
    results = run_cli_ranks(tmp_path / "ranks", raw, 2)
    jcfg, tcfg = configs(**raw)
    trun_dir.check_output_dir(tcfg.project_name)
    single = tsolver.run(tcfg, mesh=tmesh((2, 1, 1), [CPU] * 2))
    assert_ranks_equal_one_process(results, single)
    assert_only_rank_0_wrote(tmp_path / "ranks", 2, 1)
    (ref,) = _split_reference(monkeypatch, jcfg, jmesh((2, 1, 1)))
    assert abs(_energy(single[0]) - _energy(ref)) < 2e-4


def test_multislice_chunk_over_ranks(tmp_path):
    """Leg 9: one chunk (screen_update 5, slice_update 2) on 2 × (2, 1, 1)
    with one slice a rank, ground and S = 1: every rank's ψ and measure are
    the single-process chunk's bit for bit; the ground chunk is the flat
    (4, 1, 1) chunk's within leg 9's 1e-6 and the reference's within 2e-5
    of its largest value."""
    raw = leg_raw(4, grid={"size": {"x": 16, "y": 8, "z": 8}, "dn": 0.1, "dt": 3e-3},
                  output={"screen_update": 5},
                  mesh={"x": 2, "y": 1, "z": 1, "slices": 2, "slice_update": 2})
    for n_store in (0, 1):
        spec = {"raw": raw, "mesh": [2, 1, 1], "slices": 2, "seed": 41, "n_store": n_store}
        results, _wall = chip_smoke.start_ranks(
            {"mode": "chunk", "cases": [spec], "threads": 1}, 2, str(tmp_path / f"s{n_store}"),
            RANK_TIMEOUT, env={"WAFER_DEVICE": "cpu"})
        one = chip_smoke.chunk_case(spec, CPU)
        for (res,) in (r["cases"] for r in results):
            assert res["crosses"] and torch.equal(res["psi"], one["psi"])
            assert res["sums"] == one["sums"] and res["psi_sha256"] == one["psi_sha256"]
    flat = chip_smoke.chunk_case(dict(spec, mesh=[4, 1, 1], slices=1, n_store=0), CPU)
    ground = chip_smoke.chunk_case(dict(spec, n_store=0), CPU)["psi"].numpy()
    scale = np.abs(flat["psi"].numpy()).max()
    assert np.abs(ground - flat["psi"].numpy()).max() <= 1e-6 * scale
    jcfg = configs(**raw)[0]
    psi = torch.randn(tuple(jcfg.work_size()), generator=torch.Generator().manual_seed(41))
    psi = (psi / np.sqrt(psi.numel())).numpy()
    ext = jcfg.central_difference.ext
    a, b = jpot.build_ab(jpot.generate(jcfg), jcfg.grid.dt)
    jops = JMS(jcfg, jms_mesh((2, 1, 1), 2), 0)
    ref = np.asarray(jops.get(jops.evolve_chunk(
        jops.put(psi), jops.put(np.asarray(jgeo.work_area(a, ext))),
        jops.put(np.asarray(jgeo.work_area(b, ext))), jops.put_store(None))))
    assert np.abs(ground - ref).max() <= 2e-5 * np.abs(ref).max()


def test_split_multislice_over_ranks(tmp_path, tmp_run, monkeypatch):
    """Leg 9b: the complex harmonic on 2 × (2, 1, 1), two ranks × two
    shards, one slice a rank (x copies cross once a window of 4), against
    one process, the reference's split driver and the oracle."""
    raw = _complex_raw(16, {"x": 2, "y": 1, "z": 1, "slices": 2, "slice_update": 4})
    results = run_cli_ranks(tmp_path / "ranks", raw, 2, shards_per_rank=2)
    jcfg, tcfg = configs(**raw)
    trun_dir.check_output_dir(tcfg.project_name)
    single = tsolver.run(tcfg, mesh=tms_mesh((2, 1, 1), 2, [CPU] * 4))
    assert_ranks_equal_one_process(results, single)
    assert_only_rank_0_wrote(tmp_path / "ranks", 2, 1)
    (ref,) = _split_reference(monkeypatch, jcfg)
    assert abs(_energy(single[0]) - _energy(ref)) < 2e-4
    assert abs(_energy(single[0]) - 1.5 * (1 + 0.2j) ** 0.5) < 0.05


def test_sync_update_over_ranks_matches_per_chunk(tmp_path, tmp_run):
    """``sync_update: 8`` on (2, 1, 1) over two ranks, f64, E₀ and E₁: the
    batches run eagerly (no capture; the route is logged) and every state
    equals the single-process per-chunk run (ψ bit for bit, E/N exact, the
    same steps)."""
    raw = leg_raw(2, mesh={"x": 2, "y": 1, "z": 1}, precision="f64", wavemax=1,
                  init_condition="Gaussian", sig=2.0, tolerance=1e-5, delayed_gram=False)
    results = run_cli_ranks(tmp_path / "ranks", dict(raw, sync_update=8), 2)
    for res in results:
        assert all(s["batch"]["batches"] > 0 and s["batch"]["captures"] == 0
                   for s in res["states"])
    (log,) = (tmp_path / "ranks" / "rank0" / "output").glob("*/simulation.log")
    assert "run eagerly (ψ spans 2 processes)" in log.read_text()
    tcfg = configs(**raw)[1]
    trun_dir.check_output_dir(tcfg.project_name)
    single = tsolver.run(tcfg, mesh=tmesh((2, 1, 1), [CPU] * 2))
    assert_ranks_equal_one_process(results, single)
