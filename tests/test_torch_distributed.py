"""Multi-process runs of the port (``WAFER_COORDINATOR``,
``wafer_torch/parallel/distributed.py`` and ``transport.py``), real ψ.

The entry is held to its contract with ``torch.distributed`` patched: the
env trio wired into ``init_process_group`` over TCP, gloo on the CPU, a
second call that does nothing, a missing variable named. The mesh deals its
shards to the processes in equal contiguous runs, and an exchange plan
sends and receives exactly the faces that cross them.

The runs start their ranks as gloo subprocesses under ``WAFER_DEVICE=cpu``
(``chip_smoke.start_ranks``, each rank in its own directory) through
``wafer_torch.cli.main``, at the sizes of ``__graft_entry__.dryrun_multichip``'s
legs 8 and 8b (the x extent 4 × the shards). Each run equals the port's
single-process run on the same mesh (ψ bit for bit on every rank, E/N
exact, the same steps), is within 2e-4 of ``wafer_tpu``'s ``run_sharded``
on the same config, and only rank 0 wrote files. Every rank subprocess has
a timeout of its own, and ``init_process_group`` its own, so a deadlock
fails a test."""

import logging

import pytest
import torch
import torch.distributed as dist
import yaml

import chip_smoke
from tests.test_torch_hostlayer import configs, raw_config
from wafer_torch import errors as terrors, solver as tsolver
from wafer_torch.io import run_dir as trun_dir
from wafer_torch.parallel import distributed as tdist, mesh as tmesh_mod
from wafer_torch.parallel.halo import halo_copies
from wafer_torch.parallel.mesh import make_mesh as tmesh
from wafer_tpu import solver as jsolver
from wafer_tpu.io import run_dir
from wafer_tpu.parallel import make_mesh as jmesh
from wafer_tpu.parallel.solver_sharded import run_sharded as j_run_sharded

CPU = torch.device("cpu")
LOG = logging.getLogger("wafer")
RANK_TIMEOUT = 120  # seconds for all the ranks of one run


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# the entry, the mesh and the plan, with torch.distributed patched
# --------------------------------------------------------------------------- #


def fake_start(monkeypatch, world=2, rank=1, coordinator="10.0.0.1:8476"):
    """Patch ``init_process_group`` (recording its arguments) and the
    layout gather (every rank on the CPU); set the trio."""
    calls = []
    monkeypatch.setattr(tdist, "_runtime", None)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))

    def gather(out, obj):
        out[:] = [obj] * len(out)

    monkeypatch.setattr(dist, "all_gather_object", gather)
    monkeypatch.setenv("WAFER_COORDINATOR", coordinator)
    monkeypatch.setenv("WAFER_NUM_PROCESSES", str(world))
    monkeypatch.setenv("WAFER_PROCESS_ID", str(rank))
    monkeypatch.setenv("WAFER_DEVICE", "cpu")
    return calls


def test_entry_starts_gloo_from_the_env(monkeypatch):
    """The trio reaches ``init_process_group`` as the reference passes it to
    ``jax.distributed.initialize`` (tests/test_multislice.py): a tcp://
    address, the world size and the rank, with gloo on the CPU and a
    timeout; the run then reports its rank and size."""
    calls = fake_start(monkeypatch)
    assert tdist.maybe_initialize_distributed() is True
    assert calls == [(("gloo",), {"init_method": "tcp://10.0.0.1:8476", "world_size": 2,
                                  "rank": 1, "timeout": tdist.TIMEOUT})]
    rt = tdist.runtime()
    assert (rt.rank, rt.world, rt.device, rt.backend, rt.staged) == (1, 2, CPU, "gloo", False)
    assert (tdist.process_index(), tdist.process_count()) == (1, 2)


def test_second_call_does_nothing(monkeypatch):
    """The CLI starts the run and ``solver.run`` asks again: one start."""
    calls = fake_start(monkeypatch, rank=0)
    assert tdist.maybe_initialize_distributed() is True
    assert tdist.maybe_initialize_distributed() is True
    assert len(calls) == 1


@pytest.mark.parametrize("missing", ["WAFER_NUM_PROCESSES", "WAFER_PROCESS_ID"])
def test_missing_variable_is_named(monkeypatch, missing):
    """``torch.distributed`` over TCP cannot detect the world size or the
    rank: a missing one raises a WaferError naming it, and nothing starts."""
    calls = fake_start(monkeypatch)
    monkeypatch.delenv(missing)
    with pytest.raises(terrors.DistributedInitError, match=missing) as exc:
        tdist.maybe_initialize_distributed()
    assert isinstance(exc.value, terrors.WaferError)
    assert calls == [] and tdist.runtime() is None


@pytest.mark.parametrize("layouts, expect", [
    ([("h", "cpu"), ("h", "cpu")], ("gloo", False)),
    ([("h", "GPU-a"), ("h", "GPU-b")], ("nccl", False)),
    ([("h", "GPU-a"), ("g", "GPU-a")], ("nccl", False)),
    ([("h", "GPU-a"), ("h", "GPU-a")], ("gloo", True)),
])
def test_backend_follows_the_layout(layouts, expect):
    """NCCL for a card a rank, gloo on the CPU and, staged through the
    host, for ranks that share a card."""
    assert tdist.choose_backend(layouts)[:2] == expect


def test_mixed_cpu_and_cuda_ranks_raise():
    with pytest.raises(terrors.DistributedInitError, match="WAFER_DEVICE"):
        tdist.choose_backend([("h", "cpu"), ("h", "GPU-a")])


def test_mesh_deals_shards_to_processes(monkeypatch):
    """Process 1 of 2 owns the second half of the ranks; a mesh that does
    not divide over the processes, or a process short of devices, raises;
    the default devices are an equal share of every process's."""
    fake_start(monkeypatch)
    tdist.maybe_initialize_distributed()
    mesh = tmesh((2, 2, 1), [CPU] * 4)
    assert mesh.spans and list(mesh.local) == [2, 3]
    assert [mesh.owner(r) for r in range(4)] == [0, 0, 1, 1]
    assert [mesh.is_local(r) for r in range(4)] == [False, False, True, True]
    with pytest.raises(ValueError, match="does not divide over 2 processes"):
        tmesh((3, 1, 1), [CPU] * 3)
    monkeypatch.setattr(tmesh_mod, "_gathered", lambda: [[CPU] * 2, [CPU]])
    with pytest.raises(ValueError, match=r"needs 4 devices over 2 processes, have \[2, 1\]"):
        tmesh((4, 1, 1))
    assert list(tmesh((2, 1, 1)).local) == [1]


def test_exchange_plan_sends_only_faces_that_cross(monkeypatch):
    """On a (2, 2, 1) mesh, process 1's x stage sends its two low faces and
    receives two halos from process 0; its y faces and all zero edges stay
    local copies."""
    fake_start(monkeypatch)
    tdist.maybe_initialize_distributed()
    mesh = tmesh((2, 2, 1), [CPU] * 4)
    blocks = [torch.zeros(6, 6, 6) for _ in mesh.local]
    plan = halo_copies(blocks, 1, mesh)
    x, y, z = plan.stages
    # x transfers in the global order: (rank 0, 1, 2, 3) × (low, high) halo
    assert [(p, t) for p, t, _v, _b in x.sends] == [(0, 1), (0, 3)]
    assert [(p, t) for p, t, _v, _b in x.recvs] == [(0, 4), (0, 6)]
    assert [src for _dst, src in x.copies] == [None, None]
    assert not (y.sends or y.recvs or z.sends or z.recvs)
    assert len(y.copies) == 4 and len(z.copies) == 4 and plan.crosses
    for _p, _t, view, buf in x.sends + x.recvs:
        assert buf.shape == view.shape and buf.is_contiguous() and buf.device == CPU


def test_batches_of_a_mesh_over_processes_run_eagerly(caplog):
    """``sync_update`` batches capture no CUDA graph when ψ spans
    processes, even with every local shard on one card."""
    cfg = configs(sync_update=4)[1]
    one_card = [torch.device("cuda", 0)] * 2
    with caplog.at_level(logging.INFO, logger="wafer"):
        spanning = tsolver.batch_runner(cfg, LOG, None, None, 0, one_card, processes=2)
        alone = tsolver.batch_runner(cfg, LOG, None, None, 0, one_card)
    assert not spanning.graphs and alone.graphs
    assert "eagerly (ψ spans 2 processes)" in caplog.text


# --------------------------------------------------------------------------- #
# runs of two and four ranks against one process and the reference
# --------------------------------------------------------------------------- #


def leg_raw(n_shards, **over):
    """``dryrun_multichip``'s leg 8 grid for ``n_shards`` x-shards (4·n × 16
    × 16, dn 0.25, dt 0.015, screen_update 100) with ``over`` merged."""
    base = dict(project_name="ranks", precision="f32", seed=13, max_steps=100000,
                grid={"size": {"x": 4 * n_shards, "y": 16, "z": 16}, "dn": 0.25, "dt": 0.015},
                output={"screen_update": 100, "file_type": "Json", "save_wavefns": True})
    for key, val in over.items():
        if isinstance(val, dict) and isinstance(base.get(key), dict):
            base[key] = {**base[key], **val}
        else:
            base[key] = val
    return raw_config(**base)


def run_cli_ranks(tmp_path, raw, world, shards_per_rank=None):
    """``wafer_torch.cli.main`` on ``raw`` as ``world`` gloo ranks on the CPU;
    each rank's recorded solves."""
    spec = {"mode": "cli", "config": yaml.safe_dump(raw), "keep_phi": True, "threads": 1,
            "shards_per_rank": shards_per_rank}
    results, _wall = chip_smoke.start_ranks(spec, world, str(tmp_path), RANK_TIMEOUT,
                                            env={"WAFER_DEVICE": "cpu"})
    for res in results:
        assert res["rc"] == 0
    return results


def assert_only_rank_0_wrote(tmp_path, world, n_states):
    """Rank 0's directory holds the run directory (log, config, one
    observables file a state); no other rank created any directory."""
    (run,) = (tmp_path / "rank0" / "output").iterdir()
    names = {p.name for p in run.iterdir()}
    assert {"simulation.log", "smoke.yaml"} | {f"observables_{w}.json"
                                                for w in range(n_states)} <= names
    for r in range(1, world):
        assert sorted(p.name for p in (tmp_path / f"rank{r}").iterdir()) == ["smoke.yaml"]


def assert_ranks_equal_one_process(results, single):
    """Every rank's states are the single-process run's: steps, E/N and ψ
    bit for bit."""
    for res in results:
        states = [s for s in res["states"] if s["sharded"]]
        assert len(states) == len(single)
        for got, want in zip(states, single):
            assert got["steps"] == want.steps
            assert got["energy"] / got["norm2"] == want.observables.energy / want.observables.norm2
            assert torch.equal(got["phi"], want.phi)


def _energy(r):
    return r.observables.energy / r.observables.norm2


def _reference(jcfg, shape):
    run_dir.reset_proj_date()
    run_dir.check_output_dir(jcfg.project_name)
    return j_run_sharded(jcfg, LOG, mesh=jmesh(shape))


@pytest.mark.parametrize("shape, world, per_rank", [
    ((2, 1, 1), 2, None),   # leg 8 on two ranks
    ((4, 1, 1), 4, None),   # leg 8 on four ranks
    ((4, 1, 1), 2, 2),      # two ranks × two shards
])
def test_ground_state_over_ranks(tmp_path, tmp_run, shape, world, per_rank):
    """Leg 8: the harmonic ground state through the CLI on a flat x mesh
    that spans the ranks."""
    raw = leg_raw(shape[0], mesh={"x": shape[0], "y": 1, "z": 1})
    results = run_cli_ranks(tmp_path / "ranks", raw, world, per_rank)
    jcfg, tcfg = configs(**raw)
    trun_dir.check_output_dir(tcfg.project_name)
    single = tsolver.run(tcfg, mesh=tmesh(shape, [CPU] * shape[0]))
    assert_ranks_equal_one_process(results, single)
    assert_only_rank_0_wrote(tmp_path / "ranks", world, 1)
    (ref,) = _reference(jcfg, shape)
    assert abs(_energy(single[0]) - _energy(ref)) < 2e-4


def test_excited_state_over_ranks(tmp_path, tmp_run):
    """Leg 8b: E₀ and E₁ (Gaussian IC, sig 2) on (2, 1, 1) over two ranks:
    the stored state's overlaps and the per-step K2 rows are gathered; a
    snapshot every 200 steps gathers ψ on every rank, and rank 0 alone
    writes it (and removes it at convergence)."""
    raw = leg_raw(2, mesh={"x": 2, "y": 1, "z": 1}, init_condition="Gaussian", sig=2.0,
                  wavemax=1, max_steps=200000, output={"snap_update": 200})
    results = run_cli_ranks(tmp_path / "ranks", raw, 2)
    jcfg, tcfg = configs(**raw)
    trun_dir.check_output_dir(tcfg.project_name)
    single = tsolver.run(tcfg, mesh=tmesh((2, 1, 1), [CPU] * 2))
    assert_ranks_equal_one_process(results, single)
    assert_only_rank_0_wrote(tmp_path / "ranks", 2, 2)
    ref = _reference(jcfg, (2, 1, 1))
    for r, o in zip(ref, single):
        assert abs(_energy(r) - _energy(o)) < 2e-4


def test_multigrid_final_level_over_ranks(tmp_path, tmp_run):
    """Multigrid [2]: every rank solves the coarse level alike on its own
    device, then puts its shards of the final level on the two-rank
    (2, 1, 1) mesh."""
    raw = leg_raw(4, mesh={"x": 2, "y": 1, "z": 1}, multigrid=[2])
    results = run_cli_ranks(tmp_path / "ranks", raw, 2)
    for res in results:
        assert [s["sharded"] for s in res["states"]] == [False, True]
    jcfg, tcfg = configs(**raw)
    trun_dir.check_output_dir(tcfg.project_name)
    single = tsolver.run(tcfg, mesh=tmesh((2, 1, 1), [CPU] * 2))
    assert_ranks_equal_one_process(results, single)
    assert_only_rank_0_wrote(tmp_path / "ranks", 2, 1)
    run_dir.check_output_dir(jcfg.project_name)
    (ref,) = jsolver.run(jcfg)
    assert abs(_energy(single[0]) - _energy(ref)) < 2e-4


def test_ranks_without_a_mesh_fail(tmp_path):
    """A multi-process run whose config has no multi-device mesh: every
    rank's CLI says so and returns 1 before any solve."""
    spec = {"mode": "cli", "config": yaml.safe_dump(leg_raw(2)), "threads": 1}
    with pytest.raises(RuntimeError, match=r"ranks exited \[1, 1\]"):
        chip_smoke.start_ranks(spec, 2, str(tmp_path), RANK_TIMEOUT, env={"WAFER_DEVICE": "cpu"})
    for r in range(2):
        text = (tmp_path / f"rank{r}.log").read_text()
        assert "needs a multi-device mesh" in text and "Ground state" not in text
