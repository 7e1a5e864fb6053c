"""The per-chunk path as one device program (``wafer_torch/chunk_graph.py``)
on the CPU: the route each layout takes, the schedule of a chunk with a
captured segment against the eager loop's, the bound chunks kept by key
and freed with their state and their solve, and a failing capture.

A CUDA graph needs the card; here a capture is injected that records the
segment's calls (``graph_like``: the calls made while capturing are moved
to each replay, as a graph replays its launches) or runs them again
(``rerun``: the CPU has no graph, so a replay computes the steps again on
the plain versions). The graphed chunk on the card, bit for bit the eager
one, is in tests/test_torch_gpu.py (``-k chunk_graph``). The solve with
the graph route forced on the CPU is held bit for bit to the per-chunk run
and, as tests/test_torch_solver.py holds the port, to ``wafer_tpu``'s."""

import logging
import types

import numpy as np
import pytest
import torch

from tests.test_torch_hostlayer import configs
from wafer_torch import chunk_graph, errors as terrors, geometry as tgeo, solver as tsolver
from wafer_torch.io import run_dir as trun_dir
from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs
from wafer_torch.parallel.mesh import make_mesh as tmesh
from wafer_torch.parallel.multislice import MultiSliceOps, make_multislice_mesh
from wafer_torch.parallel.sharded import ShardedOps
from wafer_tpu import solver as jsolver
from wafer_tpu.io import run_dir

CPU = torch.device("cpu")
CARD = torch.device("cuda", 0)  # a device object only: nothing here touches CUDA
LOG = logging.getLogger("wafer")


class Recorder:
    """A bound chunk that records its steps: (t, src, dst) with the
    buffers' names."""

    def __init__(self, period=1):
        self.period = period
        self.bufs = ("b0", "b1")
        self.calls = []
        self.device = CPU
        self.counts = {"sweep_step": 0}
        self.tensors = ()
        self.eager = "eager"

    def launchers(self, stream=None):
        return "captured"

    def begin(self, phi):
        return phi

    def step(self, launch, t, src, dst):
        self.calls.append((t, src, dst))
        self.counts["sweep_step"] += 1

    def fresh(self):
        return "fresh"

    def end(self, last):
        return last


def graph_like(rec):
    """A capture that records the segment's calls once (counting them, as
    the wrappers count a capture's launches) and appends them at each
    replay without stepping: what a graph replays."""
    def capture(device, launchers, record):
        start = len(rec.calls)
        record(launchers(None))
        captured = rec.calls[start:]
        del rec.calls[start:]
        return types.SimpleNamespace(replay=lambda: rec.calls.extend(captured),
                                     reset=lambda: None)
    return capture


def rerun(device, launchers, record):
    """A capture for CPU tensors: each replay runs the recorded steps again."""
    launch = launchers(None)
    return types.SimpleNamespace(replay=lambda: record(launch), reset=lambda: None)


def eager_loop(n, period=1):
    """The eager loop's steps: step t reads ψ (t = 0) or buffer (t − 1) % 2
    and writes buffer t % 2, the last step a fresh buffer."""
    bufs = ("b0", "b1")
    return [(t, "phi" if t == 0 else bufs[(t - 1) % 2], "fresh" if t == n - 1 else bufs[t % 2])
            for t in range(n)]


def cadence(calls, period):
    """What a step depends on besides its buffers: whether it is the first,
    and where it stands in a window (its x exchange)."""
    return [(t > 0, t % period, src, dst) for t, src, dst in calls]


# --------------------------------------------------------------------------- #
# routes
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("devices, processes, kernel, want, words", [
    ([CARD], 1, True, "graph", "as a CUDA graph"),
    ([CARD] * 8, 1, True, "graph", "as a CUDA graph"),  # a mesh's shards on one card
    ([CARD, torch.device("cuda", 1)], 1, True, "eager", "ψ spans 2 devices"),
    ([CARD], 2, True, "eager", "ψ spans 2 processes"),
    ([CPU], 1, True, "plain", "plain torch ops"),
    ([CPU] * 4, 2, True, "plain", "plain torch ops"),
    ([CARD], 1, False, "plain", "plain torch ops"),  # f64 or backend: xla on the card
], ids=["one_card", "mesh_on_one_card", "two_cards", "two_processes", "cpu", "cpu_ranks",
        "plain_backend"])
def test_route_and_its_log_line(caplog, devices, processes, kernel, want, words):
    assert chunk_graph.route(devices, processes, kernel) == want
    _j, tcfg = configs()
    with caplog.at_level(logging.INFO, logger="wafer"):
        graphs = tsolver.chunk_graphs(tcfg, LOG, devices, processes, kernel)
    (line,) = [r.getMessage() for r in caplog.records if "Evolve chunks run" in r.getMessage()]
    assert words in line
    assert (graphs is None) == (want == "plain")
    assert graphs is None or graphs.route == want


def test_no_bound_chunks_on_the_plain_route():
    with pytest.raises(ValueError, match="plain"):
        chunk_graph.ChunkGraphs("plain")


def test_a_batch_takes_neither_cached_chunk_nor_segment():
    """Inside a ``sync_update`` batch (the chunk gets the batch's ``done``
    flag) the chunk binds its own launchers and runs every step eagerly:
    the batch captures the whole iteration itself."""
    graphs = chunk_graph.ChunkGraphs("graph", capture=rerun)
    gen = torch.Generator().manual_seed(3)
    phi = torch.randn(10, 10, 10, generator=gen)
    done = torch.zeros((), dtype=torch.int32)
    an = ("Harmonic", 0.3, 0.02, 1.0, 8, 8, 8)
    out = hs.evolve_chunk(phi, "ThreePoint", 0.02, 0.3, 1.0, 20, an, per_step_norm=True,
                          done=done, graphs=graphs)
    assert graphs.keys() == [] and graphs.captures == 0
    assert torch.equal(out, hs.evolve_chunk(phi, "ThreePoint", 0.02, 0.3, 1.0, 20, an,
                                            per_step_norm=True))
    _j, tcfg = configs(grid={"size": {"x": 8, "y": 8, "z": 8}, "dn": 0.3, "dt": 0.02},
                       precision="f32", output={"screen_update": 20})
    ops = ShardedOps(tcfg, tmesh((2, 1, 1), [CPU] * 2), 0)
    ops.graphs = graphs
    ops.evolve_chunk(ops.put(tgeo.work_area(phi, 1)), None, None, None, done=done)
    assert graphs.keys() == []


# --------------------------------------------------------------------------- #
# the schedule
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("period, steps", [(1, 8), (3, 12)], ids=["G_even", "window_3"])
@pytest.mark.parametrize("which", ["1", "2", "G", "G+1", "G+2", "500"])
def test_schedule_is_the_eager_loop(period, steps, which):
    """With a captured segment of G steps (even, and a multiple of the
    multi-slice window) the steps a chunk makes, replays included, are the
    eager loop's: the same buffers in the same order, the ping-pong parity
    kept, each step at the same place in its window; and the launches
    counted are the chunk's steps."""
    n = {"1": 1, "2": 2, "G": steps, "G+1": steps + 1, "G+2": steps + 2, "500": 500}[which]
    rec = Recorder(period)
    owner = chunk_graph.ChunkGraphs("graph", capture=graph_like(rec))
    segment = chunk_graph.Segment("key", rec, steps, owner._capture, owner)
    out = chunk_graph.run(rec, "phi", n, segment)
    assert out == "fresh"
    assert cadence(rec.calls, period) == cadence(eager_loop(n, period), period)
    assert rec.counts["sweep_step"] == n
    fits = (n - 2) // steps if n > 2 else 0
    assert (owner.captures, owner.replays) == ((1, fits - 1) if fits else (0, 0))
    rec.calls.clear()
    chunk_graph.run(rec, "phi", n)  # the eager route: no segment
    assert rec.calls == eager_loop(n, period)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 65, 66, 100, 500, 501, 1000])
@pytest.mark.parametrize("period", [1, 2, 3, 4, 5])
def test_graph_steps(n, period):
    """G is even, a multiple of the window, fits between the chunk's first
    and last step and covers them but for fewer steps than its unit."""
    g = chunk_graph.graph_steps(n, period)
    unit = np.lcm(2, period)
    if n - 2 < unit:
        assert g == 0
        return
    assert g % unit == 0 and 0 < g <= n - 2
    assert (n - 2) % g < unit
    assert g >= min(chunk_graph.GRAPH_STEPS, (n - 2) // unit * unit)


def test_failing_capture_raises_naming_its_key():
    """A capture that fails raises ChunkGraphError with the chunk's key,
    and the chunk does not go on eagerly."""
    def broken(device, launchers, record):
        raise RuntimeError("operation not permitted when stream is capturing")

    rec = Recorder()
    graphs = chunk_graph.ChunkGraphs("graph", capture=broken)
    for _ in range(chunk_graph.EAGER_CHUNKS):  # a key's first chunks capture nothing
        graphs.run(("K1", 7), lambda: rec, "phi", 500)
    rec.calls.clear()
    with pytest.raises(terrors.ChunkGraphError, match=r"capture failed for key \('K1', 7\)"):
        graphs.run(("K1", 7), lambda: rec, "phi", 500)
    g = chunk_graph.graph_steps(500)
    assert len(rec.calls) == 1 + g  # step 0 and the warm-up segment, then nothing


# --------------------------------------------------------------------------- #
# keys: reuse and lifetime
# --------------------------------------------------------------------------- #


def test_keys_reused_and_released():
    """A key's chunk is made once, its first EAGER_CHUNKS chunks run
    eagerly and its segment is captured once after them; the chunk that
    holds a state's store is released with it, the rest at close."""
    gen = torch.Generator().manual_seed(5)
    phi = torch.randn(10, 10, 10, generator=gen)
    store = torch.randn(1, 10, 10, 10, generator=gen)
    an = ("Harmonic", 0.3, 0.02, 1.0, 8, 8, 8)
    graphs = chunk_graph.ChunkGraphs("graph", capture=rerun)
    made = []
    orig = hs.DeviceChunk.__init__

    def counting(self, *a, **k):
        made.append(k.get("store") is not None)
        orig(self, *a, **k)

    hs.DeviceChunk.__init__ = counting
    try:
        for _ in range(3):  # three ground chunks
            hs.evolve_chunk(phi, "ThreePoint", 0.02, 0.3, 1.0, 70, an, graphs=graphs)
        hs.evolve_chunk(phi, "ThreePoint", 0.02, 0.3, 1.0, 70, an, store=store, graphs=graphs)
        hs.evolve_chunk(phi, "ThreePoint", 0.02, 0.3, 1.0, 70, an, store=store, graphs=graphs)
    finally:
        hs.DeviceChunk.__init__ = orig
    assert made == [False, True] and len(graphs.keys()) == 2
    # 68 steps a chunk, one segment of 68: the ground key's third chunk
    # warms it up and captures it; the store's key runs twice, eagerly
    assert chunk_graph.EAGER_CHUNKS == 2
    assert graphs.captures == 1 and graphs.replays == 0
    graphs.release(store)  # the state ends
    (key,) = graphs.keys()
    assert key[7] is None  # the ground chunk's: no store
    graphs.close()
    assert graphs.keys() == []


def test_graphed_chunks_are_the_eager_chunks():
    """On CPU tensors (the plain versions) a chunk run through a kept key
    with its segment replayed is the per-call chunk bit for bit: real and
    pair, ground, per-step-norm, S = 1 and 2, n odd, even and shorter than
    a segment."""
    gen = torch.Generator().manual_seed(9)
    an = ("Harmonic", 0.3, 0.02, 1.0, 8, 8, 8)
    for pair in (False, True):
        lead = (2,) if pair else ()
        phi = torch.randn(*lead, 10, 10, 10, generator=gen)
        for n_store, psn in ((0, False), (0, True), (1, False), (2, False)):
            store = torch.randn(n_store, *lead, 10, 10, 10, generator=gen) if n_store else None
            graphs = chunk_graph.ChunkGraphs("graph", capture=rerun)
            for n in (67, 68, 9):
                if pair:
                    args = (phi, "ThreePoint", 0.02, 0.3, 1.0, n, an + (1.0, 0.0, 0.2))
                    chunk = hsp.evolve_chunk_sc
                else:
                    args = (phi, "ThreePoint", 0.02, 0.3, 1.0, n, an)
                    chunk = hs.evolve_chunk
                want = chunk(*args, per_step_norm=psn, store=store)
                for _ in range(4):  # eager, eager, warm-up and capture, replay
                    got = chunk(*args, per_step_norm=psn, store=store, graphs=graphs)
                    assert torch.equal(got, want), (pair, n_store, psn, n)
            # one key for all three lengths (n is no part of it): G 64, 66
            # and 6 captured at their first chunk from the third on
            assert graphs.captures == 3 and graphs.replays == 1 + 3 + 3


@pytest.mark.parametrize("mode", ["ground", "psn", "S1"])
@pytest.mark.parametrize("layout", ["flat_2_2_1", "slices_2x2_1_1"])
def test_mesh_chunks_through_kept_keys(mode, layout):
    """A mesh's chunk through a kept key with its segment replayed (every
    shard on one device, the CPU here) is the per-call chunk bit for bit;
    on a multi-slice mesh the segment is a multiple of the window."""
    _j, tcfg = configs(grid={"size": {"x": 16, "y": 8, "z": 8}, "dn": 0.3, "dt": 0.02},
                       precision="f32", output={"screen_update": 33},
                       mesh={"x": 2, "y": 1, "z": 1, "slices": 2, "slice_update": 3})
    if layout == "flat_2_2_1":
        ops = ShardedOps(tcfg, tmesh((2, 2, 1), [CPU] * 4), 1 if mode == "S1" else 0)
    else:
        ops = MultiSliceOps(tcfg, make_multislice_mesh((2, 1, 1), 2, [CPU] * 4),
                            1 if mode == "S1" else 0)
        assert ops.slice_steps == 3
    gen = torch.Generator().manual_seed(13)
    phi = ops.put(torch.randn(16, 8, 8, generator=gen))
    store = ops.put_store(torch.randn(1, 16, 8, 8, generator=gen)) if mode == "S1" else None
    chunk = ops.evolve_chunk_psn if mode == "psn" else ops.evolve_chunk
    want = chunk(phi, None, None, store)
    ops.graphs = chunk_graph.ChunkGraphs("graph", capture=rerun)
    for _ in range(4):  # eager, eager, warm-up and capture, replay
        got = chunk(phi, None, None, store)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.graphs.captures == 1 and ops.graphs.replays == 1
    (key,) = ops.graphs.keys()
    ops.graphs.release(*(store or ()))
    assert ops.graphs.keys() == ([] if mode == "S1" else [key])


# --------------------------------------------------------------------------- #
# a whole solve on the graph route (the CPU standing in for the card)
# --------------------------------------------------------------------------- #


def test_solve_on_the_graph_route(tmp_run, monkeypatch):
    """A 16³ E₀ → E₁ run with the kernel chunks and the graph route forced
    on the CPU: every state equals the per-chunk run bit for bit (the plain
    versions step the same buffers in the same order), and both stand
    within 2e-4 of ``wafer_tpu``'s run, as the solver tests hold the port.
    The ground chunks' key is reused from chunk to chunk; E₁'s stored-state
    chunk is released at its state's end and the rest when the run ends."""
    jcfg, tcfg = configs(
        precision="f32", delayed_gram=False, init_condition="Constant",
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-5, max_steps=40000, wavemax=1,
        output={"screen_update": 50, "file_type": "Json"},
    )
    run_dir.check_output_dir(jcfg.project_name)
    ref = jsolver.run(jcfg)
    monkeypatch.setattr(tsolver, "_resolve_backend", lambda config, phi: "kernel")
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(tcfg.project_name)
    eager = tsolver.run(tcfg, device=CPU)  # the CPU's route: each chunk binds its own
    assert [r.graphs["route"] for r in eager] == ["plain", "plain"]

    monkeypatch.setattr(chunk_graph, "route", lambda devices, processes=1, kernel=True: "graph")
    monkeypatch.setattr(chunk_graph, "capture_cuda", rerun)
    events = []
    orig_release, orig_close = chunk_graph.ChunkGraphs.release, chunk_graph.ChunkGraphs.close

    def release(self, *tensors):
        before = set(self.keys())
        orig_release(self, *tensors)
        events.append(("release", len(before - set(self.keys()))))

    def close(self):
        events.append(("close", len(self.keys())))
        orig_close(self)

    monkeypatch.setattr(chunk_graph.ChunkGraphs, "release", release)
    monkeypatch.setattr(chunk_graph.ChunkGraphs, "close", close)
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(tcfg.project_name)
    graphed = tsolver.run(tcfg, device=CPU)
    for g, e in zip(graphed, eager):
        assert g.steps == e.steps and g.observables == e.observables
        assert torch.equal(g.phi, e.phi)
    # 50-step chunks hold one segment of 48: a key's third chunk captures
    # it, each later one replays it
    chunks = [g.steps // 50 for g in graphed]
    assert chunks[0] > 3 and chunks[1] > 3
    assert graphed[0].graphs == {"route": "graph", "captures": 1,
                                 "capture_ms": graphed[0].graphs["capture_ms"],
                                 "replays": chunks[0] - 3}
    assert graphed[1].graphs["captures"] == 1  # its stored-state chunk
    assert events == [("release", 0), ("release", 1), ("close", 1)]
    for g, r in zip(graphed, ref):
        e_t = g.observables.energy / g.observables.norm2
        e_j = r.observables.energy / r.observables.norm2
        assert abs(e_t - e_j) < 2e-4 * abs(e_j), (e_t, e_j)
