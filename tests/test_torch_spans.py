"""The port's host spans (``wafer_torch/utils/spans.py``) on the CPU: the
helper is a shared no-op without a profiler and a recorded range under
one; a two-state solve records each ``wafer.*`` span where its work is,
and they nest, none open across the progress hook's ``finish``; the
bound chunks name their eager chunks and their one capture."""

import dataclasses
import logging

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tests.test_torch_chunk_graph import Recorder, graph_like
from tests.test_torch_hostlayer import port_config
from wafer_torch import chunk_graph, solver as tsolver
from wafer_torch.io import run_dir as trun_dir
from wafer_torch.utils import spans

CPU = torch.device("cpu")
LOG = logging.getLogger("wafer")
STATE = "test.state."  # the progress hook's span of one state, as a caller's
FINISH = "test.finish"


def _spans(prof, prefix=("wafer.", "test.")):
    """(name, start µs, end µs) of the recorded host spans, by start."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith(prefix)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _count(found, name):
    return sum(1 for n, _s, _e in found if n == name)


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


class _Progress:
    """A progress hook that holds its state in a span of its own, opened
    when it is made and closed by ``finish``, as a caller's hook may."""

    def __init__(self, wnum):
        self.span = record_function(f"{STATE}{wnum}")
        self.span.__enter__()
        self.messages = 0

    def set_position(self, percent):
        pass

    def set_message(self, msg):
        self.messages += 1

    def finish(self):
        with record_function(FINISH):
            pass
        self.span.__exit__(None, None, None)


def test_no_profiler_gives_the_shared_no_op():
    a, b = spans.span("wafer.a"), spans.span("wafer.b")
    assert a is b
    with a:
        pass


def test_under_a_profiler_the_span_is_recorded():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx = spans.span("wafer.example")
        assert ctx is not spans.span("wafer.other")
        with ctx:
            torch.ones(3).sum()
    assert _count(_spans(prof), "wafer.example") == 1
    assert spans.span("wafer.after") is spans.span("wafer.again")  # off once it stops


@pytest.fixture(scope="module")
def two_states(tmp_path_factory):
    """A 12³ E₀ → E₁ run (Gaussian noise, delayed re-orthogonalisation on)
    under a CPU profiler, through a progress hook that records its spans."""
    root = tmp_path_factory.mktemp("spans")
    (root / "input").mkdir()
    cfg = port_config(
        precision="f32", init_condition="Gaussian", sig=1.0, seed=11, wavemax=1,
        grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-5, max_steps=40000, output={"screen_update": 50, "file_type": "Json"},
    )
    cfg = dataclasses.replace(cfg, input_dir=str(root / "input"),
                              output_root=str(root / "output"))
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(cfg.project_name, cfg.output_root)
    hooks = []

    def factory(wnum):
        hooks.append(_Progress(wnum))
        return hooks[-1]

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.solve"):
            results = tsolver.run(cfg, LOG, progress_factory=factory, device=CPU)
    return results, hooks, _spans(prof)


def test_a_solve_records_each_span_where_its_work_is(two_states):
    results, hooks, found = two_states
    assert [r.wnum for r in results] == [0, 1]
    chunks = sum(r.steps for r in results) // 50
    assert _count(found, "wafer.load_potentials") == 1
    for name in ("wafer.state_setup", "wafer.initial_condition", "wafer.state_finish"):
        assert _count(found, name) == 2, name
    measures = [s for s in found if s[0] == "wafer.measure"]
    assert len(measures) == chunks + 2  # each state measures once more than it evolves
    assert _count(found, "wafer.evolve_chunk") == chunks
    assert _count(found, "wafer.chunk_wait") == chunks + 2
    assert _count(found, "wafer.boundary") == chunks + 2
    reads = [s for s in found if s[0] == "wafer.host_read"]
    # one read a boundary, the delayed-GS gate's admixture in it: each
    # measure, enqueued behind the chunk, is followed by the wait for that
    # chunk and then by the read
    assert len(reads) == len(measures)
    loop = [s for s in found if s[0] in ("wafer.measure", "wafer.chunk_wait", "wafer.host_read")]
    for i, m in enumerate(loop):
        if m[0] == "wafer.measure":
            assert [s[0] for s in loop[i + 1:i + 3]] == ["wafer.chunk_wait", "wafer.host_read"]
            assert m[2] <= loop[i + 1][1] and loop[i + 1][2] <= loop[i + 2][1]
    setups = [s for s in found if s[0] == "wafer.state_setup"]
    for s in found:
        if s[0] == "wafer.initial_condition":
            assert any(_inside(s, o) for o in setups)
    assert sum(h.messages for h in hooks) == chunks


def test_spans_nest_and_none_is_open_across_finish(two_states):
    _results, hooks, found = two_states
    assert len(hooks) == 2
    for i, a in enumerate(found):
        for b in found[i + 1:]:
            assert b[1] >= a[2] or _inside(b, a), (a, b)  # disjoint, or b within a
    states = [s for s in found if s[0].startswith(STATE)]
    finishes = [s for s in found if s[0] == FINISH]
    assert len(states) == len(finishes) == 2
    for f in finishes:
        assert not any(s[0].startswith("wafer.") and _inside(f, s) for s in found)
    outside = {"wafer.load_potentials", "wafer.state_finish"}
    for s in found:
        if s[0].startswith("wafer.") and s[0] not in outside:
            assert any(_inside(s, st) for st in states), s
        if s[0] in outside:
            assert not any(_inside(s, st) for st in states), s


class _Stop(Exception):
    pass


def test_no_span_is_open_when_the_hook_ends_the_state_early(tmp_run):
    """A hook that ends its state from ``set_message`` and raises (a caller
    whose time is up) finds no ``wafer.*`` span open."""

    class Closing(_Progress):
        def set_message(self, msg):
            super().set_message(msg)
            if self.messages == 3:
                self.finish()
                raise _Stop

    cfg = port_config(precision="f32", tolerance=1e-12, max_steps=40000,
                      grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.3, "dt": 0.02},
                      output={"screen_update": 50, "file_type": "Json"})
    trun_dir.check_output_dir(cfg.project_name)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(_Stop):
            tsolver.run(cfg, LOG, progress_factory=Closing, device=CPU)
    found = _spans(prof)
    (finish,) = [s for s in found if s[0] == FINISH]
    assert not any(s[0].startswith("wafer.") and _inside(finish, s) for s in found)
    assert _count(found, "wafer.state_finish") == 0


def test_bound_chunks_name_eager_chunks_and_the_capture():
    rec = Recorder()
    graphs = chunk_graph.ChunkGraphs("graph", capture=graph_like(rec))
    n = chunk_graph.EAGER_CHUNKS + 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            graphs.run(("K1", 0), lambda: rec, "phi", 130)
    found = _spans(prof)
    assert _count(found, "wafer.chunk_eager") == chunk_graph.EAGER_CHUNKS
    assert _count(found, "wafer.graph_capture") == 1
    per_chunk = 128 // chunk_graph.graph_steps(130)  # segments between the eager ends
    assert (graphs.captures, graphs.replays) == (
        1, per_chunk * (n - chunk_graph.EAGER_CHUNKS) - 1)
