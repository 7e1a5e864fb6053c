"""The delayed-GS gate's tracing in the port on the CPU. Under a profiler a
20³ Coulomb three-state job (the 256³ north star's keys on a 10-wide box,
where the gate engages and releases in both excited states) opens
``wafer.admixture`` inside ``wafer.measure`` at exactly the boundaries
after a chunk that ran delayed, and ``SolveResult.gate`` counts the
state's chunks by the route they ran and the gate's engagements and
releases as its log lines tell them. There is no counter for the ground
state, under ``sync_update`` batching or with ``delayed_gram: false``; a
mesh counts as one device does."""

import dataclasses
import logging

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.test_torch_hostlayer import port_config
from tests.test_torch_spans import STATE, _Progress, _inside
from wafer_torch import solver as tsolver
from wafer_torch.io import run_dir as trun_dir
from wafer_torch.ops import stencil
from wafer_torch.parallel import make_mesh

CPU = torch.device("cpu")
SU = 100
# the north star (dn 0.0625, dt 1.3e-3 at 256³) on a 20³ grid of a 10-wide box
COULOMB = dict(
    precision="f32", potential="Coulomb", init_condition="Coulomb", sig=1.0, wavemax=2,
    grid={"size": {"x": 20, "y": 20, "z": 20}, "dn": 0.5, "dt": 0.05},
    tolerance=1e-6, max_steps=100000, output={"screen_update": SU, "file_type": "Json"},
)
ENGAGED = "Delayed re-orthogonalisation engaged"
RELEASED = "Delayed re-orthogonalisation released"


class _Events(logging.Handler):
    """The solve's log messages, in one list with the chunks' routes and
    each state's start."""

    def __init__(self, events):
        super().__init__(logging.INFO)
        self.events = events

    def emit(self, record):
        self.events.append(("log", record.getMessage()))


def _job(root, device_mesh=None, **overrides):
    """The Coulomb job under a CPU profiler: (results, spans, events), the
    events each state's start, every chunk's route (True: delayed, no
    stored states) and every log message, in order."""
    (root / "input").mkdir(exist_ok=True)
    cfg = dataclasses.replace(port_config(**{**COULOMB, **overrides}),
                              input_dir=str(root / "input"), output_root=str(root / "output"))
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(cfg.project_name, cfg.output_root)
    events = []
    log = logging.getLogger(f"wafer.gate_trace.{root.name}")
    log.setLevel(logging.INFO)
    handler = _Events(events)
    log.addHandler(handler)
    chunk = stencil.evolve_chunk

    def routed(phi, a, b, store, *rest, **kw):
        events.append(("chunk", store is None))
        return chunk(phi, a, b, store, *rest, **kw)

    def factory(wnum):
        events.append(("state", wnum))
        return _Progress(wnum)

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(stencil, "evolve_chunk", routed)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                results = tsolver.run(cfg, log, progress_factory=factory, device=CPU,
                                     mesh=device_mesh)
    finally:
        log.removeHandler(handler)
    return results, _spans(prof), events


def _spans(prof):
    """(name, start ns, end ns) of the recorded ``wafer.*`` and state spans,
    by start, from the profiler's raw events (building its event tree for
    every operation of a CPU solve takes minutes)."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type().name == "CPU" and e.name().startswith(("wafer.", STATE))]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _by_state(events, kind):
    """Each state's events of ``kind``, in order."""
    out = {}
    for event in events:
        if event[0] == "state":
            out[event[1]] = []
        elif event[0] == kind and out:
            out[max(out)].append(event[1])
    return out


def _boundaries(found, wnum):
    """For each ``wafer.measure`` of state ``wnum``, in order, whether a
    ``wafer.admixture`` lies inside it."""
    (state,) = [s for s in found if s[0] == f"{STATE}{wnum}"]
    measures = [s for s in found if s[0] == "wafer.measure" and _inside(s, state)]
    admixtures = [s for s in found if s[0] == "wafer.admixture" and _inside(s, state)]
    return [any(_inside(a, m) for a in admixtures) for m in measures]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return _job(tmp_path_factory.mktemp("gate"))


@pytest.mark.parametrize("wnum", [1, 2])
def test_the_gate_engages_in_the_job(job, wnum):
    results, _found, _events = job
    assert results[wnum].gate["delayed_chunks"] >= 1 and results[wnum].gate["engaged"] >= 1


@pytest.mark.parametrize("wnum", [1, 2])
def test_an_admixture_span_is_at_each_boundary_after_a_delayed_chunk_and_only_there(job, wnum):
    _results, found, events = job
    delayed = _by_state(events, "chunk")[wnum]
    # a state's first measure has no chunk before it
    assert _boundaries(found, wnum) == [False] + delayed


def test_every_admixture_lies_inside_a_measure(job):
    _results, found, _events = job
    measures = [s for s in found if s[0] == "wafer.measure"]
    admixtures = [s for s in found if s[0] == "wafer.admixture"]
    assert admixtures
    assert all(any(_inside(a, m) for m in measures) for a in admixtures)
    assert not _boundaries(found, 0).count(True)


@pytest.mark.parametrize("wnum", [1, 2])
def test_the_counter_counts_each_chunk_by_its_route(job, wnum):
    results, _found, events = job
    gate, delayed = results[wnum].gate, _by_state(events, "chunk")[wnum]
    assert gate["delayed_chunks"] + gate["stored_chunks"] == results[wnum].steps // SU
    assert (gate["delayed_chunks"], gate["stored_chunks"]) == (
        delayed.count(True), delayed.count(False))


@pytest.mark.parametrize("wnum", [1, 2])
def test_engagements_and_releases_are_the_gates_log_lines(job, wnum):
    results, _found, events = job
    lines = _by_state(events, "log")[wnum]
    gate = results[wnum].gate
    assert gate["engaged"] == sum(m.startswith(ENGAGED) for m in lines)
    assert gate["released"] == sum(m.startswith(RELEASED) for m in lines)
    assert any(m.startswith(f"State {wnum} converged in {results[wnum].steps} steps: "
                            f"{gate['delayed_chunks']} delayed-GS") for m in lines)


def test_the_ground_state_has_no_counter(job):
    results, _found, _events = job
    assert results[0].gate is None


@pytest.mark.parametrize("overrides", [dict(sync_update=2), dict(delayed_gram=False)],
                         ids=["sync_update", "delayed_gram_off"])
def test_no_counter_and_no_admixture_where_the_gate_is_off(tmp_path, overrides):
    results, found, events = _job(tmp_path, wavemax=1, **overrides)
    assert [r.gate for r in results] == [None, None]
    assert not any(s[0] == "wafer.admixture" for s in found)
    assert not any(m.startswith(ENGAGED) for m in _by_state(events, "log")[1])


def test_a_mesh_counts_the_gate_as_one_device_does(tmp_path):
    results, found, _events = _job(tmp_path, device_mesh=make_mesh((2, 1, 1), [CPU] * 2),
                                   wavemax=1, mesh={"x": 2})
    assert results[0].gate is None
    gate = results[1].gate
    assert gate["delayed_chunks"] + gate["stored_chunks"] == results[1].steps // SU
    assert sum(_boundaries(found, 1)) == gate["delayed_chunks"]
