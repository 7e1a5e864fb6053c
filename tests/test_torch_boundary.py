"""The per-chunk loop's boundary order on the CPU (``solver.converge``):
each boundary enqueues its measure, and with the delayed-GS gate engaged
the admixture of ψ before the projection, before it waits for the chunk
(``timer.read()``), then reads the measure's sums and the admixture in
one host transfer (``solver.read_boundary``). The energies and ψ are bit
for bit those of an eager order that reads every number as soon as it is
enqueued, as the loop did before."""

import dataclasses
import logging

import pytest
import torch

from tests.test_torch_hostlayer import port_config
from wafer_torch import solver as tsolver
from wafer_torch.io import run_dir as trun_dir
from wafer_torch.ops import stencil

CPU = torch.device("cpu")
LOG = logging.getLogger("wafer")
READERS = ("tolist", "item", "__float__", "__int__", "__bool__", "__complex__", "numpy", "cpu")


def _config(root, precision):
    """A 12³ E₀ → E₁ run from Gaussian noise, in chunks of ten steps,
    whose E₁ engages the delayed-GS gate at most of its boundaries;
    wavefunctions not written."""
    (root / "input").mkdir(parents=True, exist_ok=True)
    cfg = port_config(
        precision=precision, init_condition="Gaussian", sig=1.0, seed=11, wavemax=1,
        grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-6, max_steps=40000,
        output={"screen_update": 10, "file_type": "Json", "save_wavefns": False},
    )
    cfg = dataclasses.replace(cfg, input_dir=str(root / "input"),
                              output_root=str(root / "output"))
    trun_dir.reset_proj_date()
    trun_dir.check_output_dir(cfg.project_name, cfg.output_root)
    return cfg


class _Recorder:
    """Wraps what a boundary calls and logs it in order: ``overlap`` (with
    the ψ it was given and its value), ``measure`` (with its ψ), ``wait``
    (the chunk timer's read), ``read`` (a reading method of a tensor,
    counted outside the chunks), ``chunk`` and ``end`` (the evolve chunk's
    start and end), ``converge`` and ``converged`` (a state's loop), and
    the admixture the delayed-GS gate received.
    ``eager`` reads every enqueued number on the host at once (the order
    before the measure was enqueued behind the chunk)."""

    def __init__(self, monkeypatch, eager=False):
        self.log = []
        self.gate_deltas = []
        self.in_chunk = False
        for name in READERS:
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **k):
                if not self.in_chunk:
                    self.log.append(("read",))
                return _orig(t, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, counted)

        measure, overlap, evolve = tsolver._measure_device, tsolver._max_rel_overlap, stencil.evolve_chunk
        update, loop = tsolver.DelayedGramState.update, tsolver.converge

        def measure_device(phi, *a, **k):
            self.log.append(("measure", phi))
            sums, out = measure(phi, *a, **k)
            if eager:
                [s.item() for s in sums]
            return sums, out

        def max_rel_overlap(phi, stacked):
            delta = overlap(phi, stacked)
            self.log.append(("overlap", phi, delta.clone()))
            if eager:
                delta.item()
            return delta

        def evolve_chunk(*a, **k):
            self.log.append(("chunk",))
            self.in_chunk = True
            try:
                return evolve(*a, **k)
            finally:
                self.in_chunk = False
                self.log.append(("end",))

        def gate_update(state, *a, measured_delta=None, **k):
            self.gate_deltas.append(measured_delta)
            return update(state, *a, measured_delta=measured_delta, **k)

        recorder = self

        class Timer(tsolver._ChunkTimer):
            def read(self):
                recorder.log.append(("wait",))
                return super().read()

        def converge(*a, **k):
            self.log.append(("converge",))
            try:
                return loop(*a, **k)
            finally:
                self.log.append(("converged",))

        monkeypatch.setattr(tsolver, "converge", converge)
        monkeypatch.setattr(tsolver, "_measure_device", measure_device)
        monkeypatch.setattr(tsolver, "_max_rel_overlap", max_rel_overlap)
        monkeypatch.setattr(stencil, "evolve_chunk", evolve_chunk)
        monkeypatch.setattr(tsolver.DelayedGramState, "update", gate_update)
        monkeypatch.setattr(tsolver, "_ChunkTimer", Timer)

    def boundaries(self):
        """Each state's boundaries: the events of its ``converge`` between
        two chunks, the first from the loop's start, the last to its end."""
        out, inside = [], False
        for event in self.log:
            if event[0] in ("converge", "converged"):
                inside = event[0] == "converge"
                if inside:
                    out.append([[]])
            elif event[0] == "end":
                out[-1].append([])
            elif event[0] != "chunk" and inside:
                out[-1][-1].append(event)
        return out


def _run(cfg):
    return tsolver.run(cfg, LOG, device=CPU)


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_each_boundary_enqueues_its_measure_then_waits_then_reads_once(
        tmp_path, monkeypatch, precision):
    rec = _Recorder(monkeypatch)
    results = _run(_config(tmp_path, precision))
    assert [r.wnum for r in results] == [0, 1]
    per_state = rec.boundaries()
    assert len(per_state) == 2
    engaged = 0
    for result, bounds in zip(results, per_state):
        assert len(bounds) == result.steps // 10 + 1  # one more measure than chunks
        for events in bounds:
            kinds = [e[0] for e in events]
            if kinds[0] == "overlap":
                engaged += 1
                kinds = kinds[1:]
            assert kinds == ["measure", "wait", "read"], kinds
    assert engaged >= 5, "the delayed-GS gate hardly engaged in E₁"


def test_the_gate_gets_the_admixture_before_the_projection(tmp_path, monkeypatch):
    rec = _Recorder(monkeypatch)
    _run(_config(tmp_path, "f32"))
    at = [i for i, e in enumerate(rec.log) if e[0] == "overlap"]
    measured = [d for d in rec.gate_deltas if d is not None]
    assert at and len(measured) == len(at)
    for i, got in zip(at, measured):
        _kind, phi, delta = rec.log[i]
        nxt = rec.log[i + 1]
        assert nxt[0] == "measure" and nxt[1] is phi  # the ψ before the measure projects
        assert got == float(delta)
    # the ψ the gate measured still held its lower-state admixture
    assert max(measured) > 0.0


def test_the_order_moves_no_bit_of_the_answers(tmp_path, monkeypatch):
    with monkeypatch.context() as m:
        _Recorder(m, eager=True)
        ref = _run(_config(tmp_path / "eager", "f32"))
    rec = _Recorder(monkeypatch)
    out = _run(_config(tmp_path / "enqueued", "f32"))
    assert [r.steps for r in out] == [r.steps for r in ref]
    for a, b in zip(ref, out):
        assert a.observables == b.observables
        assert torch.equal(a.phi, b.phi)
    assert any(d is not None for d in rec.gate_deltas)


def test_read_boundary_reads_once_and_keeps_every_bit(monkeypatch):
    sums = (torch.tensor(2.5, dtype=torch.float64), torch.tensor(1.25, dtype=torch.float64),
            torch.tensor(0.0, dtype=torch.float64), torch.tensor(3.0, dtype=torch.float64))
    delta = torch.tensor(1e-3, dtype=torch.float32)
    exact = float(delta)
    reads = []
    for name in READERS:
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda t, *a, _o=orig, _n=name, **k: reads.append(_n) or _o(t, *a, **k))
    obs, measured = tsolver.read_boundary(sums, delta)
    assert reads == ["tolist"]
    assert measured == exact and obs.energy == 2.5 and obs.r2 == 3.0
    obs, measured = tsolver.read_boundary(sums + (torch.tensor(0.5, dtype=torch.float64),))
    assert measured is None and obs.energy == complex(2.5, 1.25) and obs.r2 == 0.5
    assert reads == ["tolist", "tolist"]
