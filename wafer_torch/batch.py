"""``sync_update`` batching: k chunks per host read, the convergence verdict
on the device (counterpart of ``pick_batch_k`` and ``make_batched_runner``,
wafer_tpu/solver.py:94-239).

The reference runs k × (measure → f64 verdict → evolve) in one jitted
``lax.scan`` and reads every chunk's observable row once per batch; the
host loop (``solver.converge``) then replays the rows, so the printed rows,
guards, snapshots and ``max_steps`` are those of the per-chunk loop.

Here one iteration is a function of device tensors only: the measure's
0-d sums (no host read), the verdict ``|E/N − last| < tol`` in f64 (for a
pair the modulus, ``torch.hypot``), the observable row written into a
static f64 buffer, a done flag that the chunk's kernels (K1, K2, K3) read
on the device, and masks that keep ψ, and the measured ψ of the converged
row (ψ_conv), once the verdict is in. Torch has no ``lax.cond``: after the
verdict the iterations still run, but the flagged kernels return at once
and the masks discard the rest, so an idle chunk costs its launches and
the measure. On the CPU, and for the plain sweeps, idle chunks compute and
their work is discarded.

On a CUDA device, with every shard on one card, the iteration is captured
as a CUDA graph and replayed k times a batch: the first iteration at a key
(per-step norm, stored states, ψ's layout) runs eagerly as the warm-up and
its result is used, then the capture follows. The graphs and their memory
pools are freed when the state ends (:meth:`BatchRunner.close`). A mesh
over several cards runs the same iterations eagerly, still one read a
batch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch
from torch.profiler import record_function

from wafer_torch.ops import hopper_stencil
from wafer_torch.ops.observables import Observables


def pick_batch_k(
    step: int,
    k_sync: int,
    su: int,
    snap_update: Optional[int],
    max_steps: Optional[int],
) -> int:
    """Chunks the next device batch may run (reference
    wafer_tpu/solver.py:94-125). The first chunk is host-side, a batch
    never crosses a snapshot step (its host IO needs ψ), and on the
    ``max_steps`` tail the batch follows the ladder {k_sync, 4, 2, 1}
    (each k is a compile in the reference; here it bounds nothing, but the
    cadence is the reference's)."""
    if k_sync <= 1 or step == 0:
        return 1
    k = k_sync
    if snap_update is not None:
        to_snap = (-step) % snap_update
        n_chunks = to_snap // su
        if n_chunks == 0:
            return 1  # this chunk writes the snapshot
        k = min(k, n_chunks)
    if max_steps is not None:
        remaining = (max_steps - step) // su + 1
        if remaining < k:
            for cand in (4, 2):
                if cand <= remaining and cand < k:
                    return cand
            return 1
    return max(k, 1)


def _blocks(phi) -> List[torch.Tensor]:
    return [phi] if isinstance(phi, torch.Tensor) else list(phi)


def _like(phi, blocks: List[torch.Tensor]):
    return blocks[0] if isinstance(phi, torch.Tensor) else blocks


@dataclass
class Batch:
    """One batch's outcome, read on the host once: the rows of the chunks
    that ran, each (Observables, the device's verdict), ψ after the last
    working chunk (``phi``) and the measured ψ of the converged row
    (``conv``), and the chunks that ran flagged done (``idle``)."""

    rows: List[Tuple[Observables, bool]]
    phi: object
    conv: object
    idle: int


class BatchRunner:
    """k iterations of measure → verdict → flagged chunk on the device per
    host read, for one state (reference ``make_batched_runner``).

    ``measure(phi) -> (sums, phi)``: the 0-d sums (energy, or its Re and Im
    for a pair, then norm², V∞, ⟨r²⟩) and ψ normalised and projected, with
    no host read. ``evolve(phi, per_step_norm, delayed_gs, done)``: one
    chunk whose kernels skip while the 0-d int32 flag ``done`` is set.
    ``phi`` is a padded tensor or a list of shard blocks. ``graphs``
    captures the iteration as a CUDA graph (every block on one card);
    ``stream_dtype``, the chunks' stored-state streams, is part of a
    graph's key beside ``n_lower``.
    Counters for the record: ``batches``, ``chunks``, ``idle``,
    ``captures`` and ``capture_seconds`` (host time of the captures)."""

    def __init__(self, measure: Callable, evolve: Callable, tolerance: float, *, pair: bool,
                 n_lower: int, graphs: bool, stream_dtype: torch.dtype = torch.float32):
        self.measure = measure
        self.evolve = evolve
        self.tolerance = float(tolerance)
        self.pair = pair
        self.n_lower = n_lower
        self.stream_dtype = stream_dtype
        self.graphs = graphs
        self._state = None  # (phi, conv, last_e, done, row): the iteration's static tensors
        self._phi_like = None  # ψ as the caller holds it: a tensor or a list of blocks
        self._graphs = {}   # key -> (CUDAGraph, launches one replay makes)
        self._stream = None
        self.batches = self.chunks = self.idle = self.captures = 0
        self.capture_seconds = 0.0

    # ------------------------------------------------------------------ #

    def _alloc(self, phi) -> None:
        blocks = _blocks(phi)
        dev = blocks[0].device
        f64 = torch.float64
        n_cols = (2 if self.pair else 1) + 3 + 2  # energy, n², V∞, ⟨r²⟩, exec, done
        self._state = (
            [torch.empty_like(b) for b in blocks],
            [torch.empty_like(b) for b in blocks],
            torch.zeros(2 if self.pair else (), dtype=f64, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros(n_cols, dtype=f64, device=dev),
        )

    def _iterate(self, per_step_norm: bool) -> None:
        """One iteration on the static tensors, device work only: the
        reference's ``lax.cond(done, idle, work)`` body with the branch
        taken by masks and by the kernels' flag."""
        phi_s, conv_s, last_e, done, row = self._state
        f64 = torch.float64
        done_prev = done != 0
        with record_function("wafer.measure"):
            sums, phi_n = self.measure(_like(self._phi_like, phi_s))
        vals = torch.stack([s.to(f64) for s in sums])
        n2 = vals[-3]
        if self.pair:
            norm_e = vals[:2] / n2
            delta = norm_e - last_e
            diff = torch.hypot(delta[0], delta[1])
        else:
            norm_e = vals[0] / n2
            diff = torch.abs(norm_e - last_e)
        verdict = (diff < self.tolerance) & ~done_prev  # this row converged
        done_now = done_prev | verdict
        row.copy_(torch.cat([vals, (~done_prev).to(f64)[None], verdict.to(f64)[None]]))
        last_e.copy_(torch.where(done_prev, last_e, norm_e))
        done.copy_(done_now)
        with record_function("wafer.evolve_chunk"):
            nxt = _blocks(self.evolve(phi_n, per_step_norm, False, done))
        for p, c, m, x in zip(phi_s, conv_s, _blocks(phi_n), nxt):
            c.copy_(torch.where(verdict, m, c))
            torch.where(done_now, c, x, out=p)

    def _capture(self, key, per_step_norm: bool) -> None:
        """Capture one iteration at ``key`` after its eager warm-up (which
        ran every launch's one-time set-up, such as the sweeps'
        shared-memory attribute). A launch counts when it runs, so the
        capture's count moves to each replay."""
        dev = self._state[3].device
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        before = dict(hopper_stencil.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream):
            self._iterate(per_step_norm)
        launched = {k: hopper_stencil.LAUNCHES[k] - before[k] for k in before}
        hopper_stencil.LAUNCHES.update(before)
        self._graphs[key] = (graph, launched)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t

    # ------------------------------------------------------------------ #

    def run(self, phi, last_energy, k: int, per_step_norm: bool, timer=None) -> Batch:
        """``k`` chunk iterations from ``phi`` with the previous normalised
        energy ``last_energy`` (complex for a pair), then one host read of
        the rows. ``timer`` (``solver._ChunkTimer``) brackets the
        iterations, measures included, and not the captures."""
        if self._state is None:
            self._alloc(phi)
        self._phi_like = phi
        phi_s, conv_s, last_e, done, row = self._state
        for p, c, x in zip(phi_s, conv_s, _blocks(phi)):
            if x is not p:
                p.copy_(x)
            c.copy_(p)
        if self.pair:
            e = complex(last_energy)
            last_e[0].fill_(e.real)
            last_e[1].fill_(e.imag)
        else:
            last_e.fill_(float(last_energy))
        done.zero_()
        rows = torch.empty((k, row.shape[0]), dtype=torch.float64, device=row.device)
        key = (per_step_norm, self.n_lower, self.stream_dtype,
               tuple((tuple(b.shape), b.dtype, b.device) for b in phi_s))
        if timer is not None:
            timer.start()
        self._iterations(rows, key, per_step_norm, timer)
        if timer is not None:
            timer.stop()
        return self._read(rows, k)

    def _iterations(self, rows, key, per_step_norm: bool, timer) -> None:
        """The batch's device work: each iteration a replay of the key's
        graph, or eagerly (every iteration without graphs; with them the
        key's first, its warm-up, whose capture follows with the timer
        stopped: a capture waits for the device once). Nothing here reads
        the device on the host."""
        row = self._state[4]
        for j in range(rows.shape[0]):
            entry = self._graphs.get(key)
            if entry is None:
                self._iterate(per_step_norm)
            else:
                entry[0].replay()
                for name, n in entry[1].items():
                    hopper_stencil.LAUNCHES[name] += n
            rows[j].copy_(row)
            if entry is None and self.graphs:
                if timer is not None:
                    timer.stop()
                self._capture(key, per_step_norm)
                if timer is not None:
                    timer.start()

    def _read(self, rows, k: int) -> Batch:
        vals = rows.tolist()  # the batch's one host read
        n_e = 2 if self.pair else 1
        out = []
        idle = 0
        for j, r in enumerate(vals):
            if not r[-2]:
                break
            energy = complex(r[0], r[1]) if self.pair else r[0]
            obs = Observables(energy=energy, norm2=r[n_e], v_infinity=r[n_e + 1],
                              r2=r[n_e + 2])
            out.append((obs, bool(r[-1])))
            if r[-1]:
                idle = k - j
                break
        self.batches += 1
        self.chunks += k
        self.idle += idle
        phi_s, conv_s = self._state[:2]
        return Batch(rows=out, phi=_like(self._phi_like, phi_s),
                     conv=_like(self._phi_like, conv_s), idle=idle)

    def close(self) -> None:
        """Free the graphs, their memory pools and the static tensors (once
        the state has converged or stopped)."""
        captured = bool(self._graphs)
        for graph, _launched in self._graphs.values():
            graph.reset()
        self._graphs.clear()
        self._state = None
        self._phi_like = None
        if captured:
            torch.cuda.empty_cache()

    def stats(self) -> dict:
        return {"batches": self.batches, "chunks": self.chunks, "idle_chunks": self.idle,
                "captures": self.captures, "capture_ms": self.capture_seconds * 1e3}
