"""One device program per ``screen_update`` chunk: the chunk's launches
captured once as a CUDA graph and replayed (the counterpart of the
reference dispatching each chunk as one jitted ``evolve_chunk_resident``,
wafer_tpu/ops/pallas_stencil.py:2733-2760, whose time loop runs inside one
``pallas_call``).

Each chunk's module (``hopper_stencil.DeviceChunk`` for one device,
``parallel/sharded.py`` for a mesh) makes a *bound chunk* once per key: the
two ping-pong buffers, the coefficients and reduction buffers, the halo
plans, and K1/K3 and K2 bound to them (``hopper_stencil.bind_sweep``,
``finish_launcher``), so a step only launches. :func:`run` is the schedule
every chunk takes, with or without a graph:

- step 0 eagerly from the caller's ψ into buffer 0 (no copy of ψ on one
  device; a mesh copies ψ's blocks into its own buffer first, as it cloned
  them before);
- a segment of G steps (:func:`graph_steps`: G even, so a replay starts and
  ends on buffer 0, and a multiple of the chunk's ``period``, a multi-slice
  window, so the x exchanges keep their cadence) replayed while whole
  segments fit before the last step;
- the steps left over eagerly, and the last step into a fresh buffer, so
  the chunk's result never aliases a buffer the next chunk writes.

Every step launches what the eager loop launches, on the same buffers in
the same order, so a graphed chunk is the eager chunk bit for bit.

:class:`ChunkGraphs` keeps a solve's bound chunks by key and, on the graph
route, each key's segment: a key's first :data:`EAGER_CHUNKS` chunks run
eagerly, then its segment runs eagerly once more (the warm-up: every
launch's one-time set-up), is captured on a stream of its own and is
replayed from then on. :data:`hopper_stencil.LAUNCHES` counts a replay as
the launches its capture made. Chunks whose stored states or streamed B
belong to one state are released at that state's end
(:meth:`ChunkGraphs.release`), the rest at the end of the solve
(:meth:`ChunkGraphs.close`).

Routes (:func:`route`), chosen once a solve: ``graph`` where ψ lies on one
CUDA device of one process; ``eager`` through the bound launchers where it
spans several devices or processes (no graph captures a copy between
devices, a host stage or a collective); ``plain`` where the chunks run the
plain torch ops (the CPU, f64, the plain backend). A ``sync_update`` batch
captures whole iterations itself (``batch.BatchRunner``): its chunks take
neither a cached chunk nor a segment.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import time
from typing import Callable, Dict, Hashable, Optional

import torch

from wafer_torch.errors import ChunkGraphError, WaferError

# the least steps a captured segment holds, where the chunk has them
# (graph_steps): a replay must cover its host call with device work, and a
# capture costs host time a step. Chosen from card times (chip_smoke.py 4j).
GRAPH_STEPS = 64
# a key's first chunks run eagerly through its bound launchers: a capture
# costs 3-30 ms of host time on the card's shared host and saves about
# 1.5 ms a chunk at 64x64x128 (the bound launchers already save the rest;
# tools/time_chunk_graph.py), so a key that a short state runs once or
# twice never captures
EAGER_CHUNKS = 2


@functools.lru_cache(maxsize=None)
def graph_steps(n_steps: int, period: int = 1) -> int:
    """G, the steps of one captured segment of an ``n_steps`` chunk: a
    multiple of ``lcm(2, period)``, and of the ``n_steps − 2`` steps
    between the chunk's first and last (both eager) as many as whole
    segments cover, in the fewest segments of at least
    :data:`GRAPH_STEPS` steps, so no step of a full chunk is left over
    beyond what the unit forces. 0 when no segment fits."""
    unit = 2 * period // math.gcd(2, period)
    units = (n_steps - 2) // unit
    if units < 1:
        return 0
    return unit * next((d for d in range(1, units + 1)
                        if units % d == 0 and unit * d >= GRAPH_STEPS), units)


def route(devices, processes: int = 1, kernel: bool = True) -> str:
    """The chunks' route for ψ on ``devices`` (this process's) in a run of
    ``processes``: ``"graph"``, ``"eager"`` or ``"plain"`` (see the
    module's notes); ``kernel`` is whether the chunks take the kernels."""
    devs = set(devices)
    if not kernel or any(d.type != "cuda" for d in devs):
        return "plain"
    return "graph" if processes == 1 and len(devs) == 1 else "eager"


def describe(chosen: str, devices, processes: int = 1) -> str:
    """The route in words, for the solve's log line."""
    if chosen == "graph":
        return "as a CUDA graph of each chunk's steps, captured once a key and replayed"
    if chosen == "plain":
        return "on the plain torch ops"
    why = (f"ψ spans {processes} processes" if processes > 1
           else f"ψ spans {len(set(devices))} devices")
    return f"eagerly through launchers bound once a key ({why})"


def run(chunk, phi, n_steps: int, segment: Optional["Segment"] = None):
    """One chunk of ``n_steps`` steps from ``phi`` on a bound ``chunk``,
    with the middle steps replayed from ``segment`` where it is given (the
    schedule of the module's notes). Returns the chunk's result, which no
    buffer of ``chunk`` aliases."""
    launch = chunk.eager
    bufs = chunk.bufs
    src = chunk.begin(phi)
    last = chunk.fresh()
    chunk.step(launch, 0, src, bufs[0] if n_steps > 1 else last)
    t = 1
    if segment is not None:
        while t + segment.steps < n_steps:
            segment.replay()
            t += segment.steps
    for t in range(t, n_steps - 1):
        chunk.step(launch, t, bufs[(t - 1) % 2], bufs[t % 2])
    if n_steps > 1:
        chunk.step(launch, n_steps - 1, bufs[n_steps % 2], last)
    return chunk.end(last)


def capture_cuda(device: torch.device, launchers: Callable, record: Callable):
    """Capture ``record(launch)`` as a CUDA graph on a stream of its own,
    ``launch`` the chunk's launchers bound to that stream (made before the
    capture begins: K2's scratch is zeroed outside the graph). Returns the
    graph, which holds the launchers while it lives; it replays on the
    current stream."""
    with capture_stream(device) as stream:
        launch = launchers(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                record(launch)
            finally:
                graph.capture_end()
    graph.launchers = launch
    return graph


@functools.lru_cache(maxsize=None)
def _libcuda():
    drv = ctypes.CDLL("libcuda.so.1")
    for name, args in (("cuDevicePrimaryCtxRetain", [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]),
                       ("cuDevicePrimaryCtxRelease_v2", [ctypes.c_int]),
                       ("cuCtxPushCurrent_v2", [ctypes.c_void_p]),
                       ("cuCtxPopCurrent_v2", [ctypes.POINTER(ctypes.c_void_p)]),
                       ("cuStreamCreate", [ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint]),
                       ("cuStreamDestroy_v2", [ctypes.c_void_p])):
        fn = getattr(drv, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return drv


def _check(what: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{what} returned CUresult {code}")


@contextlib.contextmanager
def capture_stream(device: torch.device):
    """A non-blocking stream of ``device``'s primary context for one
    capture, made and destroyed through libcuda: a
    ``torch.cuda.Stream`` comes from torch's stream pool, which creates
    every stream of the pool on its first use (8-33 ms of host time on an
    H100's host), a cost a short state would pay with its first capture."""
    drv, index = _libcuda(), device.index if device.index is not None else 0
    ctx, handle, popped = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
    _check("cuDevicePrimaryCtxRetain", drv.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), index))
    try:
        _check("cuCtxPushCurrent", drv.cuCtxPushCurrent_v2(ctx))
        try:
            _check("cuStreamCreate", drv.cuStreamCreate(ctypes.byref(handle), 1))  # non-blocking
        finally:
            _check("cuCtxPopCurrent", drv.cuCtxPopCurrent_v2(ctypes.byref(popped)))
        try:
            yield torch.cuda.ExternalStream(handle.value, device=device)
        finally:
            _check("cuStreamDestroy", drv.cuStreamDestroy_v2(handle))
    finally:
        drv.cuDevicePrimaryCtxRelease_v2(index)


class Segment:
    """G steps of a bound chunk from buffer 0 back to buffer 0, replayed as
    one graph. The first :meth:`replay` runs the steps eagerly and then
    captures them; each later one replays the graph."""

    def __init__(self, key, chunk, steps: int, capture: Callable, owner: "ChunkGraphs"):
        self.key, self.chunk, self.steps = key, chunk, steps
        self._capture, self._owner = capture, owner
        self.graph = None
        self.launched: Dict[str, int] = {}

    def _record(self, launch) -> None:
        bufs = self.chunk.bufs
        for j in range(self.steps):
            self.chunk.step(launch, 1 + j, bufs[j % 2], bufs[(j + 1) % 2])

    def replay(self) -> None:
        counts = self.chunk.counts
        if self.graph is None:
            self._record(self.chunk.eager)
            t = time.perf_counter()
            before = dict(counts)
            try:
                self.graph = self._capture(self.chunk.device, self.chunk.launchers, self._record)
            except (RuntimeError, ValueError, WaferError) as exc:
                raise ChunkGraphError("capture", self.key, exc) from exc
            finally:
                self.launched = {k: counts[k] - before[k] for k in before}
                counts.update(before)
            self._owner.captures += 1
            self._owner.capture_seconds += time.perf_counter() - t
            return
        try:
            self.graph.replay()
        except RuntimeError as exc:
            raise ChunkGraphError("replay", self.key, exc) from exc
        for name, n in self.launched.items():
            counts[name] += n
        self._owner.replays += 1

    def reset(self) -> None:
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


class ChunkGraphs:
    """A solve's bound chunks by key and, on the ``graph`` route, their
    segments. ``capture`` makes a segment's graph (:func:`capture_cuda`; a
    test passes one that records the calls). Counters for the record:
    ``captures``, ``capture_seconds`` (host time, the warm-up segment's
    excluded) and ``replays``, since the last :meth:`take_stats`."""

    def __init__(self, chosen: str, capture: Optional[Callable] = None):
        if chosen not in ("graph", "eager"):
            raise ValueError(f"no bound chunks on the {chosen!r} route")
        self.route = chosen
        self._capture = capture or capture_cuda
        self._chunks: Dict[Hashable, list] = {}  # key -> [chunk, {G: Segment}, chunks run]
        self.captures = self.replays = 0
        self.capture_seconds = 0.0

    def run(self, key: Hashable, make: Callable, phi, n_steps: int):
        """The chunk at ``key`` (made by ``make()`` on its first use) run
        for ``n_steps`` from ``phi`` (:func:`run`), on the graph route its
        middle steps replayed from the key's segment once the key has run
        :data:`EAGER_CHUNKS` chunks."""
        entry = self._chunks.get(key)
        if entry is None:
            entry = self._chunks[key] = [make(), {}, 0]
        chunk, segments, uses = entry
        entry[2] += 1
        segment = None
        steps = 0
        if self.route == "graph" and uses >= EAGER_CHUNKS:
            steps = graph_steps(n_steps, chunk.period)
        if steps:
            segment = segments.get(steps)
            if segment is None:
                segment = segments[steps] = Segment(key, chunk, steps, self._capture, self)
        return run(chunk, phi, n_steps, segment)

    def keys(self):
        return list(self._chunks)

    def release(self, *tensors) -> None:
        """Free the chunks (and their graphs) that hold any of ``tensors``,
        a state's stored states or streamed B, once the state is done."""
        held = {id(t) for t in tensors if t is not None}
        for key in [k for k, (chunk, _s, _n) in self._chunks.items()
                    if any(id(t) in held for t in chunk.tensors)]:
            self._drop(key)

    def close(self) -> None:
        """Free every chunk and graph (the end of the solve)."""
        for key in list(self._chunks):
            self._drop(key)

    def _drop(self, key) -> None:
        _chunk, segments, _n = self._chunks.pop(key)
        for segment in segments.values():
            segment.reset()

    def take_stats(self) -> dict:
        out = {"route": self.route, "captures": self.captures,
               "capture_ms": self.capture_seconds * 1e3, "replays": self.replays}
        self.captures = self.replays = 0
        self.capture_seconds = 0.0
        return out
