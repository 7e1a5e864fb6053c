"""The ``--trace 1`` run's profiler session, read in memory.

``torch.profiler`` with CPU and CUDA activity over a bounded stretch of
the window; no trace file is written. The events become a
:class:`~portbench.record.Trace`: every device operation (kernel, copy,
set) with the state it ran in, and the host's ``wafer.*`` and
``portbench.*`` spans.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict

from portbench.record import Trace

STATE_SPAN = "portbench.state."
_SPANS = ("wafer.", "portbench.")


class Session:
    """One profiled stretch: :meth:`start`, then :meth:`stop` → Trace."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        self._device = device
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._t0 = None

    def start(self) -> None:
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> Trace:
        if self._device.type == "cuda":
            import torch

            torch.cuda.synchronize(self._device)
        window_s = time.perf_counter() - self._t0
        self._prof.stop()
        events = []
        for e in self._prof.profiler.kineto_results.events():
            kind = _kind(e)
            if kind is not None:
                events.append((kind, e.name(), e.start_ns(), e.duration_ns()))
        return reduce(events, window_s)


def _kind(e):
    """``device`` for a kernel, copy or set on the card (not the device-side
    shadow of a host span, which carries the span's name), ``span`` for one
    of the host's spans."""
    if e.device_type().name == "CUDA":
        return None if e.name().startswith(_SPANS) else "device"
    return "span" if e.name().startswith(_SPANS) else None


def reduce(events, window_s: float) -> Trace:
    """A Trace from (kind, name, start ns, duration ns) events, kind
    ``device`` or ``span``, on one clock."""
    if not events:
        return Trace(window_s=window_s)
    t0 = min(start for _k, _n, start, _d in events)
    spans = sorted(((name, (start - t0) * 1e-9, dur * 1e-9)
                    for kind, name, start, dur in events if kind == "span"), key=lambda s: s[1])
    states = [(start, start + dur, int(name[len(STATE_SPAN):]))
              for name, start, dur in spans if name.startswith(STATE_SPAN)]
    starts = [s[0] for s in states]
    ops = []
    for kind, name, start, dur in events:
        if kind != "device":
            continue
        t = (start - t0) * 1e-9
        i = bisect.bisect_right(starts, t) - 1
        state = states[i][2] if i >= 0 and t <= states[i][1] else -1
        ops.append((name, t, dur * 1e-9, state))
    ops.sort(key=lambda o: o[1])
    return Trace(window_s=window_s, device_ops=ops, spans=spans)


def busy_intervals(trace: Trace):
    """The union of the device operations' intervals, in order."""
    merged = []
    for _name, start, dur, _state in trace.device_ops:
        end = start + dur
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def busy_seconds(trace: Trace) -> float:
    return sum(end - start for start, end in busy_intervals(trace))


def short_name(name: str) -> str:
    """A device operation's name without its argument list and namespaces;
    the port's kernels keep their template arguments (their stored-state
    count), library kernels lose them."""
    name = re.sub(r"^void\s+", "", name)
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\([^()]*\)$", "", name).strip()
    if not name.startswith(("sweep_step", "finish_coef")):
        name = name.split("<", 1)[0]
    return name[:160]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    gaps summed by the innermost host span they fell in (``host`` outside
    every span), each the ``top`` largest, in seconds."""
    per_op = defaultdict(float)
    for name, _start, dur, _state in trace.device_ops:
        per_op[short_name(name)] += dur
    per_gap = defaultdict(float)
    merged = busy_intervals(trace)
    where = _SpanIndex(trace.spans)
    for (_s0, e0), (s1, _e1) in zip(merged, merged[1:]):
        per_gap[where.innermost((e0 + s1) / 2.0)] += s1 - e0
    return {"device_ops": _largest(per_op, top), "idle_gaps": _largest(per_gap, top)}


def _largest(totals: dict, top: int):
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


class _SpanIndex:
    """The innermost host span at a time: spans nest, so it is the latest
    started one that is still open, found through each span's parent."""

    def __init__(self, spans):
        self.spans = spans  # sorted by start
        self.starts = [start for _n, start, _d in spans]
        self.parent = []
        open_ = []
        for i, (_name, start, dur) in enumerate(spans):
            while open_ and spans[open_[-1]][1] + spans[open_[-1]][2] < start:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def innermost(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and t > self.spans[i][1] + self.spans[i][2]:
            i = self.parent[i]
        if i < 0:
            return "host"
        name = self.spans[i][0]
        return "portbench.state" if name.startswith(STATE_SPAN) else name
