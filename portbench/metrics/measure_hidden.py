"""The share of the traced stretch's ``wafer.measure`` spans, in %, that
end while the chunk before them still runs on the card: inside a run of
the chunk's kernels (``sweep_step*``, ``finish_coef*``) that follow one
another with no other operation between them, the launch gaps between
two of them included. Such a measure was enqueued in full on the stream
behind the chunk before the chunk ended; one whose host read waits
inside the span ends after its own operations, outside every run."""

import bisect

from portbench.trace import short_name

CHUNK_KERNELS = ("sweep_step", "finish_coef")


def chunk_runs(trace):
    """[start, end] of each run of consecutive chunk kernels, in the
    device's order."""
    runs = []
    after_chunk = False
    for name, start, dur, _state in trace.device_ops:
        chunk = short_name(name).startswith(CHUNK_KERNELS)
        if chunk and after_chunk:
            runs[-1][1] = max(runs[-1][1], start + dur)
        elif chunk:
            runs.append([start, start + dur])
        after_chunk = chunk
    return runs


def read(record):
    trace = record.trace
    if trace is None or not trace.device_ops:
        return None
    ends = [start + dur for name, start, dur in trace.spans if name == "wafer.measure"]
    if not ends:
        return None
    runs = chunk_runs(trace)
    starts = [start for start, _end in runs]
    hidden = 0
    for end in ends:
        i = bisect.bisect_right(starts, end) - 1
        hidden += i >= 0 and end <= runs[i][1]
    return 100.0 * hidden / len(ends)
