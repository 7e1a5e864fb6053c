"""The share of the finished jobs' wall time spent outside their evolve
chunks' CUDA-event time (``SolveResult.chunk_seconds``): the host between
chunks, the measure, initial conditions, potentials and graph capture, in
%."""


def read(record):
    wall = sum(s.seconds for s in record.solves)
    if not wall:
        return None
    return 100.0 * (1.0 - sum(s.chunk_seconds for s in record.solves) / wall)
