"""Host milliseconds of CUDA-graph capture a job
(``SolveResult.graphs["capture_ms"]`` summed over its states), over the
jobs that finished in the window."""


def read(record):
    if not record.solves:
        return None
    return sum(s.capture_ms for s in record.solves) / len(record.solves)
