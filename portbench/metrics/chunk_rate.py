"""Grid-point updates a second of the evolve chunks alone: N³ × the
finished jobs' steps over their chunks' CUDA-event seconds, in Gpts/s."""


def read(record):
    chunk_s = sum(s.chunk_seconds for s in record.solves)
    if not chunk_s:
        return None
    return record.points * sum(s.steps for s in record.solves) / chunk_s / 1e9
