"""Steps a job, summed over its states (``SolveResult.steps``), over the
jobs that finished in the window."""


def read(record):
    if not record.solves:
        return None
    return sum(s.steps for s in record.solves) / len(record.solves)
