"""Host wall seconds of one whole ``solver.run`` (every state of the cell
converged), over the jobs that finished in the window."""


def read(record):
    if not record.solves:
        return None
    return sum(s.seconds for s in record.solves) / len(record.solves)
