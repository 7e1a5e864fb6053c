"""Mean host milliseconds of a ``wafer.measure`` span (the observables, the
normalisation and projection, and the host read, once a chunk) in the
traced stretch."""


def read(record):
    if record.trace is None:
        return None
    spans = [dur for name, _start, dur in record.trace.spans if name == "wafer.measure"]
    return 1e3 * sum(spans) / len(spans) if spans else None
