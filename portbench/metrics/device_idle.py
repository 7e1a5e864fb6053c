"""The share of the traced stretch in which no operation ran on the card,
in %."""

from portbench.trace import busy_seconds


def read(record):
    if record.trace is None or not record.trace.device_ops:
        return None
    return 100.0 * (1.0 - busy_seconds(record.trace) / record.trace.window_s)
