"""Mean device microseconds of a K2 ``finish_coef`` launch in the traced
stretch."""


def read(record):
    if record.trace is None:
        return None
    times = [dur for name, _s, dur, _state in record.trace.device_ops if "finish_coef" in name]
    return 1e6 * sum(times) / len(times) if times else None
