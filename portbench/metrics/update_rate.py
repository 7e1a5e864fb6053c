"""Grid-point updates a second: N³ × every step of every chunk that
finished in the window, over the window's host seconds, in Gpts/s (a
complex pair's step counts once)."""


def read(record):
    return record.points * record.chunk_steps / record.window_s / 1e9
