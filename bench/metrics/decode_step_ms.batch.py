"""Time inside TieredEngine.step over the window's decoding steps (host clock)."""
from benchkit import readers


def read(view):
    return readers.decode_step_ms(view)
