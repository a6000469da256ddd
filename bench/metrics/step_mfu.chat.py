"""Model FLOPs of the window's decoding steps over their wall time x 989 TFLOP/s, % (host clock)."""
from benchkit import readers


def read(view):
    return readers.step_mfu(view)
