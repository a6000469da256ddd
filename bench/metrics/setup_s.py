"""Set-up: process start to the window's start, the traffic ramp included (host clock)."""
from benchkit import readers


def read(view):
    return readers.setup_s(view)
