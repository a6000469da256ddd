"""Least time of the traced slice's prefill flash attention calls over their device time, % (bytes or FLOPs bound)."""
from benchkit import readers


def read(view):
    return readers.flash_roofline(view)
