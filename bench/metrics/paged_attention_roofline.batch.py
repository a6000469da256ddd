"""Least time of the traced slice's paged attention calls over their device time, % (bytes or FLOPs bound)."""
from benchkit import readers


def read(view):
    return readers.paged_roofline(view)
