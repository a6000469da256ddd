"""Least time of the traced slice's paged attention calls over their device time, % (bytes or FLOPs bound; zamba2: 13 calls a step at hd 224)."""
from benchkit import readers


def read(view):
    return readers.paged_roofline(view)
