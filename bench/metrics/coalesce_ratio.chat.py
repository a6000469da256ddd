"""Flushed tokens per flushed page in the window: the write log's coalescing (program counters)."""
from benchkit import readers


def read(view):
    return readers.coalesce_ratio(view)
