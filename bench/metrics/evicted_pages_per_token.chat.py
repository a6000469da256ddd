"""ServeStats evicted pages over decoded tokens in the window (program counters)."""
from benchkit import readers


def read(view):
    return readers.per_token(view, "evicted_pages")
