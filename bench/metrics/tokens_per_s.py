"""Output tokens emitted in the window, first tokens included, over the window's seconds (host clock)."""
from benchkit import readers


def read(view):
    return readers.tokens_per_s(view)
