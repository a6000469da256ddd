"""Device time under models/dense.py's moe_ffn over device busy, % (traced slice)."""
from benchkit import readers


def read(view):
    return readers.span_share(view, "bench.moe")
