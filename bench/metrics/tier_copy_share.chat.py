"""Device time of tiering.copy_pages and tiering.compact_log over device busy, % (traced slice)."""
from benchkit import readers


def read(view):
    return readers.span_share(view, "bench.copy_pages", "bench.compact_log")
