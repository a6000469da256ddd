"""Mean wall time of add_request: the batch-1 prefill and its first token (host clock)."""
from benchkit import readers


def read(view):
    return readers.prefill_ms(view)
