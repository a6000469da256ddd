"""Mean wait from a request's due time to the start of its add_request (host clock)."""
from benchkit import readers


def read(view):
    return readers.admit_wait_ms(view)
