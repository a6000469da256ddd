"""1 minus the union of device-op intervals over the traced slice's wall time, %."""
from benchkit import readers


def read(view):
    return readers.idle_share(view)
