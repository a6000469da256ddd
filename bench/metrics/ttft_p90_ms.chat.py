"""90th percentile of time to first token over every request due in the window (host clock): chat-pressure's tail, per layer where the cell is judged by tokens/s."""
from benchkit import readers


def read(view):
    return readers.ttft_ms(view, 90)
