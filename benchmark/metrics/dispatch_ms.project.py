"""Host milliseconds to enqueue one 200-step projection (``project(..., fused=True)``)."""

from benchmark import readers


def read(w):
    return readers.dispatch_ms(w)
