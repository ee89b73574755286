"""Host milliseconds to enqueue one train step (the weights' pack, the two train kernels, Adam)."""

from benchmark import readers


def read(w):
    return readers.dispatch_ms(w)
