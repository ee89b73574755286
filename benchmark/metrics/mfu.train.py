"""The model's operations of the completed units over window x the TF32 peak, in %."""

from benchmark import readers


def read(w):
    return readers.mfu(w)
