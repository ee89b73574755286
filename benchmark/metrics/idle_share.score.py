"""Share of the traced window with no operation on the card, in %."""

from benchmark import readers


def read(w):
    return readers.idle_share(w)
