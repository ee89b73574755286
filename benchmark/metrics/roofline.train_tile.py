"""``posendf_train_tile`` (``train_tile_kernel``): its least time over its mean device time, in %."""

from benchmark import costs, readers

KERNEL = "train_tile_kernel<"


def read(w):
    n, m = int(w.traffic["noisy"]), int(w.traffic["manifold"])
    least = costs.least_seconds(costs.train_tile_flops(w.spec, n, m),
                                costs.train_tile_bytes(w.spec, n, m))
    return readers.roofline(w, lambda k: KERNEL in k, lambda k: KERNEL in k, least)
