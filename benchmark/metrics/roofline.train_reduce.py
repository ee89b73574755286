"""``posendf_train_reduce``: its least time over its mean device time, in %.

A launch of it is two kernels: ``train_reduce_kernel`` (the weight-gradient
products) and ``train_reduce_sum_kernel`` (the encoder slots and loss sums).
"""

from benchmark import costs, readers

KERNELS = ("train_reduce_kernel", "train_reduce_sum_kernel")


def read(w):
    n, m = int(w.traffic["noisy"]), int(w.traffic["manifold"])
    least = costs.least_seconds(costs.train_reduce_flops(w.spec, n, m),
                                costs.train_reduce_bytes(w.spec, n, m))
    return readers.roofline(w, lambda k: any(x in k for x in KERNELS),
                            lambda k: KERNELS[0] in k, least)
