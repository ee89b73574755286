"""``posendf_forward``: its least time (``costs``) over its mean device time, in %.

The three field entry points launch one kernel symbol, ``field_kernel<Act, Bf16>``;
the scoring cells launch it only in the forward mode.
"""

from benchmark import costs, readers

KERNEL = "field_kernel<"


def read(w):
    poses = int(w.traffic["batch"])
    least = costs.least_seconds(costs.forward_flops(w.spec, poses),
                                costs.forward_bytes(w.spec, poses))
    return readers.roofline(w, lambda n: KERNEL in n, lambda n: KERNEL in n, least)
